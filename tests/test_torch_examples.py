"""The example twins in ``examples/torch_port/``: each runs on the CPU with
``--device cpu`` (the kernels' plain versions), prints its result, and
without ``--device`` on a host without a card exits non-zero naming cuda.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TWINS = {
    "simple_buffer_torch.py": "round-trip OK",
    "compress_functions_torch.py": "decompress_safe round-trips",
    "block_streaming_double_buffer_torch.py": "round-trip OK",
    "block_streaming_line_by_line_torch.py": "window carry wins",
    "block_streaming_ring_buffer_torch.py": "round-trip OK",
    "frame_compress_torch.py": "round-trip OK",
    "chunked_file_io_torch.py": "round-trip OK",
    "hc_streaming_torch.py": "round-trip OK",
    "tpu_batch_torch.py": "all round-tripped (mismatches 0)",
    "mesh_frame_torch.py": "the frame decoder verified the bytes",
    "scatter_gather_torch.py": "plain-LZ4F decode OK",
    "print_version_torch.py": "library version 0.1.0",
}


def run(script: str, *args):
    # one intra-op thread: the plain versions' small tensor ops would
    # otherwise oversubscribe the cores shared with other test workers
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_port" / script),
         *args], env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", sorted(TWINS))
def test_example_twin_runs_on_the_cpu(script):
    res = run(script, "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    assert TWINS[script] in res.stdout
    if not torch.cuda.is_available():
        res = run(script)
        assert res.returncode != 0 and "cuda" in res.stderr
