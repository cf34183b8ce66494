"""``fullbench_torch.py``, the port's per-entry-point MB/s table: on the CPU
(``--device cpu``, the kernels' plain versions) at a small corpus it checks
every round trip and prints every cell; without ``--device`` on a host
without a card it exits non-zero naming cuda.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CELLS = [
    # the library API (the twin of fullbench.py's host section)
    "block.compress_default", "block.decompress_safe",
    "hc.compress_hc_block level 9 (64KB)", "frame.compress_frame (64KB)",
    "frame.decompress_frame (64KB)", "stream.compress_continue (16KB chain)",
    "sg.sg_compress (16x4KB)", "sg.sg_decompress (16x4KB)",
    "ops.xxhash.xxh32",
    # the kernels
    "kernels.encode_blocks", "kernels.decode_blocks", "kernels.xxh32_batch",
    "kernels.xxh64_batch", "kernels.decode_blocks_linked",
    "kernels.decode_blocks_sg", "kernels.encode_dest_size (cap=n/2)",
    "kernels.decode_dest_size (cap=n/2, resumable)",
    "sg.sg_compress(device='cpu')", "kernels.encode_blocks_hc (HC9)",
    "kernels.decode_stream (256KB blocks)",
    # the frame pipeline
    "device.compress_frame_device", "device.decompress_frame_device",
    "device.compress_frame_device_hc (HC9)",
]


def run(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(REPO / "fullbench_torch.py"),
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_fullbench_torch_runs_every_cell_on_the_cpu():
    """96 KB: one full 64 KB block and a partial one, so the ragged rows,
    the 256 KB row of the stream cell and both HC blocks are driven."""
    res = run("--device", "cpu", "--kb", "96")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.endswith(" MB/s")]
    names = [ln.rsplit(None, 2)[0] for ln in lines]
    assert names == CELLS, names
    for ln in lines:     # one decimal: the CPU's HC cells may read 0.0
        assert float(ln.rsplit(None, 2)[1]) >= 0, ln


def test_fullbench_torch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    res = run("--kb", "64")
    assert res.returncode != 0 and "cuda" in res.stderr
    assert " MB/s" not in res.stdout
