"""lz4_tpu_torch.parallel.multihost in two processes on gloo, held against
lz4_tpu: the twin of tests/test_multihost.py.

Two workers (tests/torch_multihost_worker.py, which import torch and
lz4_tpu_torch only) meet through a ``file://`` store under the test's
temporary directory, each compresses its 8 of 16 blocks of 4 KB with the
lengths all-gathered, and decodes them again.  The gathered lengths must be
lz4_tpu's ``encode_blocks`` lengths on the same rows, the segments spliced
behind one header must be a frame both packages decode, and the decoded
segments must join into the input.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from lz4_tpu.frame import decompress_frame
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows, encode_blocks
from lz4_tpu.utils.datagen import gen_buffer
from lz4_tpu_torch.device import decompress_frame_device
from lz4_tpu_torch.frame import FramePreferences, encode_frame_header
from lz4_tpu_torch.ops.xxhash import xxh32

REPO = Path(__file__).resolve().parent.parent
BS = 4096
WORLD = 2


def _run_workers(tmp_path, world):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_multihost_worker.py"),
         str(rank), str(world), str(store), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
    finally:
        for p in procs:            # a hang fails the test, not the suite
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def test_two_process_gloo_compress_and_decode(tmp_path):
    data = gen_buffer(BS * 16, 0.7, 1234)
    (tmp_path / "plain.bin").write_bytes(data)
    _run_workers(tmp_path, WORLD)

    lens = [np.load(tmp_path / f"lens{r}.npy") for r in range(WORLD)]
    # the all-gather gave every process the same full length vector, and
    # it is lz4_tpu's on the same rows
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    packed, blens = np_pack_rows(blocks, BS)
    _, j_len = encode_blocks(bytes_to_val32_rows(jnp.asarray(packed), BS),
                             jnp.asarray(blens))
    for ln in lens:
        assert ln.tolist() == np.asarray(j_len).tolist()

    prefs = FramePreferences(block_size_id=4, block_independent=True,
                             content_checksum=True)
    frame = (encode_frame_header(prefs)
             + b"".join((tmp_path / f"seg{r}.bin").read_bytes()
                        for r in range(WORLD))
             + struct.pack("<I", 0) + struct.pack("<I", xxh32(data, 0)))
    assert decompress_frame(frame) == (data, len(frame))
    assert decompress_frame_device(frame, device="cpu") == (data, len(frame))
    dec = b"".join((tmp_path / f"dec{r}.bin").read_bytes()
                   for r in range(WORLD))
    assert dec == data
    for r in range(WORLD):
        counts = json.loads((tmp_path / f"counts{r}.json").read_text())
        assert counts == {"plain": {"encode": 1, "decode_batch": 1},
                          "launches": {}}


def test_initialize_refuses_a_backend_against_its_device():
    from lz4_tpu_torch.parallel import multihost as mh
    with pytest.raises(ValueError):
        mh.initialize("file:///nonexistent", 1, 0, backend="nccl",
                      device="cpu")
    with pytest.raises(RuntimeError):
        mh.initialize("file:///nonexistent", 1, 0)   # no card here
