"""The port stands alone: lz4_tpu_torch imports neither jax nor lz4_tpu.

Runs in a fresh interpreter with ``import jax`` made to fail and
JAX_PLATFORMS unset, as on a host where only PyTorch is installed.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None             # any "import jax" now raises
import lz4_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    lz4_tpu_torch.__path__, "lz4_tpu_torch."))
for name in names:
    importlib.import_module(name)
assert {"lz4_tpu_torch.device", "lz4_tpu_torch.kernels.encode_kernel",
        "lz4_tpu_torch.kernels.decode_kernel",
        "lz4_tpu_torch.kernels.destsize_kernel",
        "lz4_tpu_torch.kernels.pack_kernel",
        "lz4_tpu_torch.sg"} <= set(names), names

import torch
from lz4_tpu_torch.device import compress_frame_device, decompress_frame_device
from lz4_tpu_torch.frame import FramePreferences

data = bytes(range(256)) * 700 + b"tail" * 3000
for prefs in (FramePreferences(block_size_id=4),
              FramePreferences(block_size_id=4, block_independent=True,
                               content_checksum=True)):
    frame = compress_frame_device(data, prefs, device="cpu")
    assert decompress_frame_device(frame, device="cpu") == (data, len(frame))

# a 256 KB-block frame and a legacy file of its payloads, through the
# file-level decoder (the stream kernel's plain version)
import io, struct
import chip_smoke
from lz4_tpu_torch import io as tio, spec
big = data * 2
frame = compress_frame_device(
    big, FramePreferences(block_size_id=5, block_independent=True),
    block_size=262144, device="cpu")
recs = chip_smoke.frame_payloads(frame, 7)
assert len(recs) == 2 and not any(st for _, st in recs)
legacy = (struct.pack("<I", spec.LEGACY_MAGIC)
          + chip_smoke.block_records([p for p, _ in recs]))
out = io.BytesIO()
assert tio.decompress_stream(io.BytesIO(frame + legacy), out, tio.IoPrefs(),
                             device="cpu") == (len(frame) + len(legacy),
                                               2 * len(big))
assert out.getvalue() == big + big

# scatter-gather round trips through the chain kernels' plain versions: 4 KB
# iovecs, and blocks over 64 KB (the stream decoder's route)
from lz4_tpu_torch import sg
for ins, caps in (([data[i:i + 4096] for i in range(0, 65536, 4096)],
                   [4096] * 17),
                  ([big[:300_000], big[300_000:]], [len(big) + 4096])):
    total, consumed, outs = sg.sg_compress(ins, caps, device="cpu")
    assert total > 0 and consumed == sum(map(len, ins))
    comp, rem = [], total
    for b, c in zip(outs, caps):
        if rem > 0:
            comp.append(b[:min(c, rem)])
            rem -= min(c, rem)
    assert sg.sg_decompress(comp, [len(b) for b in ins], device="cpu") == \
        (consumed, ins)

assert sys.modules["jax"] is None
bad = [m for m in sys.modules
       if m.startswith("jax.") or m == "lz4_tpu" or m.startswith("lz4_tpu.")]
assert not bad, bad

if not torch.cuda.is_available():
    try:
        compress_frame_device(data)    # default device="cuda"
    except RuntimeError as exc:
        assert "cuda" in str(exc).lower()
    else:
        raise AssertionError("default device='cuda' ran without a card")
print("ok")
"""


def test_port_imports_no_jax_and_round_trips_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_builds_nothing_outside_its_tree(monkeypatch):
    """Every source the port compiles lies in lz4_tpu_torch/, and every
    file it writes in build/: the kernel library and the host XXH32."""
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.ops import xxhash

    pkg, out_dir = REPO / "lz4_tpu_torch", REPO / "build"
    seen = []

    def record(stem, inputs, flags, commands):
        out = build.BUILD_DIR / f"{stem}.so"
        seen.append((stem, list(inputs), commands(out)))
        raise build.BuildError("recorded, not built")

    monkeypatch.setattr(build, "build_shared", record)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(xxhash.shutil, "which", lambda name: name)
    monkeypatch.setattr(build, "_kernels", None)
    monkeypatch.setattr(xxhash, "_native_tried", False)
    assert xxhash._load_native() is None
    with pytest.raises(build.BuildError):
        build.kernels_lib()
    assert [stem for stem, _, _ in seen] == ["lz4tt_xxh32", "lz4tt_kernels"]
    for stem, inputs, cmds in seen:
        assert inputs and all(Path(p).resolve().is_relative_to(pkg)
                              for p in inputs), (stem, inputs)
        paths = [Path(a) for cmd in cmds for a in cmd[1:]
                 if a.endswith((".c", ".cu", ".o", ".so"))]
        assert paths
        for p in paths:
            assert p.resolve().is_relative_to(pkg) or \
                p.resolve().is_relative_to(out_dir), (stem, p)
    assert build.BUILD_DIR.resolve().is_relative_to(out_dir)
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "decode.cu", "encode.cu", "pack.cu", "sg_chain.cu", "sg_decode.cu",
        "stream.cu"]
