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
        "lz4_tpu_torch.kernels.hc_kernel",
        "lz4_tpu_torch.kernels.pack_kernel",
        "lz4_tpu_torch.kernels.xxh32_kernel",
        "lz4_tpu_torch.kernels.xxh64_kernel", "lz4_tpu_torch.block",
        "lz4_tpu_torch.io", "lz4_tpu_torch.cli",
        "lz4_tpu_torch.sg", "lz4_tpu_torch.parallel.mesh",
        "lz4_tpu_torch.parallel.multihost", "lz4_tpu_torch.stream",
        "lz4_tpu_torch.frame", "lz4_tpu_torch.hc",
        "lz4_tpu_torch.utils.datagen",
        "lz4_tpu_torch.utils.datagencli"} <= set(names), names

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

# destSize: a bounded encode behind a prefix (kernel H's plain version), its
# block decoded in two resumed pieces with dictionary rows (kernel D's
# resumable mode), and the batched checksums of the rows (kernels J and K)
import numpy as np
from lz4_tpu_torch.device import byte_rows
from lz4_tpu_torch.kernels.decode_kernel import decode_blocks_dest_size
from lz4_tpu_torch.kernels.destsize_kernel import encode_blocks_dest_size
from lz4_tpu_torch.kernels.xxh32_kernel import xxh32_batch
from lz4_tpu_torch.kernels.xxh64_kernel import xxh64_batch
from lz4_tpu_torch.ops.xxhash import xxh32
import random
rng = random.Random(5)
text = b" ".join(rng.choice([b"alpha", b"beta", b"gamma", b"delta", b"lz4"])
                 + bytes([rng.randrange(256)]) * (k % 4 == 0)
                 for k in range(2600))
prefix, src = text[:3000], text[3000:13000]
rows, _ = byte_rows([prefix + src], 13056, "cpu")
i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
out, olen, consumed = encode_blocks_dest_size(
    rows, i32(len(src)), i32(600), window_lens=i32(len(prefix)))
n, used = int(olen[0]), int(consumed[0])
assert 0 < n <= 600 and 0 < used < len(src)
history, comp, got = prefix, out[0, :n].numpy().tobytes(), b""
while comp:
    window = history[-65536:]
    d_rows, d_lens = byte_rows([window], len(window), "cpu")
    c_rows, c_lens = byte_rows([comp], len(comp), "cpu")
    piece, plen, cons = decode_blocks_dest_size(
        c_rows, c_lens, i32(500), 500, dict_rows=d_rows, dict_lens=d_lens)
    assert int(plen[0]) > 0 and int(cons[0]) > 0
    got += piece[0, :int(plen[0])].numpy().tobytes()
    history, comp = prefix + got, comp[int(cons[0]):]
assert got == src[:used] and used > 500
assert int(xxh32_batch(rows, i32(13000), 7)[0]) == xxh32(prefix + src, 7)
abc, abc_len = byte_rows([b"abc"], 8, "cpu")
assert xxh64_batch(abc, abc_len)[0] == np.uint64(0x44BC2CF5AD770999)

# files through the compress and decode halves of the file layer, at a fast
# level and at HC level 9 (kernel I's plain version), and the CLI's version
import contextlib, os, tempfile
from lz4_tpu_torch import cli
with tempfile.TemporaryDirectory() as d:
    src = os.path.join(d, "f")
    with open(src, "wb") as fh:
        fh.write(big)
    for level in (1, 9):
        dst, back = src + f".{level}.lz4", src + f".{level}"
        r, w = tio.compress_filename(src, dst, tio.IoPrefs(level=level),
                                     device="cpu")
        assert r == len(big) and w == os.path.getsize(dst) < len(big)
        assert tio.decompress_filename(dst, back, tio.IoPrefs(),
                                       device="cpu") == (w, r)
        with open(back, "rb") as fh:
            assert fh.read() == big
version = io.StringIO()
with contextlib.redirect_stdout(version):
    assert cli.main(["lz4tt", "--version"]) == 0
assert version.getvalue().startswith("lz4_tpu_torch v")

# the mesh and the process group: a frame over a two-entry CPU mesh, and a
# world of one gloo process compressing through the length all-gather
import torch.distributed as dist
from lz4_tpu_torch.frame import encode_frame_header
from lz4_tpu_torch.parallel import mesh as tmesh, multihost as mh
frame = tmesh.compress_frame_mesh(tmesh.default_mesh(2, device="cpu"), data)
assert frame == tmesh.compress_frame_mesh(tmesh.default_mesh(device="cpu"),
                                          data)
assert decompress_frame_device(frame, device="cpu") == (data, len(frame))
with tempfile.TemporaryDirectory() as d:
    dev = mh.initialize(f"file://{d}/store", 1, 0, device="cpu")
    rows, lens = byte_rows([data[:4096], data[4096:8192]], 4096, dev)
    comp, all_len = mh.encode_blocks_multihost(mh.global_mesh(), rows, lens)
    seg = mh.frame_segment(comp, all_len, [4096, 4096], 0, 2)
    dist.destroy_process_group()
prefs = FramePreferences(block_size_id=4, block_independent=True)
frame = encode_frame_header(prefs) + seg + bytes(4)
assert decompress_frame_device(frame, device="cpu") == (data[:8192],
                                                        len(frame))

# the library API: a one-shot round trip, a stream session, and a frame fed
# to FrameDecompressor in slices
from lz4_tpu_torch import block as tblock, frame as tframe, stream as tstream
from lz4_tpu_torch.utils.datagen import gen_buffer
gen = gen_buffer(150_000, 0.7, 3)
comp = tblock.compress_fast(gen, device="cpu")
assert tblock.decompress_safe(comp, len(gen), device="cpu") == gen
assert tblock.decompress_safe_partial(comp, 999, device="cpu") == gen[:999]
enc = tstream.BlockCompressStream(device="cpu")
dec = tstream.BlockDecompressStream(device="cpu")
for i in range(0, len(gen), 40_000):
    blk = enc.compress_continue(gen[i:i + 40_000])
    assert dec.decompress_continue(blk, 40_000) == gen[i:i + 40_000]
frame = tframe.compress_frame(gen, FramePreferences(
    block_size_id=4, content_checksum=True), device="cpu")
d, pos, got = tframe.FrameDecompressor(device="cpu"), 0, b""
while not d.finished:
    used, out = d.feed(frame[pos:pos + 7_001])
    pos, got = pos + used, got + out
assert (got, pos) == (gen, len(frame))

# the HC API: a stream session at level 3, decoded by the port's stream
# decoder, and a destSize block
from lz4_tpu_torch import hc as thc
hstream = thc.HcCompressStream(3, device="cpu")
hdec = tstream.BlockDecompressStream(device="cpu")
for i in range(0, 30_000, 10_000):
    blk = hstream.compress_continue(gen[i:i + 10_000])
    assert hdec.decompress_continue(blk, 10_000) == gen[i:i + 10_000]
took, blk = thc.compress_hc_dest_size(gen[:8_000], 2_000, 3, device="cpu")
assert len(blk) <= 2_000 and tblock.decompress_safe(
    blk, took, device="cpu") == gen[:took]

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
    env["OMP_NUM_THREADS"] = "1"   # small tensor ops: no pool to contend
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


TOOLING = r"""
import contextlib, importlib.util, io, sys
sys.modules["jax"] = None             # any "import jax" now raises
from pathlib import Path
import torch

# kernel A's adaptive mode and its statistic
from lz4_tpu_torch.kernels import decode_kernel as dec, encode_kernel as enc
from lz4_tpu_torch.utils.datagen import gen_buffer
data = gen_buffer(3 * 65536 - 999, 0.8, 123)
stream = torch.zeros((1, 4 * 65536), dtype=torch.uint8)
stream[0, 65536:65536 + len(data)] = torch.frombuffer(bytearray(data),
                                                     dtype=torch.uint8)
lens = torch.tensor([[65536, 65536, 65536 - 999]], dtype=torch.int32)
out, olen = enc.encode_blocks_linked(
    stream, lens, mm_rows=torch.tensor([[4, 12, 8]], dtype=torch.int32))
got, glen = dec.decode_blocks_linked(out[0], olen[0], 65536)
assert b"".join(got[k, :n].numpy().tobytes()
                for k, n in enumerate(glen.tolist())) == data
frac = enc.cand_frac8_rows(stream[0, 65536:].reshape(3, 65536))
assert frac.shape == (3,) and bool(((frac > 0) & (frac < 1)).all())

def load(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    assert load("fullbench_torch.py").main(["--device", "cpu", "--kb",
                                            "64"]) == 0
    for name in ("tpu_batch", "mesh_frame", "scatter_gather",
                 "print_version"):
        assert load(f"examples/torch_port/{name}_torch.py").main(
            ["--device", "cpu"]) == 0
text = printed.getvalue()
assert "device.compress_frame_device " in text and "round-trip" in text, text

assert sys.modules["jax"] is None
bad = [m for m in sys.modules
       if m.startswith("jax.") or m == "lz4_tpu" or m.startswith("lz4_tpu.")]
assert not bad, bad
print("ok")
"""


def test_tooling_and_adaptive_mode_run_without_jax():
    """``fullbench_torch.py``, the twins of ``tpu_batch.py``,
    ``mesh_frame.py``, ``scatter_gather.py`` and ``print_version.py``, and
    kernel A's adaptive mode import and run with ``import jax`` failing."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", TOOLING], cwd=str(REPO),
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
    assert sorted(p.name for p in build.CSRC.glob("*.cu*")) == [
        "decode.cu", "decode.cuh", "destsize.cu", "destsize.cuh", "emit.cuh",
        "encode.cu", "hc.cu", "pack.cu", "sg_chain.cu", "sg_decode.cu",
        "stream.cu", "xxh.cu"]
    # the headers count as inputs (an edited header rebuilds the library)
    # and only the sources are compiled
    inputs, cmds = seen[1][1], seen[1][2]
    assert {Path(p).name for p in inputs} >= {"destsize.cuh", "destsize.cu",
                                              "xxh.cu"}
    compiled = [Path(a).name for cmd in cmds[:-1] for a in cmd
                if a.endswith(".cu")]
    assert sorted(compiled) == sorted(p.name for p in build.CSRC.glob("*.cu"))
