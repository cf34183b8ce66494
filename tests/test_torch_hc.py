"""The port's HC encoder (kernel I's plain version), its frame route, the
compress half of lz4_tpu_torch.io and lz4_tpu_torch.cli, held against
lz4_tpu.

Both packages get the same bytes (datagen and numpy seeds); lz4_tpu's HC
kernel runs in interpret mode.  Codec outputs are integers: every
comparison is exact (chain tables lane for lane, ``out[:olen]`` and
``olen``, whole frames and files byte for byte).
"""

import collections
import functools
import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu import io as jio
from lz4_tpu import tpu as jtpu
from lz4_tpu.frame import FramePreferences as JaxPrefs
from lz4_tpu.frame import Lz4FrameError as JaxFrameError
from lz4_tpu.kernels import hc_kernel as jhc
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import device as tdev
from lz4_tpu_torch import io as tio
from lz4_tpu_torch.frame import FramePreferences, Lz4FrameError
from lz4_tpu_torch.kernels import common
from lz4_tpu_torch.kernels import hc_kernel as thc
from lz4_tpu_torch.kernels.common import le32_lanes

from .test_hc_kernel import BLOCKS, NS
from .test_torch_kernels import stdlib_text

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
W = 65536


def _rows(blocks, ns):
    """The same blocks for both packages: (jax val32 rows, numpy lengths,
    torch uint8 rows)."""
    packed, lens = np_pack_rows(blocks, ns)
    val = bytes_to_val32_rows(jnp.asarray(packed), ns)
    rows = torch.zeros((len(blocks), ns), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        if b:
            rows[i, :len(b)] = torch.frombuffer(bytearray(b),
                                                dtype=torch.uint8)
    return val, lens, rows


def _assert_rows_equal(j, t):
    (j_out, j_olen), (t_out, t_olen) = j, t
    j_out, j_olen = np.asarray(j_out), np.asarray(j_olen)
    assert (j_olen == t_olen.numpy()).all(), (j_olen, t_olen)
    for i, n in enumerate(j_olen):
        assert j_out[i, :n].astype(np.uint8).tobytes() == \
            t_out[i, :n].numpy().tobytes(), i


def _mixed(n, seed):
    """Text, zero runs, noise and far repeats from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        kind, size = int(rng.integers(0, 4)), int(rng.integers(1, 3000))
        if kind == 0:
            out += bytes(size)
        elif kind == 1:
            out += rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        elif kind == 2:
            out += gen_buffer(size, 0.7, int(rng.integers(0, 1000)))
        elif out:
            start = int(rng.integers(0, len(out)))
            out += out[start:start + size]
    return bytes(out[:n])


TABLE_CASES = {
    "hc block set": (BLOCKS, NS),
    "64 KB rows": ([gen_buffer(W, 0.8, 3), _mixed(W, 4), _mixed(W - 77, 5),
                    b"abc" * (W // 3)], W),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_cand_delta48_rows_matches_jax(case):
    blocks, ns = TABLE_CASES[case]
    val, _, rows = _rows(blocks, ns)
    tval = le32_lanes(torch.cat([rows, rows[:, :3]], 1))
    assert (tval.numpy() == np.asarray(val)).all()
    want = np.asarray(jhc.cand_delta48_rows(val))
    assert (thc.cand_delta48_rows(tval).numpy() == want).all()
    assert (thc.hc_tables(rows).numpy() == want).all()


@pytest.mark.parametrize("level", [1, 2, 9, 12, 16])
def test_encode_blocks_hc_matches_jax(level):
    val, lens, rows = _rows(BLOCKS, NS)
    j = jhc.encode_blocks_hc(val, jnp.asarray(lens), level)
    t = thc.encode_blocks_hc(rows, torch.from_numpy(lens), level)
    _assert_rows_equal(j, t)


def test_encode_blocks_hc_full_row_matches_jax():
    blocks = [gen_buffer(W, 0.85, 21), _mixed(W, 22)]
    val, lens, rows = _rows(blocks, W)
    j = jhc.encode_blocks_hc(val, jnp.asarray(lens), 3)
    t = thc.encode_blocks_hc(rows, torch.from_numpy(lens), 3)
    _assert_rows_equal(j, t)


def test_encode_blocks_hc_counts_and_checks():
    _, lens, rows = _rows(BLOCKS, NS)
    common.reset_counts()
    out, olen = thc.encode_blocks_hc(rows, torch.from_numpy(lens), 0)
    assert common.PLAIN_CALLS["encode_hc"] == 1
    assert common.LAUNCHES["encode_hc"] == 0
    # level 0 is clamped to 1, as in lz4_tpu
    one = thc.encode_blocks_hc(rows, torch.from_numpy(lens), 1)
    assert torch.equal(olen, one[1])
    assert out.shape == (len(BLOCKS), -(-(NS + NS // 255 + 16) // 128) * 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        thc.encode_blocks_hc(rows[:, :100].contiguous(),
                             torch.from_numpy(lens), 9)
    with pytest.raises(ValueError, match="too large"):
        thc.encode_blocks_hc(torch.zeros((1, 2 * W + 128),
                                         dtype=torch.uint8),
                             torch.zeros((1,), dtype=torch.int32), 9)
    with pytest.raises(TypeError):
        thc.encode_blocks_hc(rows, torch.from_numpy(lens).long(), 9)


def _u16(t):
    return t.numpy().astype(np.int64) & 0xFFFF


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_sorted_tables_hold_the_jax_chains(case):
    """Kernel I's (perm, slot) against lz4_tpu's cand_delta48_rows: every
    link of the 4-byte chain is the next member of p's run before its slot,
    every link of the 8-byte chain the next member of that run whose bytes
    4..7 equal p's; and chains walked from sampled positions equal the runs
    read from perm, whole or filtered."""
    blocks, ns = TABLE_CASES[case]
    val, _, rows = _rows(blocks, ns)
    d48 = np.asarray(jhc.cand_delta48_rows(val)).astype(np.int64)
    d4, d8 = d48 & 0xFFFF, (d48 >> 16) & 0xFFFF
    perm, slot = thc.hc_sorted_tables(rows)
    assert perm.dtype == slot.dtype == torch.int16
    perm, slot = _u16(perm), _u16(slot)
    key = np.asarray(val).astype(np.int64) & 0xFFFFFFFF
    key4 = np.roll(key, -4, axis=1)          # bytes 4..7, wrapping as lz4_tpu
    pos = np.arange(ns)
    rng = np.random.default_rng(7)
    for b in range(len(blocks)):
        k, pb, sb = key[b], perm[b], slot[b]
        assert (pb[sb] == pos).all()
        # equal keys lie together, in position order
        same = k[pb][1:] == k[pb][:-1]
        assert (pb[1:][same] > pb[:-1][same]).all()
        assert len(set(k[pb][np.r_[True, ~same]])) == int((~same).sum()) + 1
        # the 4-byte link: the member of the run just before p's slot
        prev = np.where(sb > 0, pb[np.maximum(sb - 1, 0)], -1)
        linked = (sb > 0) & (k[np.maximum(prev, 0)] == k)
        assert (d4[b] == np.where(linked, pos - prev, 0)).all()
        # the 8-byte link: the newest earlier member with equal bytes 4..7
        last = {}
        for p in range(ns):
            q = last.get((k[p], key4[b, p]), p)
            assert d8[b, p] == p - q
            last[(k[p], key4[b, p])] = p
        # walked chains from sampled positions, at most 300 links
        for p in rng.integers(0, ns, 40):
            run = pb[:sb[p]][::-1]
            run = run[k[run] == k[p]][:300]
            for d, members in ((d4[b], run),
                               (d8[b], run[key4[b, run] == key4[b, p]])):
                walk, q = [], p
                while d[q] and len(walk) < len(members):
                    q -= d[q]
                    walk.append(q)
                assert walk == members[:len(walk)].tolist()
                assert len(walk) == len(members)


NSR = 4096
ROUND_BLOCKS = [bytes(NSR), b"ab" * (NSR // 2), (b"abc" * NSR)[:NSR],
                incompressible(NSR), BLOCKS[-1], b"y" * 12, b"x" * 13,
                gen_buffer(NSR, 0.8, 91), gen_buffer(NSR, 0.95, 92)]
MODEL_SHAPES = [(1, 1), (1, 2), (4, 1), (4, 4), (32, 1), (32, 2), (32, 4)]


@functools.lru_cache(maxsize=None)
def _jax_rows(level, blocks=tuple(ROUND_BLOCKS), ns=NSR):
    val, lens, rows = _rows(list(blocks), ns)
    out, olen = jhc.encode_blocks_hc(val, jnp.asarray(lens), level)
    out, olen = np.asarray(out), np.asarray(olen)
    return rows, [out[i, :olen[i]].astype(np.uint8).tobytes()
                  for i in range(len(blocks))]


def _model_rows(rows, blocks, level, lanes, positions, stats=None):
    """(serial walk, round model) payloads of every row."""
    d48 = thc.hc_tables(rows)
    perm, slot = thc.hc_sorted_tables(rows)
    ma = 1 << (level - 1)
    out = []
    for i, blk in enumerate(blocks):
        buf = rows[i].numpy().tobytes()
        out.append((bytes(thc._hc_row_plain(buf, len(blk), d48[i].numpy(),
                                            ma)),
                    bytes(thc.hc_row_rounds_plain(
                        buf, len(blk), perm[i].numpy(), slot[i].numpy(), ma,
                        lanes, positions, stats))))
    return out


@pytest.mark.parametrize("lanes,positions", MODEL_SHAPES)
def test_round_model_matches_serial_walk_and_jax(lanes, positions):
    """hc_row_rounds_plain in rounds of 1, 4 and 32 lanes and batches of 1,
    2 and 4 positions: zeros, periods 2 and 3, noise, the needle case, rows
    of 12 and 13 bytes and text, levels 1-16."""
    for level in (1, 2, 9, 12, 16):
        rows, want = _jax_rows(level)
        for i, (serial, rounds) in enumerate(_model_rows(
                rows, ROUND_BLOCKS, level, lanes, positions)):
            assert serial == want[i], (level, i)
            assert rounds == want[i], (level, i)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_encode_blocks_hc_takes_rows_at_any_offset(offset):
    """Rows that start at any byte of their storage (kernel I reads them as
    aligned words on the card) parse alike: encode_blocks_hc on such a view
    and hc_scan_serial equal lz4_tpu."""
    rows, want = _jax_rows(9)
    lens = torch.tensor([len(b) for b in ROUND_BLOCKS], dtype=torch.int32)
    store = torch.zeros(rows.numel() + 4, dtype=torch.uint8)
    view = store[offset:offset + rows.numel()].view(rows.shape)
    view.copy_(rows)
    for out, olen in (thc.encode_blocks_hc(view, lens, 9),
                      thc.hc_scan_serial(view, lens, 9)):
        assert [out[i, :olen[i]].numpy().tobytes()
                for i in range(len(want))] == want


@pytest.mark.parametrize("lanes,positions", [(32, 4), (32, 1), (4, 2)])
def test_round_model_on_a_64k_stdlib_row(lanes, positions):
    text = stdlib_text(3 * W)[2 * W:]
    rows, want = _jax_rows(9, (text,), W)
    [(serial, rounds)] = _model_rows(rows, [text], 9, lanes, positions)
    assert serial == rounds == want[0]


@pytest.mark.parametrize("level,counter", [
    (1, "budget_mid_round"), (2, "budget_mid_round"),
    (9, "switch_mid_round"), (12, "switch_mid_round")])
def test_round_model_stops_and_switches_inside_rounds(level, counter):
    """Rows where the budget runs out before a round's last lane (levels 1
    and 2 on the long chains of text and periods) and where the switch to
    the 8-byte chain falls in the middle of a round: the counts show the
    case happened, and the payloads still equal the serial walk's and
    lz4_tpu's."""
    rows, want = _jax_rows(level)
    stats = collections.Counter()
    for i, (serial, rounds) in enumerate(_model_rows(
            rows, ROUND_BLOCKS, level, 32, 4, stats)):
        assert serial == rounds == want[i], i
    assert stats[counter] > 0, stats
    assert stats["path_rounds"] <= stats["rounds"]
    assert stats["batches"] <= stats["searches"]


def test_hc_scan_checks_its_tables():
    _, lens, rows = _rows(BLOCKS, NS)
    perm, slot = thc.hc_sorted_tables(rows)
    lens = torch.from_numpy(lens)
    common.reset_counts()
    out, olen = thc.hc_scan(rows, lens, (perm, slot), 9)
    assert common.PLAIN_CALLS["encode_hc"] == 1
    assert torch.equal(olen, thc.encode_blocks_hc(rows, lens, 9)[1])
    with pytest.raises(TypeError):
        thc.hc_scan(rows, lens, (perm.int(), slot), 9)
    with pytest.raises(ValueError, match="perm and slot"):
        thc.hc_scan(rows, lens, (perm[:, :128].contiguous(),
                                 slot[:, :128].contiguous()), 9)


FRAME_CASES = {
    "empty": (b"", {}),
    "13 bytes": (b"x" * 13, {}),
    "150 KB, checksums and content size": (
        gen_buffer(100_000, 0.8, 31) + incompressible(30_000)
        + bytes(20_000), dict(block_checksum=True, content_checksum=True,
                              content_size=150_000)),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_compress_frame_device_hc_matches_jax(case):
    data, kw = FRAME_CASES[case]
    want = jtpu.compress_frame_device_hc(
        data, JaxPrefs(block_independent=True, **kw), level=9)
    got = tdev.compress_frame_device_hc(
        data, FramePreferences(block_independent=True, **kw), level=9,
        device=CPU)
    assert got == want
    assert tdev.decompress_frame_device(got, device=CPU) == (data, len(got))


def test_compress_frame_device_hc_demotes_linked_like_jax():
    data = gen_buffer(70_000, 0.7, 41)
    with pytest.warns(UserWarning, match="demoted"):
        want = jtpu.compress_frame_device_hc(data, JaxPrefs(), level=4)
    with pytest.warns(UserWarning, match="demoted"):
        got = tdev.compress_frame_device_hc(data, FramePreferences(),
                                            level=4, device=CPU)
    assert got == want
    with pytest.raises(JaxFrameError):
        jtpu.compress_frame_device_hc(
            data, JaxPrefs(block_independent=True, content_size=5))
    with pytest.raises(Lz4FrameError):
        tdev.compress_frame_device_hc(
            data, FramePreferences(block_independent=True, content_size=5),
            device=CPU)


def test_compress_frame_device_hc_groups_rows(monkeypatch):
    """Inputs over HC_GROUP_ROWS blocks launch once per group; the frame
    does not change."""
    data = gen_buffer(3 * W + 5000, 0.8, 43)
    whole = tdev.compress_frame_device_hc(
        data, FramePreferences(block_independent=True), level=3, device=CPU)
    monkeypatch.setattr(tdev, "HC_GROUP_ROWS", 2)
    common.reset_counts()
    assert tdev.compress_frame_device_hc(
        data, FramePreferences(block_independent=True), level=3,
        device=CPU) == whole
    assert common.PLAIN_CALLS["encode_hc"] == 2


STREAM_CASES = {
    "-1": {},
    "-1 -BX": dict(block_checksum=True),
    "-1 -BD": dict(block_linked=True),
    "-9": dict(level=9),
    "-1 --content-size --no-frame-crc -B5": dict(
        content_size=True, content_checksum=False, block_size_id=5),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_compress_stream_matches_jax(case, monkeypatch):
    """lz4_tpu's device route (HC on the device from 0 bytes up) and the
    port on the same bytes, in 128 KB reads; the file decodes through the
    port's io."""
    kw = STREAM_CASES[case]
    data = gen_buffer(200_000, 0.75, 51) + _mixed(100_000, 52)
    monkeypatch.setenv("LZ4TPU_HC_DEVICE_MIN", "0")
    monkeypatch.setattr(jio, "CHUNK", 128 << 10)
    monkeypatch.setattr(tio, "CHUNK", 128 << 10)
    want = io.BytesIO()
    jr = jio.compress_stream(io.BytesIO(data), want,
                             jio.IoPrefs(use_device=True, **kw), len(data))
    got = io.BytesIO()
    tr = tio.compress_stream(io.BytesIO(data), got, tio.IoPrefs(**kw),
                             len(data), device=CPU)
    assert tr == jr == (len(data), len(want.getvalue()))
    assert got.getvalue() == want.getvalue()
    out = io.BytesIO()
    tio.decompress_stream(io.BytesIO(got.getvalue()), out, tio.IoPrefs(),
                          device=CPU)
    assert out.getvalue() == data


def test_compress_filename_and_multiple(tmp_path):
    data = gen_buffer(90_000, 0.8, 61)
    src = tmp_path / "a.bin"
    src.write_bytes(data)
    prefs = tio.IoPrefs(level=9)
    r, w = tio.compress_filename(str(src), str(src) + ".lz4", prefs,
                                 device=CPU)
    assert r == len(data) and w == (tmp_path / "a.bin.lz4").stat().st_size
    with pytest.raises(FileExistsError):
        tio.compress_filename(str(src), str(src) + ".lz4", prefs, device=CPU)
    src.rename(tmp_path / "orig.bin")
    assert tio.decompress_filename(str(tmp_path / "a.bin.lz4"), str(src),
                                   tio.IoPrefs(), device=CPU) == (w, r)
    assert src.read_bytes() == data
    (tmp_path / "b.bin").write_bytes(data[:1000])
    paths = [str(tmp_path / "b.bin"), str(tmp_path / "missing.bin")]
    assert tio.compress_multiple(paths, tio.IoPrefs(), device=CPU) == 1
    assert (tmp_path / "b.bin.lz4").exists()


def _cli(args, cwd, stdin=b"", force_cpu=True, **env_kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "LZ4TPU_FORCE_CPU")}
    env["PYTHONPATH"] = str(REPO)
    if force_cpu:
        env["LZ4TPU_FORCE_CPU"] = "1"
    env.update(env_kw)
    return subprocess.run([sys.executable, "-m", "lz4_tpu_torch.cli", *args],
                          cwd=str(cwd), env=env, input=stdin,
                          capture_output=True, timeout=300)


def test_cli_round_trips_like_jax(tmp_path, monkeypatch):
    """-z/-d at the default level and at -9, the files equal to lz4_tpu's
    device-route files."""
    data = gen_buffer(150_000, 0.8, 71)
    (tmp_path / "f").write_bytes(data)
    monkeypatch.setenv("LZ4TPU_HC_DEVICE_MIN", "0")
    for flags in ([], ["-9"]):
        res = _cli([*flags, "-f", "f"], tmp_path)
        assert res.returncode == 0, res.stderr
        want = io.BytesIO()
        jio.compress_stream(io.BytesIO(data), want, jio.IoPrefs(
            level=9 if flags else 1, use_device=True), len(data))
        assert (tmp_path / "f.lz4").read_bytes() == want.getvalue(), flags
        res = _cli(["-d", "-f", "f.lz4", "g"], tmp_path)
        assert res.returncode == 0, res.stderr
        assert (tmp_path / "g").read_bytes() == data


def test_cli_stdin_stdout_and_multiple(tmp_path):
    data = gen_buffer(40_000, 0.7, 72)
    res = _cli(["-c", "-BD"], tmp_path, stdin=data)
    assert res.returncode == 0, res.stderr
    back = _cli(["-d", "-c"], tmp_path, stdin=res.stdout)
    assert back.returncode == 0 and back.stdout == data
    for name in ("x", "y"):
        (tmp_path / name).write_bytes(data[:20_000] + name.encode())
    assert _cli(["-m", "-3", "x", "y"], tmp_path).returncode == 0
    for name in ("x", "y"):
        (tmp_path / name).unlink()
    assert _cli(["-d", "-m", "x.lz4", "y.lz4"], tmp_path).returncode == 0
    assert (tmp_path / "y").read_bytes() == data[:20_000] + b"y"


def test_cli_refusals_and_version(tmp_path):
    (tmp_path / "f").write_bytes(b"abc" * 100)
    res = _cli(["--version"], tmp_path)
    assert res.returncode == 0 and b"lz4_tpu_torch v" in res.stdout
    # no card and no request for the CPU: a clear failure, never the CPU
    if not torch.cuda.is_available():
        res = _cli(["f"], tmp_path, force_cpu=False)
        assert res.returncode == 1 and b"LZ4TPU_FORCE_CPU" in res.stderr
        assert not (tmp_path / "f.lz4").exists()


@pytest.mark.parametrize("level", [1, 9])
def test_cli_bench(tmp_path, level):
    (tmp_path / "f").write_bytes(gen_buffer(70_000, 0.8, 81))
    res = _cli([f"-b{level}", "-i1", "f"], tmp_path, LZ4T_BENCH_SECONDS="0.05")
    assert res.returncode == 0, res.stderr
    line = res.stdout.decode()
    assert line.startswith("f") and "70000 ->" in line and "MB/s" in line
