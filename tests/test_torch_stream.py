"""The port's stream decoder (kernel E's plain version), its frame and legacy
routes and the file-level decoder (lz4_tpu_torch.io), held against lz4_tpu.

Both packages get the same bytes.  The JAX side runs its stream kernel in
interpret mode, whose cost grows with the number of LZ4 sequences, so the
inputs here are long but sparse (few sequences per KB: repeats, zero runs,
short noise).  Codec outputs are integers: every comparison is exact
(lengths, -1 verdicts and decoded bytes).
"""

import dataclasses
import io
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu import io as jio
from lz4_tpu import spec as jspec
from lz4_tpu import tpu as jtpu
from lz4_tpu.frame import FrameCompressor, FrameDecompressor
from lz4_tpu.frame import Lz4FrameError as JaxFrameError
from lz4_tpu.frame import FramePreferences as JaxPrefs
from lz4_tpu.frame import compress_legacy, decompress_legacy, \
    make_skippable_frame
from lz4_tpu.kernels import decode_kernel as jdec
from lz4_tpu.ops.block_np import compress_block, decompress_block
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import device as tdev
from lz4_tpu_torch import io as tio
from lz4_tpu_torch import legacy as tlegacy
from lz4_tpu_torch import spec as tspec
from lz4_tpu_torch.frame import (FramePreferences, Lz4FrameError,
                                 encode_frame_header)
from lz4_tpu_torch.kernels import common
from lz4_tpu_torch.kernels import decode_kernel as tdec

CPU = "cpu"
KB = 1024
FX = Path(__file__).parent / "fixtures"


def sparse_data(n: int, seed: int) -> bytes:
    """``n`` bytes with few LZ4 sequences: datagen segments repeated, zero
    runs and short noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    parts, size, k = [], 0, 0
    while size < n:
        seg = gen_buffer(int(rng.integers(500, 3000)), 0.6, seed * 100 + k)
        parts += [seg * int(rng.integers(5, 40)),
                  bytes(int(rng.integers(100, 5000))),
                  rng.integers(0, 256, int(rng.integers(10, 300)),
                               dtype=np.uint8).tobytes()]
        size += sum(map(len, parts[-3:]))
        k += 1
    return b"".join(parts)[:n]


def _payloads(chunks, linked):
    """Compressed blocks of ``chunks``; linked blocks match into the 64 KB
    of content before them."""
    out, prev = [], b""
    for c in chunks:
        out.append(compress_block(c, dict_=prev[-65536:] if linked else b""))
        prev += c
    return out


def _stream_model(flat: bytes, bstart, clen, stored, caps):
    """Kernel E's linked statuses as the card works them out: every block's
    parse, a stored block's fit, then the in-order scan of step B."""
    parsed = [((n if n <= cap else -1), 0, False) if st else
              tdec.parse_block_plain(flat[s:s + n], n, cap)
              for s, n, st, cap in zip(bstart, clen, stored, caps)]
    return tdec.stream_statuses_plain(parsed)[0]


def _payload_model(payloads, bs):
    """``_stream_model`` over a list of compressed payloads, caps ``bs``."""
    bstart = np.cumsum([0] + [len(p) for p in payloads])[:-1].tolist()
    return _stream_model(b"".join(payloads), bstart, list(map(len, payloads)),
                         [0] * len(payloads), [bs] * len(payloads))


def _assert_same(j_out, j_olen, t_out, t_olen):
    """Equal olen, and equal bytes over the good blocks' total."""
    j_olen = np.asarray(j_olen)
    t_olen = t_olen.numpy()
    assert (j_olen == t_olen).all(), (j_olen, t_olen)
    total = int(t_olen[t_olen > 0].sum())
    j_flat = np.asarray(j_out).astype(np.uint8).reshape(-1)[:total]
    assert j_flat.tobytes() == t_out[:total].numpy().tobytes()
    return t_out[:total].numpy().tobytes(), list(t_olen)


# ---------------------------------------------------------------------------
# decode_stream / decode_stream_raw against lz4_tpu's stream kernel
# ---------------------------------------------------------------------------

STREAM_CASES = {
    # name: (block size, linked, chunk sizes)
    "independent_256k": (256 * KB, False, [256 * KB, 256 * KB, 70_000]),
    "linked_256k": (256 * KB, True, [256 * KB, 256 * KB, 70_000]),
    "linked_1m": (1 << 20, True, [1 << 20, 150_000]),
    # a flushed short mid-stream block keeps its successors' caps
    "short_midstream": (256 * KB, False, [256 * KB, 1000, 256 * KB]),
    "short_midstream_linked": (256 * KB, True, [256 * KB, 1000, 256 * KB]),
    # flushed chains: matches reach across several short blocks
    "flushed_short_blocks": (64 * KB, True, [3000, 700, 5000, 64 * KB, 2000,
                                             900, 64 * KB, 30_000]),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_decode_stream_matches_jax(case):
    bs, linked, sizes = STREAM_CASES[case]
    data = sparse_data(sum(sizes), len(case))
    chunks, pos = [], 0
    for n in sizes:
        chunks.append(data[pos:pos + n])
        pos += n
    payloads = _payloads(chunks, linked)
    want = jdec.decode_stream(payloads, bs, len(data), linked=linked)
    got = tdec.decode_stream(payloads, bs, len(data), linked=linked,
                             device=CPU)
    content, olen = _assert_same(*want, *got)
    assert content == data and olen == sizes
    if linked:
        assert _payload_model(payloads, bs) == olen


def _raw_layout():
    """A flat buffer of blocks at odd offsets: compressed, stored, an empty
    compressed block, a literal run ending exactly at clen, a stored block
    over its cap, one that reaches into the previous blocks, a truncated
    one.  Returns (flat, bstart, clen, stored, caps, the blocks' bytes)."""
    a = sparse_data(100_000, 41)
    b = incompressible(1000, 5)
    lit = b"exactly at clen!!!!!"
    c = sparse_data(600, 42)
    d = (a[-3000:] + sparse_data(30_000, 43))
    blocks = [
        (compress_block(a), False, 256 * KB),
        (b, True, 256 * KB),
        (b"", False, 256 * KB),
        (tlegacy.literal_head(len(lit)) + lit, False, 256 * KB),
        (c, True, 500),
        (compress_block(d, dict_=a + b + lit), False, 256 * KB),
        (compress_block(a)[:-7], False, 256 * KB),
    ]
    flat = bytearray(b"\x07\x01\x02")
    bstart, clen = [], []
    for p, _, _ in blocks:
        bstart.append(len(flat))
        clen.append(len(p))
        flat += p + b"\x55"
    return (np.frombuffer(bytes(flat), np.uint8), bstart, clen,
            [int(s) for _, s, _ in blocks], [c_ for _, _, c_ in blocks],
            [a, b, None, lit, None, d, None])


@pytest.mark.parametrize("linked", [False, True])
def test_decode_stream_raw_matches_jax(linked):
    flat, bstart, clen, stored, caps, plain = _raw_layout()
    want = jdec.decode_stream_raw(flat, bstart, clen, stored, 256 * KB,
                                  sum(caps), linked=linked, out_caps=caps)
    got = tdec.decode_stream_raw(torch.from_numpy(flat.copy()), bstart, clen,
                                 stored, 256 * KB, sum(caps), linked=linked,
                                 out_caps=caps)
    _, olen = _assert_same(*want, *got)
    expect = [len(x) if x is not None else -1 for x in plain]
    if not linked:
        expect[5] = -1            # its first match reaches before the block
    assert olen == expect
    if linked:
        assert _stream_model(flat.tobytes(), bstart, clen, stored, caps) == \
            olen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decode_stream_bit_flip_verdicts_match_jax(seed):
    """A bit flip may still leave a valid stream: the verdict and the
    decoded length equal lz4_tpu's, and the host oracle's."""
    rng = np.random.default_rng(seed)
    data = sparse_data(300_000, 9)
    bs = 256 * KB
    linked = bool(seed % 2)
    payloads = [bytearray(p) for p in
                _payloads([data[:bs], data[bs:]], linked)]
    k = seed % 2
    for _ in range(1 + seed):
        i = int(rng.integers(len(payloads[k])))
        payloads[k][i] ^= 1 << int(rng.integers(8))
    payloads = [bytes(p) for p in payloads]
    want = jdec.decode_stream(payloads, bs, len(data), linked=linked)
    got = tdec.decode_stream(payloads, bs, len(data), linked=linked,
                             device=CPU)
    _, olen = _assert_same(*want, *got)
    if linked:
        assert _payload_model(payloads, bs) == olen
    if k == 0:
        try:
            assert olen[0] == len(decompress_block(payloads[0], bs))
        except Exception as exc:          # the oracle's own error type
            assert olen[0] == -1, exc


def test_decode_stream_noise_matches_jax():
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 3000, 12)]
    for linked in (False, True):
        want = jdec.decode_stream(payloads, 64 * KB, 0, linked=linked)
        got = tdec.decode_stream(payloads, 64 * KB, 0, linked=linked,
                                 device=CPU)
        _, olen = _assert_same(*want, *got)
        if linked:
            assert _payload_model(payloads, 64 * KB) == olen


@pytest.mark.parametrize("case", ["first_block", "after_short_block"])
def test_decode_stream_need_past_the_output_matches_jax(case):
    """Linked blocks whose matches reach farther back than the output
    decoded so far: a first block taken from the middle of a chain, and a
    block reaching 5,000 bytes back behind a first block of 1,000."""
    data = sparse_data(200_000, 21)
    if case == "first_block":
        chunks = [data[i:i + 40_000] for i in range(0, 200_000, 40_000)]
        payloads = _payloads(chunks, True)[1:]
    else:
        rep = data[:5000] * 8
        payloads = [compress_block(data[5000:6000]),
                    compress_block(rep[:20_000], dict_=data[:6000])]
    want = jdec.decode_stream(payloads, 64 * KB, 0, linked=True)
    got = tdec.decode_stream(payloads, 64 * KB, 0, linked=True, device=CPU)
    _, olen = _assert_same(*want, *got)
    assert olen[-1 if case == "after_short_block" else 0] == -1
    assert _payload_model(payloads, 64 * KB) == olen


def test_decode_stream_checks_its_arguments(monkeypatch):
    flat = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 64KB"):
        tdec.decode_stream_raw(flat, [0], [10], [0], 1000, 0)
    with pytest.raises(ValueError, match="inside flat"):
        tdec.decode_stream_raw(flat, [95], [10], [0], 64 * KB, 0)
    with pytest.raises(ValueError, match="one entry per block"):
        tdec.decode_stream_raw(flat, [0, 5], [10], [0, 0], 64 * KB, 0)
    with pytest.raises(ValueError, match="negative"):
        tdec.decode_stream_raw(flat, [0], [1], [0], 64 * KB, 0,
                               out_caps=[-1])
    monkeypatch.setattr(tdec, "STREAM_MAX_INPUT", 99)
    with pytest.raises(tdec.StreamEnvelopeError, match="int32"):
        tdec.decode_stream_raw(flat, [0], [1], [0], 64 * KB, 0)


def test_a_block_past_the_run_bound_fails_as_in_one_call(monkeypatch):
    """A block whose payload alone passes STREAM_MAX_INPUT fails without a
    launch, as one call fails it (no such payload fits a block's cap)."""
    big = incompressible(200_000, 71)
    small = compress_block(sparse_data(30_000, 72))
    flat = small + big + small
    starts = [0, len(small), len(small) + len(big)]
    sizes = [len(small), len(big), len(small)]
    monkeypatch.setattr(tdec, "STREAM_BLOCK_CAP", 150_000)
    out, olen = tdec.decode_stream_raw(
        torch.frombuffer(bytearray(flat), dtype=torch.uint8), starts, sizes,
        [0, 1, 0], 256 * KB, 0, False)
    monkeypatch.setattr(tdec, "STREAM_MAX_INPUT", 150_000)
    got, g_olen = tdev.decode_stream_runs(flat, starts, sizes, [0, 1, 0],
                                          [256 * KB] * 3, 256 * KB, False,
                                          torch.device(CPU))
    assert g_olen.tolist() == olen.tolist() == [30_000, -1, 30_000]
    assert got == out[:60_000].numpy().tobytes()


def _lz4_bd_caps(rng):
    """A 2.3 GiB `lz4 -BD` chain: 600 blocks with the 4 MB cap."""
    return np.full(600, 4 << 20, np.int64)


def _flushed_caps(rng):
    """Caps of a ragged flushed chain: 0 to 8 MB, some empty."""
    caps = rng.integers(0, tdec.STREAM_BLOCK_CAP + 1, 300)
    caps[rng.integers(300, size=40)] = 0
    return caps


@pytest.mark.parametrize("limit", [1, 64 * KB, 20_000_000, None])
@pytest.mark.parametrize("make_caps", [_lz4_bd_caps, _flushed_caps])
def test_cell_windows_bound_every_reference(limit, make_caps):
    """On the card a linked chain decodes into int32 cells in windows
    (``cell_windows``), each reading the final bytes of those before it.
    The windows cover the blocks in order, and past block 0 each holds at
    most ``limit`` bytes of caps or one block, and no fewer blocks than
    fit.  A reference spans at most a window plus 64 KB, so with the
    kernels' own limit it fits int32 on a chain of any length (the 2.3 GiB
    chain included); so does kernel D's, whose windows are CELL_WINDOW //
    block_size rows of at most 8 MB."""
    limit = tdec.CELL_WINDOW if limit is None else limit
    caps = make_caps(np.random.default_rng(5))
    w = tdec.cell_windows(caps, limit)
    assert w[0] == 0 and w[-1] == len(caps) and (np.diff(w) > 0).all()
    for b0, b1 in zip(w[:-1], w[1:]):
        held = caps[max(b0, 1):b1]
        assert held.sum() <= limit or len(held) == 1
        if b1 < len(caps):
            assert held.sum() + caps[b1] > limit
    assert tdec.CELL_WINDOW + 2 * tdec.STREAM_BLOCK_CAP + tdec.MAX_OFFSET \
        < 2 ** 31


def _cell_windows_loop(caps, limit, first):
    """cell_windows as the loop it replaced: a block starts a new window
    when the held caps (from block ``first`` on) would pass the limit."""
    bounds, held, count = [0], 0, 0
    for b in range(first, len(caps)):
        if count and held + caps[b] > limit:
            bounds.append(b)
            held = count = 0
        held += int(caps[b])
        count += 1
    bounds.append(len(caps))
    return bounds


@pytest.mark.parametrize("first", [0, 1])
def test_cell_windows_equal_the_loop(first):
    """The searchsorted windows equal the greedy loop on ragged caps with
    zeros, limits from 1 to past the sum, and chains of 0 to 39 blocks."""
    rng = np.random.default_rng(first)
    for _ in range(400):
        caps = rng.integers(0, 100, int(rng.integers(0, 40)))
        caps[rng.random(len(caps)) < 0.2] = 0
        for limit in (1, 50, 99, 150, 5000):
            assert tdec.cell_windows(caps, limit, first).tolist() == \
                _cell_windows_loop(caps, limit, first)


def test_decode_stream_counts_plain_calls():
    common.reset_counts()
    tdec.decode_stream([compress_block(b"x" * 100)], 64 * KB, 100,
                       device=CPU)
    assert common.PLAIN_CALLS["decode_stream"] == 1
    assert common.LAUNCHES["decode_stream"] == 0


# ---------------------------------------------------------------------------
# frames of large blocks, legacy files, fixtures
# ---------------------------------------------------------------------------

FRAME_CASES = [
    # (block size id, independent, checksums)
    (5, True, False), (5, False, True), (6, True, True), (6, False, False),
    (7, True, True), (7, False, False)]


def _host_frame(data, **kw):
    c = FrameCompressor(JaxPrefs(**kw))
    return c.begin() + c.update(data) + c.end()


@pytest.mark.parametrize("bsid,independent,checksums", FRAME_CASES)
def test_large_block_frames_match_jax(bsid, independent, checksums):
    data = sparse_data(400_000, bsid) + incompressible(50_000, bsid)
    frame = _host_frame(data, block_size_id=bsid,
                        block_independent=independent,
                        content_checksum=checksums, block_checksum=checksums,
                        content_size=len(data) if checksums else None)
    got = tdev.decompress_frame_device(frame + b"tail", device=CPU)
    assert got == jtpu.decompress_frame_device(frame + b"tail") \
        == (data, len(frame))


def test_stored_block_over_block_size_is_accepted_like_jax():
    """A stored block longer than block_size: lz4_tpu accepts it (its cap
    is the stored length), and so does the port."""
    big = incompressible(300 * KB, 9)
    tail = sparse_data(50_000, 3)
    prefs = FramePreferences(block_size_id=5, block_independent=True)
    frame = (encode_frame_header(prefs)
             + struct.pack("<I", len(big) | tspec.UNCOMPRESSED_BIT) + big
             + chip_smoke.block_records([compress_block(tail)])
             + struct.pack("<I", 0))
    assert tdev.decompress_frame_device(frame, device=CPU) == \
        jtpu.decompress_frame_device(frame) == (big + tail, len(frame))


def test_corrupt_large_block_raises_frame_error_with_index():
    """lz4_tpu raises DeviceLayoutUnsupported here and re-decodes on its
    host; the port raises Lz4FrameError naming the block."""
    data = sparse_data(600_000, 4)
    frame = bytearray(_host_frame(data, block_size_id=5,
                                  block_independent=True))
    recs = chip_smoke.frame_payloads(bytes(frame), 7)
    pos = 7 + 4 + len(recs[0][0]) + 4 + len(recs[1][0])
    frame[pos + 4:pos + 8] = b"\x00\x00\x00\x00"    # block 2: offset 0
    with pytest.raises(Lz4FrameError, match="block 2") as exc:
        tdev.decompress_frame_device(bytes(frame), device=CPU)
    assert not isinstance(exc.value, tdev.DeviceLayoutUnsupported)
    with pytest.raises(jtpu.DeviceLayoutUnsupported, match="block 2"):
        jtpu.decompress_frame_device(bytes(frame))


def test_legacy_matches_jax():
    data = sparse_data(300_000, 6)
    frame = compress_legacy(data)
    nxt = _host_frame(b"next", block_size_id=4)
    got = tdev.decompress_legacy_device(frame + nxt, device=CPU)
    assert got == jtpu.decompress_legacy_device(frame + nxt) \
        == decompress_legacy(frame + nxt) == (data, len(frame))
    with pytest.raises(Lz4FrameError, match="not a legacy frame"):
        tdev.decompress_legacy_device(nxt, device=CPU)
    with pytest.raises(Lz4FrameError, match="truncated legacy block"):
        tdev.decompress_legacy_device(frame[:-10], device=CPU)


@pytest.mark.parametrize("name", ["default.lz4", "hc9_b5_linked.lz4",
                                  "legacy.lz4"])
def test_fixture_files_decode_to_golden_input(name):
    src = io.BytesIO((FX / name).read_bytes())
    out = io.BytesIO()
    tio.decompress_stream(src, out, tio.IoPrefs(), device=CPU)
    assert out.getvalue() == (FX / "golden_input.bin").read_bytes()


# ---------------------------------------------------------------------------
# lz4_tpu_torch.io against lz4_tpu.io (host codec)
# ---------------------------------------------------------------------------

def _io_inputs():
    a = sparse_data(200_000, 21)
    b = sparse_data(90_000, 22)
    f1 = _host_frame(a, block_size_id=5, content_checksum=True)
    f2 = _host_frame(b, block_size_id=4, block_independent=True)
    leg = compress_legacy(b)
    skip = make_skippable_frame(b"user data", 3)
    return {
        "concatenated": (f1 + f2 + f1, False),
        "skippable": (skip + f2 + skip + f1, False),
        "legacy_then_frame": (leg + f1, False),
        "trailing_garbage": (f2 + b"\x01\x02\x03\x04garbage", False),
        "trailing_short": (f2 + b"\x01\x02", False),
        "pass_through": (b"not an lz4 stream at all", True),
        "pass_through_short": (b"ab", True),
    }


@pytest.mark.parametrize("case", sorted(_io_inputs()))
def test_decompress_stream_matches_jax_host(case):
    data, pass_through = _io_inputs()[case]
    j_out, t_out = io.BytesIO(), io.BytesIO()
    want = jio.decompress_stream(io.BytesIO(data), j_out, jio.IoPrefs(
        use_device=False, pass_through=pass_through))
    got = tio.decompress_stream(io.BytesIO(data), t_out, tio.IoPrefs(
        pass_through=pass_through), device=CPU)
    assert got == want
    assert t_out.getvalue() == j_out.getvalue()


@pytest.mark.parametrize("data", [b"\x05\x06\x07\x08", b"\x01"])
def test_decompress_stream_rejects_unknown_first_stream(data):
    with pytest.raises(Lz4FrameError):
        tio.decompress_stream(io.BytesIO(data), io.BytesIO(), tio.IoPrefs(),
                              device=CPU)
    with pytest.raises(JaxFrameError):
        jio.decompress_stream(io.BytesIO(data), io.BytesIO(),
                              jio.IoPrefs(use_device=False))


def _envelope_frames():
    """Frames of kernel E's routes, each of several blocks: (the frame,
    the decoder of both packages, whether its blocks are linked)."""
    data = (sparse_data(300_000, 61) + incompressible(120_000, 62)
            + sparse_data(300_000, 63))
    # segments repeated across block bounds: a block's first matches reach
    # into the block before
    linked = sparse_data(800_000, 64)
    legacy = (struct.pack("<I", jspec.LEGACY_MAGIC) + chip_smoke.block_records(
        [compress_block(data[i:i + 200_000])
         for i in range(0, len(data), 200_000)]))
    comp = tdev.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                      device=CPU)
    flushed = comp.begin() + b"".join(
        comp.update(c) + comp.flush()
        for c in (linked[:150_000], linked[150_000:151_000],
                  linked[151_000:300_000])) + comp.end()
    return {
        "b5_independent": (_host_frame(data, block_size_id=5,
                                       block_independent=True,
                                       content_checksum=True), "frame",
                           False),
        "b5_linked": (_host_frame(linked, block_size_id=5), "frame", True),
        "legacy": (legacy, "legacy", False),
        "flushed_64k_chain": (flushed, "frame", True),
    }


@pytest.mark.parametrize("case", sorted(_envelope_frames()))
def test_frames_past_the_stream_envelope_decode_in_runs(case, monkeypatch):
    """lz4_tpu hands a frame past kernel E's int32 input to its host codec;
    the port decodes it in runs of at most STREAM_MAX_INPUT bytes (patched
    down so that each frame takes 2 to 4), the last 64 KB decoded carried
    into the next run of a linked chain, to lz4_tpu's answer."""
    frame, kind, linked = _envelope_frames()[case]
    port = tdev.decompress_legacy_device if kind == "legacy" \
        else tdev.decompress_frame_device
    jax = decompress_legacy if kind == "legacy" \
        else jtpu.decompress_frame_device
    recs = (chip_smoke.frame_payloads(frame, 7) if kind == "frame" else
            [(p, False) for p in _legacy_payloads(frame)])
    limit = max(len(frame) // 3, max(len(p) for p, _ in recs) + 10) \
        + (64 * KB if linked else 0)
    monkeypatch.setattr(tdec, "STREAM_MAX_INPUT", limit)
    calls = []
    real = tdec.decode_stream_raw
    monkeypatch.setattr(tdev, "decode_stream_raw",
                        lambda *a, **k: calls.append(a[0].numel())
                        or real(*a, **k))
    want = jax(frame)
    assert port(frame, device=CPU) == want
    assert 2 <= len(calls) <= 4 and max(calls) <= limit, calls
    if case == "b5_linked":
        # some run's first block decodes only with the run before it
        st, sz, _ = chip_smoke._records(frame, 7)
        firsts = tdev._runs(st, sz, [256 * KB] * len(st), 64 * KB)[1:-1]

        def needs_window(payload):
            try:
                decompress_block(payload, 256 * KB)
            except Exception:
                return True
            return False

        assert any(needs_window(recs[j][0]) for j in firsts)
    out = io.BytesIO()
    tio.decompress_stream(io.BytesIO(frame), out, tio.IoPrefs(), device=CPU)
    assert out.getvalue() == want[0]


def _legacy_payloads(frame):
    """The blocks of a legacy file with no frame after it."""
    out, pos = [], 4
    while pos < len(frame):
        n = struct.unpack_from("<I", frame, pos)[0]
        out.append(frame[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def test_corrupt_block_across_a_run_cut_is_named_by_frame_index(monkeypatch):
    """A corrupt block in the second run of a frame is named by its index
    in the frame, as lz4_tpu names it."""
    data = sparse_data(1_200_000, 65)
    frame = bytearray(_host_frame(data, block_size_id=5,
                                  block_independent=True))
    recs = chip_smoke.frame_payloads(bytes(frame), 7)
    pos = 7 + sum(4 + len(p) for p, _ in recs[:3])
    frame[pos + 4:pos + 8] = b"\x00\x00\x00\x00"    # block 3: offset 0
    monkeypatch.setattr(tdec, "STREAM_MAX_INPUT",
                        sum(4 + len(p) for p, _ in recs[:2]))
    with pytest.raises(Lz4FrameError, match="block 3") as exc:
        tdev.decompress_frame_device(bytes(frame), device=CPU)
    assert not isinstance(exc.value, tdev.DeviceLayoutUnsupported)
    with pytest.raises(jtpu.DeviceLayoutUnsupported, match="block 3"):
        jtpu.decompress_frame_device(bytes(frame))


@pytest.mark.parametrize("linked", [False, True])
@pytest.mark.parametrize("per_run", [1, 2, 3])
def test_decode_stream_runs_equal_one_call(linked, per_run, monkeypatch):
    """decode_stream_runs gives the bytes and olen of one decode_stream_raw
    call over all the blocks, with runs of ``per_run`` blocks, a rejected
    block and stored blocks among them."""
    chunks = [sparse_data(100_000, 70 + k) for k in range(6)]
    payloads = _payloads(chunks, linked)
    payloads[3] = payloads[3][:-7]                  # rejected
    stored = [0, 0, 1, 0, 0, 0]
    payloads[2] = chunks[2]
    flat = b"\x09" + b"".join(p + b"\x55" for p in payloads)
    starts = np.cumsum([1] + [len(p) + 1 for p in payloads])[:-1].tolist()
    sizes = [len(p) for p in payloads]
    caps = [256 * KB] * 6
    out, olen = tdec.decode_stream_raw(
        torch.frombuffer(bytearray(flat), dtype=torch.uint8), starts, sizes,
        stored, 256 * KB, 0, linked, out_caps=caps)
    want = out[:int(olen[olen > 0].sum())].numpy().tobytes()
    monkeypatch.setattr(tdec, "STREAM_MAX_INPUT", max(
        starts[k + per_run - 1] + sizes[k + per_run - 1] - starts[k]
        for k in range(len(starts) - per_run + 1))
        + (64 * KB if linked else 0))
    got, g_olen = tdev.decode_stream_runs(flat, starts, sizes, stored, caps,
                                          256 * KB, linked,
                                          torch.device(CPU))
    assert g_olen.tolist() == olen.tolist()
    assert got == want
    assert -1 in g_olen.tolist()
    assert len(tdev._runs(starts, sizes, caps, 64 * KB if linked else 0)) \
        - 1 >= 2


@pytest.mark.parametrize("sparse", [True, False])
def test_sparse_writer_file_bytes(tmp_path, sparse):
    data = (b"head" + bytes(3 * 4096 + 17) + b"middle" + bytes(2 * 4096)
            + b"x" * 5000 + bytes(4096 * 3))
    for mod, name in ((tio, "port"), (jio, "jax")):
        path = tmp_path / name
        with open(path, "wb") as f:
            w = mod.SparseWriter(f, sparse)
            for i in range(0, len(data), 3000):
                w.write(data[i:i + 3000])
            w.close()
            if w.enabled:
                f.truncate(w.written)
            assert w.written == len(data)
    assert (tmp_path / "port").read_bytes() == data == \
        (tmp_path / "jax").read_bytes()


def test_decompress_filename_and_multiple(tmp_path):
    data = sparse_data(150_000, 31) + bytes(20_000)
    frame = _host_frame(data, block_size_id=6, content_checksum=True)
    src = tmp_path / "a.bin.lz4"
    src.write_bytes(frame)
    prefs = tio.IoPrefs()
    assert tio.decompress_filename(str(src), str(tmp_path / "out"), prefs,
                                   device=CPU) == (len(frame), len(data))
    assert (tmp_path / "out").read_bytes() == data
    with pytest.raises(FileExistsError):
        tio.decompress_filename(str(src), str(tmp_path / "out"), prefs,
                                device=CPU)
    test = dataclasses.replace(prefs, test_mode=True)
    assert tio.decompress_filename(str(src), "", test, device=CPU) == \
        (len(frame), len(data))
    (tmp_path / "b.bin.lz4").write_bytes(b"garbage!")
    (tmp_path / "c.txt").write_bytes(b"")
    paths = [str(src), str(tmp_path / "b.bin.lz4"), str(tmp_path / "c.txt")]
    assert tio.decompress_multiple(paths, prefs, device=CPU) == 2
    assert (tmp_path / "a.bin").read_bytes() == data


def test_progress_meter_writes_after_16mb(capsys, monkeypatch):
    m = tio.ProgressMeter(tio.IoPrefs(), "Decoded", 64 << 20)
    monkeypatch.setattr(m, "next_at", 0.0)
    m.update(1 << 20, 0)                       # under 16 MB: silent
    m.update(32 << 20, 16 << 20)
    m.done()
    err = capsys.readouterr().err
    assert "Decoded : 32 MB (50.0%)  ==> 50.00%" in err
    quiet = tio.ProgressMeter(tio.IoPrefs(verbosity=1), "Decoded")
    quiet.update(32 << 20, 0)
    assert capsys.readouterr().err == ""


# ---------------------------------------------------------------------------
# chip_smoke's merging of 256 KB payloads into 4 MB / 8 MB blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [2, 4])
def test_merged_blocks_decode_to_their_content(group):
    """Independent 256 KB payloads (and a stored one) merged into blocks of
    ``group`` payloads, as chip_smoke builds its -B7 frames and legacy
    files, decode through lz4_tpu's host decoder and the port."""
    bs = 256 * KB
    data = (sparse_data(3 * bs, 51) + incompressible(bs, 52)
            + gen_buffer(bs, 0.7, 53) + b"z" * 1000)
    prefs = JaxPrefs(block_size_id=5, block_independent=True)
    frame = _host_frame(data, **dataclasses.asdict(prefs))
    recs = chip_smoke.frame_payloads(frame, 7)
    assert any(st for _, st in recs)
    merged = tlegacy.merged_blocks(recs, group)
    assert len(merged) == -(-len(recs) // group)
    for i, blk in enumerate(merged):
        want = data[i * group * bs:(i + 1) * group * bs]
        assert decompress_block(blk, len(want)) == want
    legacy = (struct.pack("<I", jspec.LEGACY_MAGIC)
              + chip_smoke.block_records(merged))
    assert decompress_legacy(legacy) == (data, len(legacy))
    assert tdev.decompress_legacy_device(legacy, device=CPU) == \
        (data, len(legacy))
    b7 = (encode_frame_header(FramePreferences(
        block_size_id=7, block_independent=True))
        + chip_smoke.block_records(merged) + struct.pack("<I", 0))
    d = FrameDecompressor()
    assert d.feed(b7) == (len(b7), data)
    assert tdev.decompress_frame_device(b7, device=CPU) == (data, len(b7))


# ---------------------------------------------------------------------------
# kernel E's independent mode on the card: the CPU model of its schedule
# (run ends, next, doubling, the walk, spans into cells, rounds)
# ---------------------------------------------------------------------------

def _spans_model(flat: bytes, bstart, clen, stored, caps, span_logs=(0, 2)):
    """``decode_stream_spans_plain`` at each span size equals the serial
    walk (independent mode): bytes and olen.  Returns the serial walk's."""
    want = tdec.decode_stream_plain(flat, bstart, clen, stored, caps, False)
    for s in (*span_logs, tdec.SPAN_LOG):
        got = tdec.decode_stream_spans_plain(flat, bstart, clen, stored,
                                             caps, s)
        assert got == want, (s, got[1], want[1])
    return want


def _layout(payloads, pad=b"\x55"):
    """Payloads at odd offsets of one buffer: (flat, bstart, clen)."""
    flat, bstart = bytearray(b"\x07\x01\x02"), []
    for p in payloads:
        bstart.append(len(flat))
        flat += p + pad
    return bytes(flat), bstart, [len(p) for p in payloads]


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_spans_model_matches_the_serial_walk(case):
    """Every stream case, its blocks taken as independent ones (linked
    blocks whose matches reach back then fail, as the serial walk says)."""
    bs, linked, sizes = STREAM_CASES[case]
    data = sparse_data(sum(sizes), len(case))
    chunks = np.split(np.frombuffer(data, np.uint8), np.cumsum(sizes)[:-1])
    payloads = _payloads([c.tobytes() for c in chunks], linked)
    flat, bstart, clen = _layout(payloads)
    content, olen = _spans_model(flat, bstart, clen, [0] * len(payloads),
                                 [bs] * len(payloads))
    if not linked:
        assert content == data and olen == sizes


def test_spans_model_raw_layout_and_stored_blocks():
    flat, bstart, clen, stored, caps, _ = _raw_layout()
    _, olen = _spans_model(flat.tobytes(), bstart, clen, stored, caps)
    assert olen[1] == 1000 and olen[4] == -1 and olen[5] == -1


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_spans_model_bit_flips_match_jax(seed):
    """Bit-flipped independent blocks: the model, the serial walk and
    lz4_tpu's interpret-mode stream kernel agree on verdicts and bytes."""
    rng = np.random.default_rng(seed)
    data = sparse_data(300_000, 9)
    bs = 256 * KB
    payloads = [bytearray(p) for p in _payloads([data[:bs], data[bs:]],
                                                False)]
    for _ in range(1 + seed):
        k = int(rng.integers(2))
        i = int(rng.integers(len(payloads[k])))
        payloads[k][i] ^= 1 << int(rng.integers(8))
    payloads = [bytes(p) for p in payloads]
    flat, bstart, clen = _layout(payloads)
    content, olen = _spans_model(flat, bstart, clen, [0, 0], [bs, bs])
    want = jdec.decode_stream(payloads, bs, len(data), linked=False)
    assert np.asarray(want[1]).tolist() == olen
    j_flat = np.asarray(want[0]).astype(np.uint8).reshape(-1)
    assert j_flat[:len(content)].tobytes() == content


def test_spans_model_noise():
    rng = np.random.default_rng(13)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(1, 3000, 40)]
    flat, bstart, clen = _layout(payloads)
    _, olen = _spans_model(flat, bstart, clen, [0] * 40, [64 * KB] * 40,
                           span_logs=(0, 1, 3))
    assert -1 in olen


ADVERSARIAL = chip_smoke.stream_adversarial(
    20_000, sparse_data(30_000, 61))


@pytest.mark.parametrize("case", range(len(ADVERSARIAL)))
def test_spans_model_adversarial_blocks(case):
    """chip_smoke's hard cases at 20 KB: 255s, a match ending exactly at n,
    an offset before the block, a block over its cap, zeros (offset 1),
    a 7-byte period, long extensions at every span bound (with s = 0 and
    1 every token starts a span, so one starts right after each long
    extension)."""
    what, payload, cap = ADVERSARIAL[case]
    flat, bstart, clen = _layout([payload])
    _, olen = _spans_model(flat, bstart, clen, [0], [cap],
                           span_logs=(0, 1, 4))
    assert (olen[0] == -1) == (case < 4), what


def test_spans_model_on_adversarial_blocks_matches_jax():
    """The adversarial blocks in one stream through lz4_tpu's
    interpret-mode kernel: equal verdicts and bytes.  The payload of 255s
    goes last (see the next test)."""
    cases = ADVERSARIAL[1:] + ADVERSARIAL[:1]
    flat, bstart, clen = _layout([p for _, p, _ in cases])
    caps = [c for _, _, c in cases]
    content, olen = _spans_model(flat, bstart, clen, [0] * len(caps), caps)
    want = jdec.decode_stream_raw(np.frombuffer(flat, np.uint8), bstart,
                                  clen, [0] * len(caps), 64 * KB,
                                  sum(caps), linked=False, out_caps=caps)
    assert np.asarray(want[1]).tolist() == olen
    j_flat = np.asarray(want[0]).astype(np.uint8).reshape(-1)
    assert j_flat[:len(content)].tobytes() == content


def test_a_payload_of_255s_does_not_fail_the_next_block():
    """A difference from lz4_tpu, on purpose: after a block whose literal
    extension runs to its end (a payload of 255s), lz4_tpu's stream kernel
    also rejects the next, good block; blocks are independent, and the
    port (serial walk, model and kernel alike) decodes it."""
    _, payload, cap = ADVERSARIAL[0]
    good = chip_smoke.long_match(20_000, b"\0")
    flat, bstart, clen = _layout([payload, good])
    _, olen = _spans_model(flat, bstart, clen, [0, 0], [cap, 20_000])
    assert olen == [-1, 20_000]
    want = jdec.decode_stream_raw(np.frombuffer(flat, np.uint8), bstart,
                                  clen, [0, 0], 64 * KB, cap + 20_000,
                                  linked=False, out_caps=[cap, 20_000])
    assert np.asarray(want[1]).tolist() == [-1, -1]


@pytest.mark.parametrize("n", [1 << 16, 1 << 18])
def test_spans_model_work_is_linear_on_255s(n):
    """A payload of 255s: every byte starts a literal extension that runs
    to the block's end.  Run ends make each extension O(1), so the model's
    loads (steps 2-4) stay within 4 + 4 per doubling round per byte, and
    the walk takes one step; reading each extension byte by byte would
    take n^2 / 2."""
    stats = {}
    payload = b"\xff" * n
    _, olen = tdec.decode_stream_spans_plain(payload, [0], [n], [0], [n],
                                             8, stats)
    assert olen == [-1]
    assert stats["reads"] <= (4 + 4 * 8) * n
    assert stats["walk_steps"] == 1


def test_spans_model_literal_run_past_int32():
    """A literal run whose extension sums to 255 * 8,421,505 > 2^31 in one
    8 MB block: next() sums in int64 and rejects it; so does the serial
    walk."""
    payload = chip_smoke.INT32_RUN
    assert 255 * (len(payload) - 2) > 2 ** 31
    cap = tdec.STREAM_BLOCK_CAP
    assert len(payload) <= tdec.parse_limit(cap)
    J, _ = tdec.next_plain(np.frombuffer(payload, np.uint8), cap)
    assert J[0] == tdec.SEQ_FAIL
    assert tdec.decode_stream_spans_plain(payload, [0], [len(payload)], [0],
                                          [cap]) == (b"", [-1])
    assert tdec.decode_block_plain(payload, len(payload), cap)[0] == -1


def test_spans_model_sums_saturate(monkeypatch):
    """With the 8 MB cap patched down to 1,000 bytes, the doubled sums
    saturate at 1,001 and a block that outgrows its cap fails in the walk
    as in the serial decoder; one within it decodes."""
    monkeypatch.setattr(tdec, "STREAM_BLOCK_CAP", 1000)
    data = sparse_data(5000, 71)
    payloads = [compress_block(data), compress_block(data[:900])]
    flat, bstart, clen = _layout(payloads)
    _, olen = _spans_model(flat, bstart, clen, [0, 0], [1000, 1000],
                           span_logs=(3, 5))
    assert olen == [-1, 900]


def test_parse_limit_holds_for_the_densest_blocks():
    """A valid block's payload is never longer than parse_limit of its
    output: literal-only blocks, 15-literal sequences with 4-byte matches,
    3-byte sequences of 4-byte matches, and compressed noise and text."""
    lit15 = chip_smoke.lz4_seq(b"q" * 15, 1, 4)
    blocks = [chip_smoke.lz4_seq(b"x" * n) for n in (0, 1, 14, 15, 270,
                                                     100_000)]
    blocks += [b"".join([lit15] * 500) + chip_smoke.lz4_seq(b"e"),
               chip_smoke.lz4_seq(b"a", 1, 4) + b"".join(
                   [chip_smoke.lz4_seq(b"", 1, 4)] * 2000)
               + chip_smoke.lz4_seq(b""),
               compress_block(incompressible(70_000, 3)),
               compress_block(sparse_data(70_000, 4))]
    for blk in blocks:
        r, out = tdec.decode_block_plain(blk, len(blk), 1 << 20)
        assert r == len(out) >= 0
        assert len(blk) <= tdec.parse_limit(r)


def test_span_layout_bounds_the_scratch():
    """Near STREAM_MAX_INPUT: 255 blocks of 8 MB caps with 8.4 MB payloads.
    Every window holds at most PARSE_WINDOW bytes of parsed payload and
    CELL_WINDOW of caps, or one block; the windows cover the blocks in
    order; a payload past parse_limit is not parsed; slots bound the
    spans; the scratch stays near 2 GiB, not 17 bytes per input byte."""
    B = 255
    cap = tdec.STREAM_BLOCK_CAP
    clen = np.full(B, 8_400_000)
    clen[7] = tdec.parse_limit(cap) + 1          # too long: not parsed
    stored = np.zeros(B, np.int64)
    stored[9] = 1
    lay = tdec.span_layout(clen, np.full(B, cap), stored, tdec.SPAN_LOG)
    w = lay["windows"]
    assert w[0, 0] == 0 and w[-1, 1] == B and (w[1:, 0] == w[:-1, 1]).all()
    assert lay["parsed"][7] == 0 and lay["parsed"][9] == 0
    for b0, b1, P, slots, rounds, jy in w.tolist():
        parsed = lay["parsed"][b0:b1]
        assert P == parsed.sum()
        assert P <= tdec.PARSE_WINDOW or (parsed > 0).sum() == 1
        assert slots == sum(tdec.span_slots(p, tdec.SPAN_LOG)
                            for p in parsed if p)
        assert 1 <= rounds <= tdec.JUMP_ROUND_FLAGS and jy == cap // 4096
    pmax = int(w[:, 2].max())
    scratch = 17 * pmax + 4 * lay["cells"] + 8 * int(w[:, 3].max())
    assert scratch < 2.2 * 2 ** 30 and lay["cells"] <= tdec.CELL_WINDOW


def test_jump_rounds_bound_the_spans_chain():
    """A 7-byte period decoded in spans of one sequence each (s = 0): the
    references run back through every span to the first, and the model's
    rounds (one link each, synchronous) still resolve them all within the
    bound the card's rounds use; one round fewer would not."""
    head = b"abcdefg"
    payload = chip_smoke.lz4_seq(head, 7, 5) + b"".join(
        [chip_smoke.lz4_seq(b"", 7, 7)] * 40) + chip_smoke.lz4_seq(b"")
    flat, bstart, clen = _layout([payload])
    n = 7 + 5 + 40 * 7
    content, olen = _spans_model(flat, bstart, clen, [0], [n],
                                 span_logs=(0,))
    assert olen == [n] and content == (head * 50)[:n]
    src = np.frombuffer(payload, np.uint8)
    J, S = tdec.next_plain(src, n)
    spans, r = tdec.checkpoints_plain(J, S, n)
    cells = np.zeros(r, np.int64)
    for k, (ip, base) in enumerate(spans):
        stop = spans[k + 1][0] if k + 1 < len(spans) else None
        got, c = tdec.decode_cells_plain(payload, len(payload), n - base,
                                         base, ip, stop)
        cells[base:base + got] = c
    with pytest.raises(AssertionError, match="references left"):
        tdec.jump_cells_plain(cells, tdec.jump_rounds(len(spans)) - 1)
    assert tdec.jump_cells_plain(
        cells, tdec.jump_rounds(len(spans) + 1)).tobytes() == content
