"""The streaming half of the port's frame layer (``lz4_tpu_torch.frame``)
against ``lz4_tpu.frame``, on the CPU.

``FrameDecompressor`` is fed the frames of ``tests/test_frame.py`` (written
by lz4_tpu and by the port) and the fixture files in lockstep with
lz4_tpu's: byte by byte, and in random slices; after every call the
(consumed, output) pair, ``src_hint``, ``finished`` and ``info`` must be
equal, and a corrupt frame must raise the same error in the same call.
``FrameCompressor`` runs the matrix of block sizes (ids 4-7), independent
and linked blocks, checksums, ``flush`` and ``auto_flush``: every frame
decodes through ``lz4_tpu.frame.decompress_frame``, and its header, block
boundaries and content checksum equal lz4_tpu's.  The port runs the
kernels' plain versions (``device="cpu"``); tolerance 0 on bytes.
"""

import dataclasses
import random
import struct
import warnings
from pathlib import Path

import pytest
import torch

from chip_smoke import lz4_seq, real_text_corpus
from lz4_tpu import frame as jframe
from lz4_tpu.ops import block_np
from lz4_tpu.ops.xxhash_np import xxh32
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import device as tdevice
from lz4_tpu_torch import frame as tframe
from lz4_tpu_torch.frame import FramePreferences
from lz4_tpu_torch.kernels import common

from .test_torch_block_api import RATIO_BOUND, one_thread  # noqa: F401

CPU = "cpu"
FX = Path(__file__).resolve().parent / "fixtures"
DATA = gen_buffer(300_000, 0.7, 100)
SMALL = gen_buffer(5_000, 0.6, 101)


def jprefs(**kw):
    return jframe.FramePreferences(**kw)


def tprefs(**kw):
    return FramePreferences(**kw)


def outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except (jframe.Lz4FrameError, tframe.Lz4FrameError) as e:
        return "error", str(e)


def info_of(d):
    return None if d.info is None else dataclasses.asdict(d.info)


def lockstep(frame: bytes, steps, skip_skippable=True):
    """Feed ``frame`` to both decoders, slice after slice (``steps`` gives
    each slice's length), holding every call's result and state equal.
    Returns the content, or ("error", message) of the call that raised."""
    t = tframe.FrameDecompressor(skip_skippable, device=CPU)
    j = jframe.FrameDecompressor(skip_skippable=skip_skippable)
    pos, out = 0, []
    while pos < len(frame) and not j.finished:
        piece = frame[pos:pos + next(steps)]
        got, want = outcome(t.feed, piece), outcome(j.feed, piece)
        assert got == want, (pos, got[:1], want[:1], got[-1:], want[-1:])
        if got[0] == "error":
            return got
        assert (t.src_hint, t.finished, info_of(t)) == \
            (j.src_hint, j.finished, info_of(j)), pos
        pos += got[1][0]
        out.append(got[1][1])
    return b"".join(out)


def random_steps(seed: int, hi: int):
    rng = random.Random(seed)
    while True:
        yield rng.randint(1, hi)


def ones():
    while True:
        yield 1


def test_frame_header_helpers_match_lz4_tpu():
    for kw in (dict(), dict(content_size=len(DATA), content_checksum=True),
               dict(block_size_id=5, block_independent=True)):
        frame = jframe.compress_frame(DATA, jprefs(**kw))
        for n in (0, 5, 6, 7, 15):
            assert tframe.header_size_hint(frame[:n]) == \
                jframe.header_size_hint(frame[:n])
        assert dataclasses.asdict(tframe.get_frame_info(frame[:15])) == \
            dataclasses.asdict(jframe.get_frame_info(frame[:15]))
    for size in (0, 1, 5_000, 300_000):
        for kw in (dict(), dict(block_size_id=4, block_checksum=True)):
            assert tframe.compress_frame_bound(size, tprefs(**kw)) == \
                jframe.compress_frame_bound(size, jprefs(**kw))
    assert tframe.make_skippable_frame(b"meta", 3) == \
        jframe.make_skippable_frame(b"meta", 3)


@pytest.mark.parametrize("kw", [
    dict(block_size_id=4), dict(block_size_id=4, block_independent=True),
    dict(block_size_id=5, content_checksum=True, content_size=300_000),
    dict(block_size_id=5, block_independent=True, block_checksum=True),
    dict(content_checksum=True), dict(block_size_id=6)])
def test_decompressor_in_random_slices_matches_lz4_tpu(kw):
    for frame in (jframe.compress_frame(DATA, jprefs(**kw)),
                  tframe.compress_frame(DATA, tprefs(**kw), device=CPU)):
        for seed, hi in ((1, 50_000), (2, 200_000), (3, 3_000)):
            assert lockstep(frame, random_steps(seed, hi)) == DATA


def test_decompressor_byte_by_byte_matches_lz4_tpu():
    for kw in (dict(block_size_id=4, content_checksum=True),
               dict(block_size_id=4, block_checksum=True,
                    content_size=len(SMALL))):
        frame = jframe.compress_frame(SMALL, jprefs(**kw))
        assert lockstep(frame, ones()) == SMALL
    # a linked frame whose blocks were flushed short (the window spans them)
    c = jframe.FrameCompressor(jprefs(block_size_id=4))
    frame = c.begin()
    for i in range(0, 3_500, 700):
        frame += c.update(SMALL[i:i + 700]) + c.flush()
    frame += c.end()
    assert lockstep(frame, ones()) == SMALL[:3_500]


def test_decompressor_on_the_fixtures_matches_lz4_tpu():
    for name in ("default.lz4", "hc9_b5_linked.lz4", "b4_content_size.lz4",
                 "golden_sg_16x4k.lz4"):
        frame = (FX / name).read_bytes()
        want, _ = jframe.decompress_frame(frame)
        for seed, hi in ((4, 7_000), (5, 100_000)):
            assert lockstep(frame, random_steps(seed, hi)) == want
        assert tframe.decompress_frame(frame, device=CPU) == \
            jframe.decompress_frame(frame)
    legacy = (FX / "legacy.lz4").read_bytes()
    assert tframe.decompress_legacy(legacy, device=CPU) == \
        jframe.decompress_legacy(legacy)


def test_stored_blocks_and_noise_match_lz4_tpu():
    noise = incompressible(200_000)
    for kw in (dict(block_size_id=4), dict(block_size_id=5,
                                          block_independent=True)):
        frame = tframe.compress_frame(noise, tprefs(**kw), device=CPU)
        assert len(frame) < len(noise) + 4 * (len(noise) // 65536 + 2) + 32
        assert lockstep(frame, random_steps(6, 90_000)) == noise
        assert jframe.decompress_frame(frame) == (noise, len(frame))
    mixed = DATA[:100_000] + noise[:70_000] + DATA[100_000:200_000]
    frame = jframe.compress_frame(mixed, jprefs(block_size_id=4))
    assert lockstep(frame, random_steps(7, 150_000)) == mixed


def corrupt(frame: bytes, at: int, xor: int = 0xFF) -> bytes:
    b = bytearray(frame)
    b[at] ^= xor
    return bytes(b)


def first_block(frame: bytes):
    """(offset of the first block's payload, its size) in a frame."""
    info = jframe.get_frame_info(frame[:15])
    size = struct.unpack_from("<I", frame, info.header_size)[0]
    return info.header_size + 4, size & 0x7FFFFFFF


def test_errors_come_in_the_same_call():
    frames = {}
    f = jframe.compress_frame(SMALL, jprefs())
    frames["header checksum"] = corrupt(f, 6)
    frames["bad magic"] = corrupt(f, 0)
    frames["reserved bits"] = corrupt(f, 4, 0x01)
    f = jframe.compress_frame(DATA, jprefs(block_size_id=4,
                                           content_checksum=True))
    frames["content checksum"] = corrupt(f, len(f) - 1)
    frames["truncated"] = f[:len(f) // 2]
    f = bytearray(jframe.compress_frame(SMALL, jprefs(
        content_size=len(SMALL))))
    struct.pack_into("<Q", f, 6, len(SMALL) + 1)
    f[14] = (xxh32(bytes(f[4:14]), 0) >> 8) & 0xFF
    frames["content size"] = bytes(f)
    f = jframe.compress_frame(DATA, jprefs(block_size_id=4,
                                           block_checksum=True))
    at, size = first_block(f)
    frames["block checksum"] = corrupt(f, at + size // 2)
    for kw in (dict(block_size_id=4), dict(block_size_id=4,
                                           block_independent=True)):
        f = jframe.compress_frame(DATA, jprefs(**kw))
        at, size = first_block(f)
        head = jframe.encode_frame_header(jprefs(**kw))
        first, good = [lz4_seq(SMALL[:1_000])], [f[at:at + size]]
        for name, bad in (
                ("offset past the window",
                 lz4_seq(b"ab", 5_000, 20) + lz4_seq(b"tail!")),
                ("offset 0", b"\x20ab\x00\x00" + lz4_seq(b"tail!")),
                ("a cut block", lz4_seq(b"ab", 2, 20)),
                ("output past the block", lz4_seq(b"ab", 2, 70_000)
                 + lz4_seq(b"tail!"))):
            frames[f"{name} {kw}"] = head + b"".join(
                struct.pack("<I", len(p)) + p
                for p in first + [bad] + good) + b"\0\0\0\0"
        frames[f"a block over its maximum {kw}"] = (
            f[:at - 4] + struct.pack("<I", 70_000) + f[at:])
        frames[f"bit flips {kw}"] = corrupt(corrupt(f, at + 100, 0x10),
                                            at + 2_000, 0x01)
    for what, frame in frames.items():
        for steps in (random_steps(8, 120_000), random_steps(9, 9_000),
                      iter([len(frame)] * 2)):
            got = lockstep(frame, steps)
            # a truncated frame raises only where the caller sees that the
            # input ended (decompress_frame, below)
            assert got[0] == "error" or what == "truncated" or \
                what.startswith("bit flips"), what
        assert outcome(tframe.decompress_frame, frame, CPU) == \
            outcome(jframe.decompress_frame, frame), what


def test_independent_blocks_reach_before_no_block():
    """A block of an independent frame whose match reaches before the
    block's start: lz4_tpu's error and message at every block size (kernel
    D's batch route at 64 KB, kernel E's past it), fed whole and in
    slices."""
    payloads = [block_np.compress_block(b"abcdefgh" * 4000),
                b"\x00\x01\x00" + lz4_seq(b"tail!")]
    for bsid in (4, 5, 6, 7):
        frame = jframe.encode_frame_header(jprefs(
            block_size_id=bsid, block_independent=True)) + b"".join(
                struct.pack("<I", len(p)) + p for p in payloads) + \
            b"\0\0\0\0"
        want = ("error", "block decode failed: offset beyond window")
        assert outcome(jframe.decompress_frame, frame) == want
        assert outcome(tframe.decompress_frame, frame, CPU) == want, bsid
        for steps in (iter([len(frame)] * 2), random_steps(13, 9_000),
                      ones()):
            assert lockstep(frame, steps) == want, bsid


def test_skippable_and_concatenated_frames():
    f1 = tframe.compress_frame(SMALL, tprefs(), device=CPU)
    sk = tframe.make_skippable_frame(b"user-metadata" * 10, sub_id=3)
    f2 = jframe.compress_frame(DATA[:10_000], jprefs(content_checksum=True))
    empty = tframe.compress_frame(b"", tprefs(), device=CPU)
    stream = f1 + sk + empty + f2
    assert tframe.decompress_concatenated(stream, device=CPU) == \
        jframe.decompress_concatenated(stream) == SMALL + DATA[:10_000]
    assert tframe.decompress_concatenated(
        tframe.make_skippable_frame(b"") + f1, device=CPU) == SMALL
    # the decoder stops at the end of the first frame, as lz4_tpu's does
    assert lockstep(sk + f1 + f2, random_steps(10, 4_000)) == SMALL
    assert lockstep(sk + f1, ones(), skip_skippable=False)[0] == "error"


def boundaries(frame: bytes):
    """The decoded size and stored flag of every block of a frame, its
    header and its content checksum."""
    info = jframe.get_frame_info(frame[:15])
    pos, sizes = info.header_size, []
    while True:
        raw = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if raw == 0:
            break
        n = raw & 0x7FFFFFFF
        payload = frame[pos:pos + n]
        stored = bool(raw >> 31)
        sizes.append((n if stored else
                      block_np.get_decompressed_size(payload), stored))
        pos += n + 4 * info.block_checksum
    return frame[:info.header_size], sizes, frame[pos:]


def compress_both(data: bytes, kw: dict, step: int, flush_every=0):
    """Both packages' FrameCompressor over ``data`` in updates of
    ``step`` bytes, with flush() after every ``flush_every``-th update."""
    out = []
    for comp in (tframe.FrameCompressor(tprefs(**kw), device=CPU),
                 jframe.FrameCompressor(jprefs(**kw))):
        parts = [comp.begin()]
        for k, i in enumerate(range(0, len(data), step)):
            parts.append(comp.update(data[i:i + step]))
            if flush_every and k % flush_every == flush_every - 1:
                parts.append(comp.flush())
        parts.append(comp.end())
        out.append(b"".join(parts))
    return out


@pytest.mark.parametrize("bsid", [4, 5, 6, 7])
@pytest.mark.parametrize("indep", [False, True])
def test_compressor_matrix_keeps_lz4_tpu_layout(bsid, indep):
    data = DATA
    for kw, step, flush_every in (
            (dict(), 100_000, 0),
            (dict(block_checksum=True, content_checksum=True,
                  content_size=len(data)), 77_777, 3),
            (dict(auto_flush=True, content_checksum=True), 150_001, 0)):
        kw = dict(kw, block_size_id=bsid, block_independent=indep)
        port, host = compress_both(data, kw, step, flush_every)
        assert jframe.decompress_frame(port) == (data, len(port))
        ph, pb, pt = boundaries(port)
        hh, hb, ht = boundaries(host)
        assert ph == hh and pt == ht
        assert [n for n, _ in pb] == [n for n, _ in hb]
        if flush_every:
            assert lockstep(port, random_steps(bsid, 64_000)) == data
    frame = tframe.compress_frame(data, tprefs(block_size_id=bsid,
                                               block_independent=indep),
                                  device=CPU)
    assert frame[:7] == jframe.compress_frame(
        data, jprefs(block_size_id=bsid, block_independent=indep))[:7]
    assert jframe.decompress_frame(frame)[0] == data


def test_compressor_state_and_errors_match_lz4_tpu():
    c = tframe.FrameCompressor(tprefs(content_size=10), device=CPU)
    with pytest.raises(tframe.Lz4FrameError, match="outside begin"):
        c.update(b"x")
    c.begin()
    with pytest.raises(tframe.Lz4FrameError, match="twice"):
        c.begin()
    c.update(b"abc")
    with pytest.raises(tframe.Lz4FrameError, match="content size mismatch"):
        c.end()
    with pytest.raises(tframe.Lz4FrameError, match="does not match"):
        tframe.compress_frame(b"abc", tprefs(content_size=4), device=CPU)
    assert tframe.compress_frame(b"", tprefs(content_checksum=True),
                                 device=CPU) == \
        jframe.compress_frame(b"", jprefs(content_checksum=True))


@pytest.mark.parametrize("indep", [False, True])
def test_compressor_moves_no_state_when_a_call_raises(monkeypatch, indep):
    """A call whose block work raises leaves the compressor as it was, so
    the caller may retry it: the frame then equals one made without the
    raise, for ``update``, ``flush`` and ``end``."""
    prefs = tprefs(block_size_id=4, block_independent=indep,
                   content_checksum=True, block_checksum=True)
    want = compress_both(DATA, prefs.__dict__, 70_000, 2)[0]
    fail = {"left": 0}
    real = {name: getattr(tdevice, name) for name in ("chain_payloads",
                                                      "encode_blocks")}

    def flaky(name):
        def call(*args, **kwargs):
            if fail["left"]:
                fail["left"] -= 1
                raise RuntimeError("injected")
            return real[name](*args, **kwargs)
        return call
    for name in real:
        monkeypatch.setattr(tdevice, name, flaky(name))

    raised = []

    def retried(fn, *args):
        """``fn`` with its first block-work call failing (a call with no
        block to code runs through)."""
        fail["left"] = 1
        try:
            return fn(*args)
        except RuntimeError:
            raised.append(fn.__name__)
            return fn(*args)
        finally:
            fail["left"] = 0
    comp = tframe.FrameCompressor(prefs, device=CPU)
    parts = [comp.begin()]
    for k, i in enumerate(range(0, len(DATA), 70_000)):
        parts.append(retried(comp.update, DATA[i:i + 70_000]))
        if k % 2 == 1:
            parts.append(retried(comp.flush))
    parts.append(retried(comp.end))
    assert b"".join(parts) == want
    assert raised == ["update", "update", "flush"] * 2 + ["end"], raised


def test_hc_frames_link_their_blocks_and_decode():
    """At level 3 and up a linked request stays linked, without a warning:
    each block's first 64 KB piece sits behind the window of the blocks
    before it, as lz4_tpu's host HC links them."""
    data = real_text_corpus(150_000)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        frame = tframe.compress_frame(data, tprefs(block_size_id=4, level=9),
                                      device=CPU)
    assert not tframe.get_frame_info(frame).block_independent
    assert jframe.decompress_frame(frame)[0] == data
    assert lockstep(frame, random_steps(12, 30_000)) == data
    host = jframe.compress_frame(data, jprefs(block_size_id=4, level=9))
    assert len(frame) <= RATIO_BOUND * len(host), (len(frame), len(host))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        frame = tframe.compress_frame(data, tprefs(
            block_size_id=5, block_independent=True, level=3,
            block_checksum=True), device=CPU)
    assert jframe.decompress_frame(frame)[0] == data
    assert lockstep(frame, random_steps(11, 30_000)) == data


def test_legacy_wrappers_round_trip_through_lz4_tpu():
    for data in (b"", SMALL, DATA):
        leg = tframe.compress_legacy(data, device=CPU)
        assert jframe.decompress_legacy(leg) == (data, len(leg))
        assert tframe.decompress_legacy(leg, device=CPU) == (data, len(leg))
        jleg = jframe.compress_legacy(data)
        assert tframe.decompress_legacy(jleg, device=CPU) == \
            (data, len(jleg))


@pytest.mark.parametrize("source", ["text", "gen_buffer"])
def test_frame_ratio_against_the_host_parse_is_bounded(source):
    data = real_text_corpus(300_000) if source == "text" \
        else gen_buffer(300_000, 0.7, 9)
    for kw in (dict(block_size_id=4), dict(block_size_id=4,
                                           block_independent=True),
               dict(block_size_id=5)):
        port = tframe.compress_frame(data, tprefs(**kw), device=CPU)
        host = jframe.compress_frame(data, jprefs(**kw))
        assert len(port) <= RATIO_BOUND * len(host), (kw, len(port),
                                                      len(host))


def test_decompress_frame_equals_the_one_shot_route():
    for kw in (dict(block_size_id=4), dict(block_size_id=5,
                                           block_independent=True,
                                           content_checksum=True)):
        frame = tframe.compress_frame(DATA, tprefs(**kw), device=CPU)
        assert tframe.decompress_frame(frame, device=CPU) == \
            tdevice.decompress_frame_device(frame, device=CPU)


def test_feeds_take_kernel_d_and_fall_back_to_kernel_e():
    """The route of a feed's blocks: 64 KB blocks through kernel D (batch
    mode, or linked mode behind the window, as smoke step 15 measured it
    faster than E), larger blocks through kernel E; a linked feed with a
    short block before its last goes to E again."""
    def kernels(frame):
        common.reset_counts()
        assert tframe.decompress_frame(frame, device=CPU)[0] == DATA
        return dict(common.PLAIN_CALLS)

    for kw, want in ((dict(block_size_id=4), {"decode_linked": 1}),
                     (dict(block_size_id=4, block_independent=True),
                      {"decode_batch": 1}),
                     (dict(block_size_id=5), {"decode_stream": 1}),
                     (dict(block_size_id=5, block_independent=True),
                      {"decode_stream": 1})):
        assert kernels(tframe.compress_frame(DATA, tprefs(**kw),
                                             device=CPU)) == want
    c = tframe.FrameCompressor(tprefs(block_size_id=4), device=CPU)
    frame = c.begin() + c.update(DATA[:100_000]) + c.flush() + \
        c.update(DATA[100_000:]) + c.end()
    assert kernels(frame) == {"decode_linked": 1, "decode_stream": 1}


def test_frame_api_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for fn in (tframe.FrameCompressor, tframe.FrameDecompressor,
               lambda: tframe.decompress_frame(SMALL),
               lambda: tframe.compress_frame(SMALL),
               lambda: tframe.compress_legacy(SMALL)):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
