"""The port's frame pipeline (lz4_tpu_torch.device) held against lz4_tpu.tpu.

Frames must be byte-identical for the same input and settings, each package
must decode the other's frames, and corrupt frames must raise (the port has
no host codec to fall back to).  The port runs its
kernels' plain versions (device="cpu"); the JAX side runs interpret mode.
"""

import dataclasses

import pytest

from lz4_tpu import tpu as jtpu
from lz4_tpu.frame import FrameCompressor
from lz4_tpu.frame import FramePreferences as JaxPrefs
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import device as tdev
from lz4_tpu_torch.frame import FramePreferences, Lz4FrameError
from lz4_tpu_torch.kernels import common

from .test_torch_kernels import mixed_stream

W = 65536
CPU = "cpu"


def _prefs(**kw):
    jp = JaxPrefs(**kw)
    return jp, FramePreferences.from_fields(**dataclasses.asdict(jp))


CASES = {
    "linked_8_blocks": (8 * W + 3333, dict(block_size_id=4), 8),
    "linked_checksums": (3 * W + 100, dict(block_size_id=4,
                                           content_checksum=True,
                                           block_checksum=True), 4),
    "small_64k": (60_000, dict(block_size_id=4), 4),
    "independent": (3 * W + 5000, dict(block_size_id=4,
                                       block_independent=True), 4),
    "independent_checksums": (2 * W + 77, dict(block_size_id=4,
                                               block_independent=True,
                                               content_checksum=True,
                                               block_checksum=True,
                                               content_size=2 * W + 77), 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_frame_device_matches_jax(case):
    n, kw, mm = CASES[case]
    data = mixed_stream(n, 17)
    jp, tp = _prefs(**kw)
    want = jtpu.compress_frame_device(data, jp, min_match=mm)
    got = tdev.compress_frame_device(data, tp, min_match=mm, device=CPU)
    assert got == want
    out, used = tdev.decompress_frame_device(got, device=CPU)
    assert out == data and used == len(got)


def test_device_frame_compressor_matches_jax():
    data = mixed_stream(8 * W + 4321, 23)
    jp, tp = _prefs(block_size_id=4, content_checksum=True)
    jc = jtpu.DeviceFrameCompressor(jp, min_match=8)
    tc = tdev.DeviceFrameCompressor(tp, min_match=8, device=CPU)
    want, got = jc.begin(), tc.begin()
    for i in range(0, len(data), 3 * W):
        want += jc.update(data[i:i + 3 * W])
        got += tc.update(data[i:i + 3 * W])
    want += jc.end()
    got += tc.end()
    assert got == want
    assert tdev.decompress_frame_device(got, device=CPU)[0] == data


def test_each_package_decodes_the_others_frames():
    data = mixed_stream(5 * W + 999, 29)
    jp, tp = _prefs(block_size_id=4, content_checksum=True)
    jframe = jtpu.compress_frame_device(data, jp, min_match=4,
                                        acceleration=2)
    tframe = tdev.compress_frame_device(data, tp, min_match=4,
                                        acceleration=2, device=CPU)
    assert tdev.decompress_frame_device(jframe, device=CPU) == \
        (data, len(jframe))
    assert jtpu.decompress_frame_device(tframe) == (data, len(tframe))
    # a frame written by the host codec of lz4_tpu (its own parse)
    host = FrameCompressor(jp)
    hframe = host.begin() + host.update(data) + host.end()
    assert tdev.decompress_frame_device(hframe, device=CPU)[0] == data


def test_multigroup_window_handoff(monkeypatch):
    monkeypatch.setattr(jtpu, "DEC_GROUP_BLOCKS", 4)
    monkeypatch.setattr(tdev, "DEC_GROUP_BLOCKS", 4)
    data = mixed_stream(10 * W + 12345, 37)          # 11 blocks: 3 groups
    frame = tdev.compress_frame_device(
        data, FramePreferences(block_size_id=4, content_size=len(data)),
        device=CPU)
    assert tdev.decompress_frame_device(frame, device=CPU) == \
        jtpu.decompress_frame_device(frame) == (data, len(frame))


def test_stored_block_splice():
    data = (incompressible(2 * W) + gen_buffer(W, 0.5, 7)
            + incompressible(W // 2))
    jp, tp = _prefs(block_size_id=4)
    frame = tdev.compress_frame_device(data, tp, device=CPU)
    assert frame == jtpu.compress_frame_device(data, jp)
    assert tdev.decompress_frame_device(frame, device=CPU)[0] == data
    # the host codec's linked frame, with stored blocks inside the chain
    host = FrameCompressor(jp)
    hframe = host.begin() + host.update(data) + host.end()
    assert tdev.decompress_frame_device(hframe, device=CPU)[0] == data


def test_empty_input():
    jp, tp = _prefs(block_size_id=4, content_checksum=True)
    frame = tdev.compress_frame_device(b"", tp, device=CPU)
    assert frame == jtpu.compress_frame_device(b"", jp)
    assert tdev.decompress_frame_device(frame, device=CPU) == (b"",
                                                               len(frame))


def _linked_frame(data, prefs=None):
    return tdev.compress_frame_device(
        data, prefs or FramePreferences(block_size_id=4), device=CPU)


def test_payload_over_bound_raises_frame_error():
    """Reference fault #1: lz4_tpu raises numpy's ValueError here."""
    frame = bytearray(_linked_frame(mixed_stream(2 * W, 3)))
    hdr = 7
    size = 140_000          # > compress_bound(65536) and > lz4_tpu's 128 KB
    bad = (bytes(frame[:hdr]) + size.to_bytes(4, "little")
           + bytes(size) + (0).to_bytes(4, "little"))
    with pytest.raises(Lz4FrameError, match="compress_bound"):
        tdev.decompress_frame_device(bad, device=CPU)
    with pytest.raises(ValueError):
        jtpu.decompress_frame_device(bad)


def test_blocks_over_64k_decode_like_jax():
    """A frame of 256 KB blocks decodes through the stream kernel to
    lz4_tpu's bytes."""
    jp = JaxPrefs(block_size_id=5, block_independent=True)
    host = FrameCompressor(jp)
    data = mixed_stream(100_000, 5)
    frame = host.begin() + host.update(data) + host.end()
    assert tdev.decompress_frame_device(frame, device=CPU) == \
        jtpu.decompress_frame_device(frame) == (data, len(frame))


def test_flushed_short_block_decodes_through_stream_kernel(monkeypatch):
    """A linked chain with a flushed short block decodes to its input:
    kernel D finds the short block and kernel E decodes the chain again."""
    monkeypatch.setattr(tdev, "DEC_GROUP_BLOCKS", 2)
    seg = mixed_stream(W + 30_000, 8)
    c = tdev.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                   device=CPU)
    frame = c.begin() + c.update(seg) + c.flush() + c.update(seg) + c.end()
    common.reset_counts()
    assert tdev.decompress_frame_device(frame, device=CPU) == \
        (seg + seg, len(frame))
    assert common.PLAIN_CALLS["decode_linked"] >= 1
    assert common.PLAIN_CALLS["decode_stream"] == 1
    # the JAX package hands the same frame to its host codec
    assert jtpu.decompress_frame_device(frame)[0] == seg + seg


def test_flushed_chain_reports_a_corrupt_block_by_index():
    seg = mixed_stream(W + 30_000, 9)
    c = tdev.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                   device=CPU)
    frame = bytearray(c.begin() + c.update(seg) + c.flush() + c.update(seg)
                      + c.end())
    pos = 7
    for _ in range(2):                  # skip blocks 0 and 1 (the short one)
        pos += 4 + (int.from_bytes(frame[pos:pos + 4], "little")
                    & 0x7FFFFFFF)
    frame[pos + 4:pos + 8] = bytes(4)   # block 2: a zero offset
    with pytest.raises(Lz4FrameError, match="block 2"):
        tdev.decompress_frame_device(bytes(frame), device=CPU)


def test_corrupt_block_raises_frame_error_with_index():
    data = mixed_stream(3 * W, 12)
    frame = bytearray(_linked_frame(data))
    pos = 7
    for _ in range(2):                  # skip blocks 0 and 1
        pos += 4 + (int.from_bytes(frame[pos:pos + 4], "little")
                    & 0x7FFFFFFF)
    size = int.from_bytes(frame[pos:pos + 4], "little")
    assert size < W                      # a compressed block
    # all-zero tokens: a zero-length literal run, then offset 0
    frame[pos + 4:pos + 4 + size] = bytes(size)
    with pytest.raises(Lz4FrameError, match="block 2"):
        tdev.decompress_frame_device(bytes(frame), device=CPU)


def test_content_size_mismatch_raises_before_chunking(monkeypatch):
    """Reference fault #2: the chunked branch checks content_size too."""
    monkeypatch.setattr(tdev, "CHUNKED_ABOVE", 2 * W)
    _, tp = _prefs(block_size_id=4, content_size=5)
    with pytest.raises(Lz4FrameError, match="content_size"):
        tdev.compress_frame_device(mixed_stream(3 * W, 1), tp, device=CPU)


def test_compressor_keeps_in_flight_chunk_when_dispatch_fails(monkeypatch):
    """Reference fault #3: a failing update leaves the compressor intact."""
    data = mixed_stream(4 * W, 14)
    c = tdev.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                   device=CPU)
    frame = c.begin() + c.update(data[:2 * W])
    real = c._dispatch

    def failing(*args):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(c, "_dispatch", failing)
    with pytest.raises(RuntimeError):
        c.update(data[2 * W:])
    monkeypatch.setattr(c, "_dispatch", real)
    frame += c.update(data[2 * W:]) + c.end()
    assert tdev.decompress_frame_device(frame, device=CPU)[0] == data


@pytest.mark.parametrize("kw", [
    dict(block_size_id=4),
    dict(block_size_id=7, block_independent=True, content_checksum=True),
    dict(block_size_id=5, block_checksum=True, content_size=123456789),
])
def test_frame_header_matches_jax(kw):
    from lz4_tpu.frame import decode_frame_header as jdecode
    from lz4_tpu.frame import encode_frame_header as jencode
    from lz4_tpu_torch.frame import decode_frame_header, encode_frame_header
    jp, tp = _prefs(**kw)
    hdr = encode_frame_header(tp)
    assert hdr == jencode(jp)
    assert dataclasses.asdict(decode_frame_header(hdr + b"\0")) == \
        dataclasses.asdict(jdecode(hdr + b"\0"))


@pytest.mark.parametrize("mutate,match", [
    (lambda h: b"\0" + h[1:], "bad magic"),
    (lambda h: h[:4] + bytes([h[4] | 1]) + h[5:], "reserved FLG"),
    (lambda h: h[:5] + bytes([h[5] | 1]) + h[6:], "reserved BD"),
    (lambda h: h[:6] + bytes([h[6] ^ 1]), "header checksum"),
    (lambda h: h[:5], "too small"),
])
def test_frame_header_rejects_corruption(mutate, match):
    from lz4_tpu_torch.frame import decode_frame_header, encode_frame_header
    hdr = encode_frame_header(FramePreferences(block_size_id=4))
    with pytest.raises(Lz4FrameError, match=match):
        decode_frame_header(mutate(hdr))


def test_batch_codec_matches_jax():
    bufs = [mixed_stream(W, 2), mixed_stream(1000, 3), b"",
            incompressible(5000), gen_buffer(30_000, 0.8, 4)]
    j_rows, j_lens = jtpu.encode_batch(bufs, W, 1, 8)
    t_rows, t_lens = tdev.encode_batch(bufs, W, 1, 8, device=CPU)
    assert list(j_lens) == list(t_lens)
    comps = [t_rows[i, :n].tobytes() for i, n in enumerate(t_lens)]
    assert comps == [j_rows[i, :n].astype("u1").tobytes()
                     for i, n in enumerate(j_lens)]
    sizes = [len(b) for b in bufs]
    assert tdev.decode_batch(comps, W, device=CPU) == bufs
    assert tdev.decode_batch(comps, W, sizes, device=CPU) == \
        jtpu.decode_batch(comps, W, sizes) == bufs
    short = [max(n - 1, 0) for n in sizes]
    with pytest.raises(Lz4FrameError, match="block 0"):
        tdev.decode_batch(comps, W, short, device=CPU)


def test_encode_stream_linked_and_assembly_match_jax():
    data = mixed_stream(2 * W + 4000, 6)
    want = jtpu.encode_stream_linked(data, 1, 4, 1)
    got = tdev.encode_stream_linked(data, 1, 4, 1, device=CPU)
    assert got == want
    jp, tp = _prefs(block_size_id=4, block_checksum=True,
                    content_checksum=True)
    assert tdev.assemble_linked_frame(data, tp, *got) == \
        jtpu.assemble_linked_frame(data, jp, *want)
