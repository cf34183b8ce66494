"""The landing of decoded content (``device._Landing``) on the CPU.

``decompress_frame_device`` fetches kernel D's decoded rows, and
``decode_stream_runs`` kernel E's decoded runs, into one host buffer and
copies the content out of it once.  Each layout below
round-trips to content byte-equal to its input, as ``bytes``: stored
blocks between compressed ones, a short block before the last of an
independent frame, one block, no block, a linked chain with stored blocks
in groups of 2, and a linked chain that falls back to kernel E.  A block
the kernel rejects raises, naming that block, and the next call is right.
The card's path (a pinned buffer, runs copied into it at their offsets,
one wait) is driven here on a plain host tensor with the stream stubbed:
for kernel D's rows, for a ``-B7`` frame through kernel E, and for kernel
E's runs across cuts, linked and independent.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4_tpu_torch import device, trace
from lz4_tpu_torch.frame import (FrameCompressor, FramePreferences,
                                 Lz4FrameError, decode_frame_header,
                                 encode_frame_header)
from lz4_tpu_torch.kernels import decode_kernel

CPU = "cpu"
W = 65536
TEXT = (Path(__file__).resolve().parent.parent / "README.md").read_bytes()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small tensor ops; one intra-op thread
    keeps test workers side by side from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def text(n: int, shift: int = 0) -> bytes:
    data = TEXT[shift:] + TEXT[:shift]
    return (data * (n // len(data) + 1))[:n]


def noise(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def stored_between(n_noise: int = 2 * W) -> bytes:
    """Text, a stretch of noise (stored blocks), then text again."""
    return text(100_000) + noise(n_noise, 3) + text(150_000, 7)


def blocks_of(frame: bytes):
    """(payload sizes, stored flags) of the frame's block records."""
    info = decode_frame_header(frame)
    _, sizes, stored, _ = device._read_blocks(frame, info.header_size, info)
    return sizes, stored


def decoded(frame: bytes):
    """(content, the change of COUNTS over the call)."""
    trace.reset_counts()
    content, used = device.decompress_frame_device(frame, device=CPU)
    assert used == len(frame)
    assert type(content) is bytes
    return content, dict(trace.COUNTS)


def independent_frame(pieces, checksum: bool = True,
                      block_size_id: int = 4) -> bytes:
    """An independent frame written by hand, one block per piece (64 KB
    blocks, or larger ones with pieces up to kernel B's 256 KB rows),
    compressed by kernel B's plain version, or stored where that is not
    smaller."""
    prefs = FramePreferences(block_size_id=block_size_id,
                             block_independent=True,
                             content_checksum=checksum)
    rows, lens = device.encode_batch(list(pieces), max(W, *map(len, pieces)),
                                     device=CPU)
    body = b"".join(
        struct.pack("<I", int(n)) + rows[i, :n].tobytes() if n < len(p)
        else struct.pack("<I", len(p) | 0x80000000) + p
        for i, (p, n) in enumerate(zip(pieces, lens)))
    frame = encode_frame_header(prefs) + body + struct.pack("<I", 0)
    if checksum:
        frame += struct.pack("<I", device.xxh32(b"".join(pieces), 0))
    return frame


def test_hc9_frame_with_stored_blocks_between_compressed_ones():
    data = stored_between()
    frame = device.compress_frame_device_hc(data, FramePreferences(
        block_size_id=4, block_independent=True, content_checksum=True),
        level=9, device=CPU)
    sizes, stored = blocks_of(frame)
    assert any(stored[1:-1]) and not stored[0] and not stored[-1]
    content, counts = decoded(frame)
    assert content == data
    compressed = sum(n for n, st in zip(sizes, stored) if not st)
    # payload slices and their rows, then the one copy out
    assert counts["host_copy_bytes"] == 2 * compressed + len(data)
    stored_bytes = sum(n for n, st in zip(sizes, stored) if st)
    assert counts["pinned_d2h_bytes"] == len(data) - stored_bytes


def test_independent_frame_with_a_short_block_before_the_last():
    pieces = [text(W), text(1000, 5), text(W, 9), text(W, 11),
              text(5000, 13)]
    frame = independent_frame(pieces)
    content, counts = decoded(frame)
    assert content == b"".join(pieces)
    assert counts["pinned_d2h_bytes"] == len(content)


def test_a_one_block_frame():
    data = text(40_000)
    for prefs in (FramePreferences(block_size_id=4, block_independent=True),
                  FramePreferences(block_size_id=4)):
        frame = device.compress_frame_device(data, prefs, device=CPU)
        assert len(blocks_of(frame)[0]) == 1
        content, counts = decoded(frame)
        assert content == data
        assert counts["pinned_d2h_bytes"] == len(data)


def test_empty_content():
    for prefs in (FramePreferences(block_size_id=4, block_independent=True,
                                   content_checksum=True),
                  FramePreferences(block_size_id=4)):
        frame = device.compress_frame_device(b"", prefs, device=CPU)
        content, counts = decoded(frame)
        assert content == b""
        assert counts["pinned_d2h_bytes"] == counts["syncs"] == 0


def test_only_stored_blocks():
    data = noise(2 * W + 100, 8)
    frame = device.compress_frame_device(data, FramePreferences(
        block_size_id=4, block_independent=True), device=CPU)
    assert all(blocks_of(frame)[1])
    content, counts = decoded(frame)
    assert content == data
    assert counts["pinned_d2h_bytes"] == counts["d2h_bytes"] == 0
    assert counts["host_copy_bytes"] == len(data)


def test_linked_chain_with_stored_blocks_in_groups_of_two(monkeypatch):
    monkeypatch.setattr(device, "DEC_GROUP_BLOCKS", 2)
    data = stored_between(3 * W) + text(20_000, 3)
    frame = device.compress_frame_device(data, FramePreferences(
        block_size_id=4, content_checksum=True), device=CPU)
    sizes, stored = blocks_of(frame)
    assert any(stored) and len(sizes) > 4
    content, counts = decoded(frame)
    assert content == data
    assert counts["pinned_d2h_bytes"] == len(data)


def test_linked_chain_that_falls_back_to_kernel_e(monkeypatch):
    monkeypatch.setattr(device, "DEC_GROUP_BLOCKS", 2)
    seg = text(W + 30_000, 17)
    c = device.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                     device=CPU)
    frame = c.begin() + c.update(seg) + c.flush() + c.update(seg) + c.end()
    content, counts = decoded(frame)
    assert content == seg + seg
    # the first group ends in the short block, so nothing of kernel D's
    # lands; kernel E's run lands the whole content
    assert counts["pinned_d2h_bytes"] == len(content)


def corrupt(frame: bytes, block: int) -> bytes:
    """``frame`` with block ``block``'s payload zeroed (a zero offset)."""
    out = bytearray(frame)
    pos = decode_frame_header(frame).header_size
    for _ in range(block):
        pos += 4 + (struct.unpack_from("<I", out, pos)[0] & 0x7FFFFFFF)
    raw = struct.unpack_from("<I", out, pos)[0]
    assert not raw & 0x80000000          # a compressed block
    out[pos + 4:pos + 4 + raw] = bytes(raw)
    return bytes(out)


@pytest.mark.parametrize("independent", [True, False])
def test_a_rejected_block_is_named_and_the_next_call_is_right(independent):
    data = stored_between()
    prefs = FramePreferences(block_size_id=4,
                             block_independent=independent)
    frame = device.compress_frame_device(data, prefs, device=CPU)
    _, stored = blocks_of(frame)
    bad = max(i for i, st in enumerate(stored) if not st)
    assert any(stored[:bad])             # named by its place in the frame
    with pytest.raises(Lz4FrameError, match=f"block {bad}$"):
        device.decompress_frame_device(corrupt(frame, bad), device=CPU)
    assert decoded(frame)[0] == data


class _Stream:
    def synchronize(self):
        _Stream.waits += 1


@pytest.fixture
def pinned(monkeypatch):
    """The card's route on the CPU: every landing gets a plain host tensor
    as its pinned buffer (listed, in order), and the stream's waits are
    counted in ``_Stream.waits``."""
    made = []
    init = device._Landing.__init__

    def fake_init(self, size, dev):
        init(self, size, dev)
        if size > 0:
            self.pinned = torch.empty((size,), dtype=torch.uint8)
            made.append(self.pinned)

    monkeypatch.setattr(device._Landing, "__init__", fake_init)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    _Stream.waits = 0
    return made


def test_the_card_path_lands_runs_at_their_offsets(pinned):
    """The pinned route on a plain host tensor: each run of rows copied to
    its place in one buffer, one wait, one copy out that never aliases the
    buffer."""
    made = pinned
    pieces = [text(W), text(W, 3), text(700, 4), noise(W, 5), text(W, 6),
              text(2000, 8)]
    frame = independent_frame(pieces)
    assert blocks_of(frame)[1] == [False, False, False, True, False, False]
    content, counts = decoded(frame)
    want = b"".join(pieces)
    assert content == want and _Stream.waits == 1
    assert counts["pinned_d2h_bytes"] == len(want) - W
    # the landing holds the decoded blocks back to back
    assert made[-1].numpy().tobytes() == \
        want[:2 * W + 700] + want[3 * W + 700:]
    made[-1].zero_()
    assert content == want


def test_kernel_e_lands_a_b7_frame_on_the_card_path(pinned):
    """A ``-B7`` independent frame, a stored block between compressed
    ones, through kernel E: the run's bytes fetched into one buffer no
    larger than the sum of the caps, one wait, one copy out."""
    bs = 4 << 20
    pieces = [text(200_000), text(150_000, 3), noise(W, 5),
              text(180_000, 6), text(5000, 8)]
    frame = independent_frame(pieces, block_size_id=7)
    sizes, stored = blocks_of(frame)
    assert stored == [False, False, True, False, False]
    content, counts = decoded(frame)
    want = b"".join(pieces)
    assert content == want and _Stream.waits == 1
    assert counts["pinned_d2h_bytes"] == len(want)
    assert counts["host_copy_bytes"] == len(want)
    (buf,) = pinned
    assert buf.numel() <= sum(n if st else bs
                              for n, st in zip(sizes, stored))
    assert buf[:len(want)].numpy().tobytes() == want
    buf.zero_()
    assert content == want


def chain_of_runs(linked: bool):
    """A ``-B5`` frame of six 256 KB blocks (linked or independent): text,
    stored noise, text, a block zeroed so that the kernel rejects it, text,
    and a short last block.  Returns (frame, starts, sizes, stored)."""
    bs = 256 * 1024
    data = (text(bs) + noise(bs, 4) + text(bs, 5) + text(bs, 9)
            + text(bs, 11) + text(100_000, 13))
    c = FrameCompressor(FramePreferences(block_size_id=5,
                                         block_independent=not linked),
                        device=CPU)
    frame = corrupt(c.begin() + c.update(data) + c.end(), 3)
    info = decode_frame_header(frame)
    starts, sizes, stored, _ = device._read_blocks(frame, info.header_size,
                                                   info)
    assert stored == [False, True, False, False, False, False]
    return frame, starts, sizes, stored


@pytest.mark.parametrize("linked", [False, True])
def test_kernel_e_runs_land_at_their_offsets_across_cuts(linked, pinned,
                                                          monkeypatch):
    """``decode_stream_runs`` over runs of two blocks (the output bound of
    a run patched down) on the card's route gives the bytes and olen of
    one ``decode_stream_raw`` call, with a rejected and a stored block
    among the runs; in linked mode each run starts behind the 64 KB
    fetched from the run before it, also after a run whose last block
    failed."""
    bs = 256 * 1024
    frame, starts, sizes, stored = chain_of_runs(linked)
    caps = [n if st else bs for n, st in zip(sizes, stored)]
    out, olen = decode_kernel.decode_stream_raw(
        torch.frombuffer(bytearray(frame), dtype=torch.uint8), starts, sizes,
        stored, bs, 0, linked, out_caps=caps)
    want = out[:int(olen[olen > 0].sum())].numpy().tobytes()
    lead = W if linked else 0
    monkeypatch.setattr(device, "RUN_MAX_OUTPUT", lead + 2 * bs)
    assert device._runs(starts, sizes, caps, lead) == [0, 2, 4, 6]
    trace.reset_counts()
    got, g_olen = device.decode_stream_runs(frame, starts, sizes, stored,
                                            caps, bs, linked,
                                            torch.device(CPU))
    assert g_olen.tolist() == olen.tolist() and -1 in g_olen.tolist()
    assert got == want and _Stream.waits == 1
    assert trace.COUNTS["pinned_d2h_bytes"] == len(want)
    (buf,) = pinned
    assert buf.numel() <= sum(caps)
    assert buf[:len(want)].numpy().tobytes() == want
    buf.zero_()
    assert got == want
