"""Independent frame blocks over kernel B's 256 KB rows (``lz4 -1`` writes
4 MB blocks by default), on the CPU through the kernels' plain versions.

``device.compress_frame_device`` codes such blocks through
``device.chain_records``: each block one chain of kernel A's 64 KB pieces
without a prefix, its payloads joined on the host, stored where the join
does not shrink.  ``frame.FrameCompressor`` takes the same route.  The
frames decode through the port (kernel E's plain version) and through
``lz4_tpu``'s host decoder; tolerance 0 on bytes.
"""

import struct

import numpy as np
import pytest

from codecbench.traffic.stdlib_text import stdlib_texts
from lz4_tpu import frame as jframe
from lz4_tpu_torch import device, frame, spec
from lz4_tpu_torch.frame import FramePreferences
from lz4_tpu_torch.kernels.encode_kernel import MAX_BLOCK
from lz4_tpu_torch.legacy import merge_payloads

CPU = "cpu"
MB = 1 << 20


def text_and_noise(seed: int, parts) -> bytes:
    """Stdlib text in a file order drawn from ``seed``, and seeded noise:
    ``parts`` is a list of ("text" or "noise", length)."""
    rng = np.random.default_rng([seed, 22])
    texts = stdlib_texts()
    corpus = b"".join(texts[i] for i in rng.permutation(len(texts)))
    out, at = [], 0
    for kind, n in parts:
        if kind == "noise":
            out.append(rng.bytes(n))
        else:
            out.append(corpus[at:at + n])
            at += n
    return b"".join(out)


# id -> (block size, content: whole text blocks, a noise block, a short
# last block)
LAYOUTS = {
    7: (4 * MB, [("text", 4 * MB), ("noise", 150_000)]),
    6: (MB, [("text", MB), ("noise", MB), ("text", 100_000)]),
}


def prefs(bsid: int, **kw):
    return FramePreferences(block_size_id=bsid, block_independent=True,
                            content_checksum=True, **kw)


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def case(request):
    """(block size id, block size, object, its frame)."""
    bsid = request.param
    bs, parts = LAYOUTS[bsid]
    data = text_and_noise(bsid, parts)
    return bsid, bs, data, device.compress_frame_device(
        data, prefs(bsid), block_size=bs, device=CPU)


def records(frame_bytes: bytes):
    """The frame's block records: (payload offset, size, stored)."""
    info = device.decode_frame_header(frame_bytes)
    starts, sizes, stored, _ = device._read_blocks(
        frame_bytes, info.header_size, info)
    return list(zip(starts, sizes, stored))


def test_blocks_hold_block_size_bytes_and_noise_is_stored(case):
    bsid, bs, data, out = case
    assert bs > MAX_BLOCK
    recs = records(out)
    assert len(recs) == -(-len(data) // bs)
    for k, (_, size, stored) in enumerate(recs):
        block = data[k * bs:(k + 1) * bs]
        if k == 1:                       # the noise block
            assert stored and size == len(block)
        else:
            assert not stored and size < len(block)


def test_decompress_gives_back_the_object_and_the_length(case):
    _, _, data, out = case
    assert device.decompress_frame_device(out + b"tail", device=CPU) == \
        (data, len(out))
    assert jframe.decompress_frame(out) == (data, len(out))


def test_long_blocks_beat_64k_blocks(case):
    bsid, _, data, out = case
    small = device.compress_frame_device(data, prefs(4), device=CPU)
    assert len(out) < len(small)


@pytest.mark.parametrize("bs", [1 << 16, MAX_BLOCK])
def test_kernel_b_still_writes_blocks_up_to_its_rows(bs):
    """``block_size`` up to 256 KB: kernel B's rows, packed by kernel C,
    exactly as before the long-block route."""
    data = text_and_noise(5, [("text", 300_000), ("noise", 70_000)])
    p = prefs(5, block_checksum=True)
    rows, lens = device.byte_rows(device._split_blocks(data, bs), bs,
                                  device.resolve_device(CPU))
    out, olen = device.encode_blocks(rows, lens, 1)
    flat, total, _ = device.pack_frame_payloads(out, olen, rows, lens)
    want = device._frame(p, data, device._fetch_body(flat, total, True))
    assert device.compress_frame_device(data, p, block_size=bs,
                                        device=CPU) == want


def old_records(data: bytes, bs: int, groups, block_checksum: bool) -> bytes:
    """Block records as ``FrameCompressor`` wrote them before it shared the
    long-block route: each block joined, then stored where not smaller."""
    out = []
    for i, (views, tails) in enumerate(groups):
        payload, block = merge_payloads(views, tails), data[i * bs:(i + 1)
                                                             * bs]
        if len(payload) >= len(block):
            parts = [struct.pack("<I", len(block) | spec.UNCOMPRESSED_BIT),
                     block]
        else:
            parts = [struct.pack("<I", len(payload)), payload]
        if block_checksum:
            parts.append(struct.pack("<I", device.xxh32(parts[1], 0)))
        out.append(b"".join(parts))
    return b"".join(out)


@pytest.mark.parametrize("bsid, indep, level, scale", [
    (6, True, 0, 10), (5, False, 0, 10), (4, True, 9, 1)])
def test_frame_compressor_keeps_its_bytes(bsid, indep, level, scale):
    """``FrameCompressor`` over the shared route writes what it wrote with
    its own copy: two updates, block checksums, the window carried (HC's
    plain kernel on a tenth of the bytes)."""
    data = text_and_noise(bsid, [("text", 40_000 * scale),
                                 ("noise", 30_000 * scale),
                                 ("text", 60_000 * scale)])
    p = FramePreferences(block_size_id=bsid, block_independent=indep,
                         block_checksum=True, content_checksum=True,
                         level=level)
    bs = spec.BLOCK_SIZES[bsid]
    comp = frame.FrameCompressor(p, device=CPU)
    got = comp.begin() + comp.update(data[:bs + 5]) + comp.update(
        data[bs + 5:]) + comp.end()
    # what the compressor codes: the first update's whole block, the
    # second's whole blocks, then the remainder at end()
    rest = data[bs:]
    whole = len(rest) // bs * bs
    chunks = [c for c in (data[:bs], rest[:whole], rest[whole:]) if c]
    want = [frame.encode_frame_header(p)]
    window = None
    dev = device.resolve_device(CPU)
    for chunk in chunks:
        if level:
            groups, window = frame._hc().hc_payloads(chunk, bs, window,
                                                     not indep, level, dev)
        else:
            groups, window = device.chain_payloads(chunk, bs, window,
                                                   not indep, 1, 4, dev)
        want.append(old_records(chunk, bs, groups, True))
        window = None if indep else window
    want += [struct.pack("<I", 0), struct.pack("<I", device.xxh32(data, 0))]
    assert got == b"".join(want)


def test_frame_compressor_and_the_one_shot_route_agree():
    bs, parts = LAYOUTS[6]
    data = text_and_noise(6, parts)
    assert frame.compress_frame(data, prefs(6), device=CPU) == \
        device.compress_frame_device(data, prefs(6), block_size=bs,
                                     device=CPU)
