"""LZ4F frames with every block coded on the device.

Counterpart of ``lz4_tpu/tpu.py``.  The host parses and writes the frame
container (a few bytes per 64 KB block); the kernels do the block work:

* compress: ``compress_frame_device`` -> the linked stream builder ->
  ``encode_blocks_linked`` (kernel A) -> ``pack_frame_payloads`` (kernel C);
  inputs over 8 MB go through ``DeviceFrameCompressor`` in 4 MB chunks, one
  chunk in flight, the 64 KB window carried on the device.  Inputs of 64 KB
  or less and block-independent frames take ``encode_blocks`` (kernel B),
  then kernel C.  Every frame body is packed on the device and fetched
  once; block checksums are inserted on the host while it is walked.
  Blocks over kernel B's 256 KB rows (the ``lz4`` CLI's default is 4 MB)
  take ``chain_records``: each block one chain of 64 KB pieces through
  kernel A without a prefix, 64 MiB of input a launch, its payloads joined
  into the block on the host (``join_block``), stored where the join does
  not shrink.
  ``compress_frame_device_hc`` writes independent 64 KB blocks through
  ``encode_blocks_hc`` (kernel I), then kernel C.
* decompress: ``decompress_frame_device`` -> ``decode_blocks_linked``
  (kernel D, linked mode) in groups of ``DEC_GROUP_BLOCKS`` blocks, the
  window handed from group to group on the device; independent frames of
  64 KB blocks take ``decode_blocks`` (kernel D, batch mode).  Frames of
  larger blocks (the ``lz4`` CLI writes 4 MB blocks by default) take
  ``decode_stream_raw`` (kernel E) over the raw frame, and so do legacy
  files (``decompress_legacy_device``, 8 MB blocks).  Every route fetches
  the decoded bytes into one pinned host buffer and copies the content
  out of it once (``_Landing``).  A linked chain with a short non-final
  block (``DeviceFrameCompressor.flush`` writes those) is
  legal LZ4F but outside kernel D's one-block window: when kernel D finds
  one, the whole chain is decoded again by kernel E, whose window is
  everything decoded so far.  Kernel E holds its input offsets as int32,
  so ``decode_stream_runs`` uploads and decodes the blocks in runs of at
  most ``STREAM_MAX_INPUT`` bytes (and ``RUN_MAX_OUTPUT`` of output), the
  last 64 KB decoded carried into the next run of a linked chain: frames
  and legacy files of any size decode.
* legacy compress: ``compress_legacy_device`` -> 8 MB slices, each one
  linked stream through kernel A (levels below 3) or 64 KB rows through
  kernel I (HC levels), the payloads of a slice joined into one block
  (``legacy.merge_payloads``, from the kernels' ``tails``).

There is no host codec to fall back to.  A block the kernels reject raises
``Lz4FrameError`` with its index; linked blocks under 64 KB, the one
layout outside every kernel's envelope, raise ``DeviceLayoutUnsupported``.

Every function takes a ``device``; the default ``"cuda"`` raises on a
machine without a card.  The tests pass ``device="cpu"``, which runs the
kernels' plain versions.

While a ``torch.profiler`` session records, each call of the three frame
entry points is a root span and the host's steps inside it are spans
(``lz4_tpu_torch.trace``): ``walk``, ``copy``, ``launch``, ``link``,
``xxh32`` and ``merge``.  The counters of ``trace.COUNTS`` are always on.
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import spec
from .frame import (FramePreferences, Lz4FrameError, decode_frame_header,
                    encode_frame_header)
from .kernels import decode_kernel
from .kernels.common import ints_to_device, resolve_device, to_device, to_host
from .kernels.decode_kernel import (decode_blocks, decode_blocks_linked,
                                    decode_stream_raw)
from .kernels.encode_kernel import (MAX_BLOCK, encode_blocks,
                                    encode_blocks_linked)
from .kernels.hc_kernel import encode_blocks_hc
from .kernels.pack_kernel import body_length, pack_frame_payloads
from .legacy import merge_payloads
from .ops.xxhash import XXH32State, xxh32
from .trace import COUNTS, copied, entry, span

BLOCK = 65536  # device-path block granularity
WINDOW = spec.WINDOW_SIZE

# linked-chain decode pipelining: blocks per dispatched group (64 = 4 MB of
# content; tests shrink it to exercise the window handoff between groups)
DEC_GROUP_BLOCKS = 64

CHUNK = 4 << 20          # DeviceFrameCompressor chunk of compress_frame_device
CHUNKED_ABOVE = 8 << 20  # inputs larger than this are compressed in chunks
HC_GROUP_ROWS = 1024     # 64 MiB of blocks per launch of kernel I (rows,
                         # 16-bit tables and output: about 0.4 GB; the
                         # tables' sort peaks at 0.63 GiB per group; rows
                         # [64 KB | 64 KB] with 32-bit tables: about 1.3
                         # GB, the sort's peak 1.75 GiB)
# legacy compress: the slice each block holds (8 MB; tests shrink it, to a
# multiple of 64 KB); and the input per launch of kernel A in
# chain_payloads (its candidate tables take about 82 bytes of device memory
# per input byte)
LEGACY_SLICE = spec.LEGACY_BLOCK_SIZE
CHAIN_GROUP_BYTES = 64 << 20
# kernel E's runs: the most output one run decodes (its input is bounded
# by decode_kernel.STREAM_MAX_INPUT)
RUN_MAX_OUTPUT = 1 << 31


class DeviceLayoutUnsupported(Lz4FrameError):
    """The frame is valid as far as parsed, but its layout is outside the
    device kernels' envelope (linked blocks under 64 KB)."""


def _split_blocks(data: bytes, block_size: int) -> List[bytes]:
    if not data:
        return [b""]
    with span("copy"):
        blocks = [data[i:i + block_size]
                  for i in range(0, len(data), block_size)]
        if blocks[0] is not data:
            COUNTS["host_copy_bytes"] += len(data)
        return blocks


def _piece(data: bytes, start: int, n: int) -> bytes:
    """``data[start:start + n]``, a counted copy."""
    with span("copy"):
        return copied(data[start:start + n], data)


def _join(parts: list) -> bytes:
    """``b"".join(parts)``, a counted copy (a join of one part hands the
    part back)."""
    with span("copy"):
        return copied(b"".join(parts), *parts[:1])


def byte_rows(buffers: List[bytes], width: int, dev):
    """Byte strings -> ([B, width] uint8 rows, zero padded; [B] int32
    lengths), both on ``dev``."""
    with span("copy"):
        arr = np.zeros((len(buffers), max(width, 1)), np.uint8)
        lens = np.zeros((len(buffers),), np.int32)
        for i, b in enumerate(buffers):
            arr[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
        COUNTS["host_copy_bytes"] += int(lens.sum())
    rows = to_device(arr, dev).reshape(arr.shape)
    return rows, ints_to_device(lens, dev)


# ---------------------------------------------------------------------------
# device batch codec (bytes in, bytes out)
# ---------------------------------------------------------------------------

def encode_batch(buffers: List[bytes], block_size: int = BLOCK,
                 acceleration: int = 1, min_match: int = 4,
                 reject_step: int = 1, device="cuda"):
    """Compress a list of <= block_size buffers on the device.

    Returns (comp_rows uint8 numpy [B, maxlen], comp_lens numpy [B])."""
    dev = resolve_device(device)
    rows, lens = byte_rows(buffers, block_size, dev)
    out, olen = encode_blocks(rows, lens, acceleration, min_match=min_match,
                              reject_step=reject_step)
    olen_h = to_host(olen)
    return to_host(out[:, :int(olen_h.max(initial=0))]), olen_h


def decode_batch(comp_list: List[bytes], out_cap: int,
                 out_lens: Optional[List[int]] = None,
                 device="cuda") -> List[bytes]:
    """Decompress a list of independent blocks on the device; raises
    Lz4FrameError naming the first block the kernel rejects."""
    dev = resolve_device(device)
    rows, lens = byte_rows(comp_list, max((len(c) for c in comp_list),
                                             default=1), dev)
    caps = None
    if out_lens is not None:
        caps = ints_to_device(out_lens, dev)
    with span("launch"):
        out, olen = decode_blocks(rows, lens, out_cap, out_caps=caps)
    olen_h = to_host(olen)
    if (olen_h < 0).any():
        bad = int(np.nonzero(olen_h < 0)[0][0])
        raise Lz4FrameError(f"device decode failed on block {bad}")
    out_h = to_host(out[:, :int(olen_h.max(initial=0))])
    with span("copy"):
        COUNTS["host_copy_bytes"] += int(olen_h.sum())
        return [out_h[i, :olen_h[i]].tobytes()
                for i in range(len(comp_list))]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def linked_stream(data: bytes, prefix: bytes = b"", device="cuda"):
    """The linked kernel's input for one stream of 64 KB blocks:
    ``[64 KB window | blocks | zeros to the block boundary]`` as a [1, L]
    uint8 tensor, the window holding ``prefix`` right-aligned (zeros below).
    Block k's window is simply the 64 KB before it in the same buffer, so
    nothing is duplicated.  Returns (stream, lens numpy [1, nb])."""
    nb = max(1, -(-len(data) // WINDOW))
    with span("copy"):
        host = np.zeros(((nb + 1) * WINDOW,), np.uint8)
        if prefix:
            host[WINDOW - len(prefix):WINDOW] = np.frombuffer(prefix,
                                                              np.uint8)
        host[WINDOW:WINDOW + len(data)] = np.frombuffer(data, np.uint8)
        COUNTS["host_copy_bytes"] += len(prefix) + len(data)
    lens = np.zeros((1, nb), np.int32)
    for k in range(nb):
        lens[0, k] = max(0, min(WINDOW, len(data) - k * WINDOW))
    return to_device(host, device).reshape(1, -1), lens


def _block_view(stream: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb, 64K] view of the blocks of a [1, L] linked stream."""
    return stream[0, WINDOW:(nb + 1) * WINDOW].view(nb, WINDOW)


def _fetch_body(flat: torch.Tensor, total, block_checksum: bool) -> bytes:
    """The body kernel C packed, as bytes; with block checksums, the XXH32
    of each record's payload is inserted after the record.  Reading the
    total raises ValueError if kernel C found a length outside its row."""
    n = body_length(total)
    with span("copy"):
        body = copied(to_host(flat[:n]).tobytes())
    if not block_checksum:
        return body
    with span("walk"):
        parts, pos = [], 0
        while pos < len(body):
            end = pos + 4 + (struct.unpack_from("<I", body, pos)[0]
                             & ~spec.UNCOMPRESSED_BIT)
            parts.append(copied(body[pos:end], body))
            parts.append(struct.pack("<I", xxh32(copied(body[pos + 4:end]),
                                                 0)))
            pos = end
    return _join(parts)


def assemble_linked_frame(data: bytes, prefs: FramePreferences,
                          payloads, block_lens) -> bytes:
    """Header + per-block payloads + endmark + optional checksums, for a
    linked chain in stream order (``encode_stream_linked``'s output) on the
    host.  A payload that is not smaller than its block ships the plaintext
    (stored block); empty blocks write nothing."""
    parts = []
    pos = 0
    with span("walk"):
        for payload, blen in zip(payloads, block_lens):
            if blen == 0:
                continue
            if len(payload) >= blen:
                payload = copied(data[pos:pos + blen], data)
                parts.append(struct.pack("<I", blen | spec.UNCOMPRESSED_BIT))
            else:
                parts.append(struct.pack("<I", len(payload)))
            parts.append(payload)
            if prefs.block_checksum:
                parts.append(struct.pack("<I", xxh32(payload, 0)))
            pos += blen
    return _frame(prefs, data, _join(parts))


def _frame(prefs: FramePreferences, data: bytes, body: bytes) -> bytes:
    """Header + block records + endmark + optional content checksum."""
    with span("walk"):
        parts = [encode_frame_header(prefs), body, struct.pack("<I", 0)]
    if prefs.content_checksum:
        parts.append(struct.pack("<I", xxh32(data, 0)))
    return _join(parts)


def encode_stream_linked(data: bytes, acceleration: int = 1,
                         min_match: int = 4, reject_step: int = 1,
                         device="cuda"):
    """Compress one stream as a chain of linked 64 KB blocks on the device.

    Returns (payloads, block_lens): each block's compressed bytes and its
    plaintext length; each block may match into the previous one."""
    data = bytes(data)
    if len(data) >= (1 << 31) - (1 << 17):
        # the kernels address a stream with int32 positions
        raise Lz4FrameError("stream exceeds the linked kernel's 2GB "
                            "position envelope; use chunked compression")
    dev = resolve_device(device)
    stream, lens = linked_stream(data, device=dev)
    out, olen = encode_blocks_linked(stream, torch.from_numpy(lens).to(dev),
                                     acceleration, min_match=min_match,
                                     reject_step=reject_step)
    olen_h = to_host(olen[0])
    outb = to_host(out[0, :, :int(olen_h.max(initial=0))])
    payloads = [outb[k, :n].tobytes() for k, n in enumerate(olen_h)]
    return payloads, [int(x) for x in lens[0]]


@entry("compress")
def compress_frame_device(data: bytes,
                          prefs: Optional[FramePreferences] = None,
                          block_size: int = BLOCK,
                          acceleration: int = 1,
                          min_match: int = 4,
                          reject_step: int = 1,
                          device="cuda") -> bytes:
    """One-shot frame compression with all block work on the device.

    Linked frames (``prefs.block_independent=False``, 64 KB blocks, input
    over 64 KB) chain their blocks through kernel A; everything else is
    block-independent: through kernel B up to its 256 KB rows, larger
    blocks through ``chain_records`` (kernel A, each block's payloads
    joined on the host).  Every block holds ``block_size`` content bytes
    but the last.  Parity: LZ4F_compressFrame."""
    prefs = dataclasses.replace(prefs) if prefs else FramePreferences()
    dev = resolve_device(device)
    with span("copy"):
        data = copied(bytes(data), data)
    if prefs.content_size is not None and prefs.content_size != len(data):
        raise Lz4FrameError("content_size does not match data")
    linked = (not prefs.block_independent and len(data) > WINDOW
              and block_size == WINDOW)
    if linked:
        if prefs.block_size_id == 0:
            prefs.block_size_id = 4        # 64KB, the kernel's chain unit
        prefs.resolved_bsid()              # rejects an invalid id
        if len(data) > CHUNKED_ABOVE:
            # chunked: one chunk in flight while the next is prepared
            comp = DeviceFrameCompressor(prefs, acceleration, min_match,
                                         reject_step, device=dev)
            parts = [comp.begin()]
            for i in range(0, len(data), CHUNK):
                parts.append(comp.update(_piece(data, i, CHUNK)))
            parts.append(comp.end())
            return _join(parts)
        return _compress_frame_device_linked(data, prefs, acceleration,
                                             min_match, reject_step, dev)
    # A linked frame whose data fits one block (or whose block size is not
    # the chain unit) is compressed block-independently: still a valid
    # linked stream, and the header keeps the requested block-mode bit.
    if prefs.block_size_id == 0:
        prefs.block_size_id = spec.optimal_block_size_id(block_size)
    if block_size > spec.BLOCK_SIZES[prefs.resolved_bsid()]:
        raise Lz4FrameError("block_size exceeds frame block maximum")
    if block_size > MAX_BLOCK:
        body, _ = chain_records(data, block_size, None, False, acceleration,
                                min_match, reject_step, prefs.block_checksum,
                                dev)
        return _frame(prefs, data, body)
    rows, lens = byte_rows(_split_blocks(data, block_size), block_size, dev)
    with span("launch"):
        out, olen = encode_blocks(rows, lens, acceleration,
                                  min_match=min_match,
                                  reject_step=reject_step)
    with span("launch"):
        flat, total, _stored = pack_frame_payloads(out, olen, rows, lens)
    return _frame(prefs, data, _fetch_body(flat, total, prefs.block_checksum))


def dispatch_linked(data: bytes, prefix: bytes, acceleration: int,
                    min_match: int, reject_step: int, dev: torch.device):
    """Launch kernels A and C for ``data`` as one linked stream of 64 KB
    blocks, ``prefix`` (at most 64 KB) as block 0's window, without
    waiting.  Block 0's window lanes below the prefix are not zeroed, as in
    the one-shot route.  Returns kernel C's (flat, total): the body's
    records, for ``_fetch_body``."""
    nb = max(1, -(-len(data) // WINDOW))
    stream, lens = linked_stream(data, prefix, dev)
    lens_d = ints_to_device(lens, dev)
    prefix_d = ints_to_device([len(prefix)], dev)
    with span("launch"):
        out, olen = encode_blocks_linked(
            stream, lens_d, acceleration, prefix_lens=prefix_d,
            min_match=min_match, reject_step=reject_step)
    with span("launch"):
        flat, total, _stored = pack_frame_payloads(
            out.reshape(nb, -1), olen.reshape(nb), _block_view(stream, nb),
            lens_d.reshape(nb))
    return flat, total


def _compress_frame_device_linked(data: bytes, prefs: FramePreferences,
                                  acceleration: int, min_match: int,
                                  reject_step: int,
                                  dev: torch.device) -> bytes:
    """Linked frame of 64 KB blocks in one pass through kernels A and C."""
    flat, total = dispatch_linked(data, b"", acceleration, min_match,
                                  reject_step, dev)
    return _frame(prefs, data, _fetch_body(flat, total, prefs.block_checksum))


@entry("compress")
def compress_frame_device_hc(data: bytes,
                             prefs: Optional[FramePreferences] = None,
                             level: int = 9, device="cuda") -> bytes:
    """HC frame compression with the block work on the device.

    Independent 64 KB blocks through kernel I (``encode_blocks_hc``), at most
    HC_GROUP_ROWS blocks per launch, each group's body packed by kernel C
    (stored blocks where the payload is not smaller) and fetched once.  A
    linked request warns and is demoted to independent blocks, as in
    ``lz4_tpu``; ``block_size_id`` 0 becomes 4 (64 KB)."""
    dev = resolve_device(device)
    prefs = dataclasses.replace(prefs) if prefs else FramePreferences()
    if not prefs.block_independent:
        warnings.warn("device HC emits block-independent frames; "
                      "linked (-BD) HC demoted to independent blocks",
                      stacklevel=3)      # past trace.entry's wrapper
    prefs.block_independent = True
    if prefs.block_size_id == 0:
        prefs.block_size_id = 4
    if prefs.content_size is not None and prefs.content_size != len(data):
        raise Lz4FrameError("content_size does not match data")
    with span("copy"):
        data = copied(bytes(data), data)
    blocks = _split_blocks(data, BLOCK)
    bodies = []
    for g in range(0, len(blocks), HC_GROUP_ROWS):
        rows, lens = byte_rows(blocks[g:g + HC_GROUP_ROWS], BLOCK, dev)
        with span("launch"):
            out, olen = encode_blocks_hc(rows, lens, level)
        with span("launch"):
            flat, total, _stored = pack_frame_payloads(out, olen, rows, lens)
        bodies.append(_fetch_body(flat, total, prefs.block_checksum))
    return _frame(prefs, data, _join(bodies))


def _fetch_payloads(out: torch.Tensor, olen: torch.Tensor,
                    tails: torch.Tensor):
    """The payloads ``out[r, :olen[r]]`` of [R, M] rows, gathered on the
    device and fetched in one copy: (payload bytes back to back as a
    memoryview, olen and tails as int64 numpy [R])."""
    olen_h = to_host(olen).astype(np.int64)
    mx = int(olen_h.max(initial=0))
    with span("launch"):
        cols = torch.arange(mx, dtype=torch.int32, device=out.device)
        flat = out[:, :mx][cols[None, :] < olen[:, None]]
    return (memoryview(to_host(flat)), olen_h,
            to_host(tails).astype(np.int64))


def _row_payloads(out, olen, tails, per_block: int):
    """The payloads of every ``per_block`` consecutive rows, fetched in one
    copy: a list per group of (payload views, tails) of its rows of nonzero
    length (rows of length 0 are padding)."""
    flat, olen_h, tails_h = _fetch_payloads(out, olen, tails)
    with span("walk"):
        ends = np.cumsum(olen_h)
        groups = []
        for r0 in range(0, len(olen_h), per_block):
            rows = [r for r in range(r0, min(r0 + per_block, len(olen_h)))
                    if olen_h[r] > 0]
            groups.append(([flat[ends[r] - olen_h[r]:ends[r]] for r in rows],
                           [tails_h[r] for r in rows]))
    return groups


def _joined_blocks(out, olen, tails, per_block: int) -> List[bytes]:
    """Join every ``per_block`` consecutive rows' payloads into one block;
    rows of length 0 (padding) take no part."""
    return [join_block(views, tl)
            for views, tl in _row_payloads(out, olen, tails, per_block)
            if views]


def join_block(views, tails) -> bytes:
    """One block joined on the host from consecutive kernel payloads
    (``legacy.merge_payloads``): a ``merge`` step, its bytes counted as
    merged and as a host copy."""
    with span("merge"):
        block = merge_payloads(views, tails)
        COUNTS["merged_bytes"] += len(block)
        COUNTS["host_copy_bytes"] += len(block)
    return block


def joined_records(data: bytes, block_size: int, groups,
                   block_checksum: bool) -> bytes:
    """The block records of ``data`` cut into blocks of ``block_size`` (the
    last may be shorter), block k joined from ``groups[k]`` (its payload
    views and tails, as ``chain_payloads`` and ``hc.hc_payloads`` return
    them): a block whose join is not smaller than its content is stored;
    then, when asked, the XXH32 of the bytes written."""
    parts = []
    for k, (views, tails) in enumerate(groups):
        block = join_block(views, tails)
        with span("walk"):
            n = min(block_size, len(data) - k * block_size)
            if len(block) >= n:
                block = _piece(data, k * block_size, n)
                parts.append(struct.pack("<I", n | spec.UNCOMPRESSED_BIT))
            else:
                parts.append(struct.pack("<I", len(block)))
            parts.append(block)
            if block_checksum:
                parts.append(struct.pack("<I", xxh32(block, 0)))
    return _join(parts)


def chain_records(data: bytes, block_size: int,
                  window: Optional[torch.Tensor], linked: bool,
                  acceleration: int = 1, min_match: int = 4,
                  reject_step: int = 1, block_checksum: bool = False,
                  device="cuda"):
    """The block records of ``data`` in blocks of ``block_size``, each block
    one chain of kernel A (``chain_payloads``) joined on the host
    (``joined_records``).  Returns (records, the window after them with
    ``linked``, else None)."""
    groups, window = chain_payloads(data, block_size, window, linked,
                                    acceleration, min_match, device,
                                    reject_step)
    return joined_records(data, block_size, groups, block_checksum), window


def window_tensor(history, dev) -> torch.Tensor:
    """The last 64 KB of ``history`` (bytes) as a 1-D uint8 tensor on
    ``dev``: a window that stays on the device between calls."""
    return to_device(bytes(history)[-WINDOW:], dev)


def next_window(window: Optional[torch.Tensor],
                data: torch.Tensor) -> torch.Tensor:
    """The last 64 KB of ``window`` followed by ``data`` (both 1-D uint8
    tensors on one device), as a new tensor on that device."""
    if data.numel() >= WINDOW or window is None or not window.numel():
        return data[-WINDOW:].clone()
    return torch.cat([window, data])[-WINDOW:]


def chain_payloads(data: bytes, piece: int,
                   window: Optional[torch.Tensor], linked: bool,
                   acceleration: int = 1, min_match: int = 4,
                   device="cuda", reject_step: int = 1):
    """Kernel A over ``data`` cut into pieces of ``piece`` bytes (the last
    may be shorter), each piece one stream of linked 64 KB blocks, S pieces
    (CHAIN_GROUP_BYTES of input) a launch, each launch's input uploaded and
    its payloads fetched in one copy.  With ``linked``, piece 0's
    dictionary prefix is ``window`` (a 1-D uint8 tensor of at most 64 KB on
    the device, or None) and piece k's the 64 KB before it, and the
    candidate tables' lanes below a prefix are zeroed; else no piece has a
    prefix (legacy slices, independent frame blocks).

    Returns (a list per piece of (payload views, tails), which
    ``join_block`` joins into the piece's block; with ``linked``, the
    last 64 KB of ``window`` and ``data`` as a tensor on the device, else
    None)."""
    dev = resolve_device(device)
    n = len(data)
    if linked and n > piece and piece < WINDOW:
        raise ValueError("linked pieces must hold at least 64 KB")
    if window is not None and window.numel() > WINDOW:
        raise ValueError("a window holds at most 64 KB")
    if not n:
        return [], window if linked else None
    starts = list(range(0, n, piece))
    nb = -(-min(piece, n) // WINDOW)
    per_launch = max(1, CHAIN_GROUP_BYTES // (nb * WINDOW))
    groups = []
    for g in range(0, len(starts), per_launch):
        st = starts[g:g + per_launch]
        S = len(st)
        sizes = [min(piece, n - s) for s in st]
        lo = max(st[0] - WINDOW, 0) if linked else st[0]
        flat = to_device(data[lo:st[-1] + sizes[-1]], dev)
        plens = [0] * S
        back = [r for r in range(S) if linked and st[r] > 0]
        for r in back:
            plens[r] = WINDOW
        if linked and st[0] == 0 and window is not None and window.numel():
            plens[0] = window.numel()
        lens = np.clip(np.asarray(sizes)[:, None]
                       - WINDOW * np.arange(nb)[None, :], 0, WINDOW)
        lens_d = ints_to_device(lens, dev)
        plens_d = ints_to_device(plens, dev)
        back_d = ints_to_device([st[r] - lo - WINDOW for r in back], dev,
                                torch.int64) if back else None
        with span("launch"):            # the streams, staged on the card
            stream = torch.zeros((S, (nb + 1) * WINDOW), dtype=torch.uint8,
                                 device=dev)
            full = sum(1 for z in sizes if z == piece)
            if full:
                stream[:full, WINDOW:WINDOW + piece] = \
                    flat[st[0] - lo:st[0] - lo + full * piece].view(full,
                                                                    piece)
            if full < S:
                stream[S - 1, WINDOW:WINDOW + sizes[-1]] = flat[st[-1] - lo:]
            if back:
                idx = back_d[:, None] + torch.arange(WINDOW, device=dev)[None]
                stream[back, :WINDOW] = flat[idx]
            if plens[0] and st[0] == 0:
                stream[0, WINDOW - plens[0]:WINDOW] = window
        with span("launch"):
            out, olen, tails = encode_blocks_linked(
                stream, lens_d, acceleration, prefix_lens=plens_d,
                min_match=min_match, reject_step=reject_step,
                zero_window_lanes=any(plens), tails=True)
        groups += _row_payloads(out.reshape(S * nb, -1), olen.reshape(-1),
                                tails.reshape(-1), nb)
    return groups, next_window(window, flat) if linked else None


def chain_block(data: bytes, window: Optional[torch.Tensor] = None,
                acceleration: int = 1, min_match: int = 4, device="cuda"):
    """``data`` of any length as ONE LZ4 block behind ``window`` (the
    history right before it, a tensor of at most 64 KB on the device, or
    None): kernel A's linked chain over it, its payloads joined.  Returns
    (block, the new window on the device)."""
    groups, win = chain_payloads(data, CHAIN_GROUP_BYTES, window, True,
                                 acceleration, min_match, device)
    views = [v for vs, _ in groups for v in vs]
    tails = [t for _, ts in groups for t in ts]
    return (join_block(views, tails) if views else b"\x00"), win


def _legacy_fast_blocks(data: bytes, acceleration: int, min_match: int,
                        dev: torch.device) -> List[bytes]:
    """Each LEGACY_SLICE of ``data`` as one linked stream of 64 KB blocks
    without a prefix through kernel A, its payloads joined into one block:
    a match of the chain reaches at most 65,535 bytes back and never
    before the slice, so it stays valid in the joined block."""
    groups, _ = chain_payloads(data, LEGACY_SLICE, None, False, acceleration,
                               min_match, dev)
    return [join_block(views, tails) for views, tails in groups]


def _legacy_hc_blocks(data: bytes, level: int,
                      dev: torch.device) -> List[bytes]:
    """Each LEGACY_SLICE of ``data`` as independent 64 KB rows through
    kernel I at ``level``, whole slices in groups of about HC_GROUP_ROWS
    rows, each slice's payloads joined into one block."""
    per_slice = LEGACY_SLICE // BLOCK
    group = max(1, HC_GROUP_ROWS // per_slice) * per_slice
    rows_all = _split_blocks(data, BLOCK)
    blocks = []
    for g in range(0, len(rows_all), group):
        rows, lens = byte_rows(rows_all[g:g + group], BLOCK, dev)
        out, olen, tails = encode_blocks_hc(rows, lens, level, tails=True)
        blocks += _joined_blocks(out, olen, tails, per_slice)
    return blocks


def compress_legacy_device(data: bytes, level: int = 1,
                           acceleration: int = 1, min_match: int = 4,
                           device="cuda") -> bytes:
    """Legacy frame (magic 0x184C2102, then for each 8 MB slice of the
    input an LE32 size and one always-compressed block) with the block work
    on the device.  Parity: ``lz4_tpu.frame.compress_legacy`` (the same
    container; empty input writes the same bytes).

    Levels below 3 parse each slice as one linked chain of 64 KB blocks
    through kernel A; levels 3 and up parse its 64 KB rows independently
    through kernel I.  The payloads of a slice are joined into its block on
    the host, from the kernels' ``tails`` and one fetch, without a walk
    over their tokens.  A block that does not shrink stays compressed: a
    legacy block is never stored."""
    dev = resolve_device(device)
    data = bytes(data)
    if LEGACY_SLICE % BLOCK or not 0 < LEGACY_SLICE <= spec.LEGACY_BLOCK_SIZE:
        raise ValueError("LEGACY_SLICE must be a multiple of 64 KB, at most "
                         "8 MB")
    if not data:
        blocks = [b"\x00"]                   # one empty block, as lz4 writes
    elif level >= 3:
        blocks = _legacy_hc_blocks(data, level, dev)
    else:
        blocks = _legacy_fast_blocks(data, max(1, int(acceleration)),
                                     min_match, dev)
    parts = [struct.pack("<I", spec.LEGACY_MAGIC)]
    for blk in blocks:
        parts += [struct.pack("<I", len(blk)), blk]
    return b"".join(parts)


class DeviceFrameCompressor:
    """Streaming LZ4F compression on the device: feed chunks, get frame
    bytes.  Writes ONE linked 64 KB-block frame; the 64 KB window carries
    across chunks as the next chunk's dictionary prefix, so the ratio equals
    whole-buffer compression.  Parity: LZ4F_compressBegin/Update/flush/End.

    ``update`` dispatches its chunk's kernels and only then fetches the
    previous chunk's bytes, so one chunk is always in flight.  No state
    moves until those bytes are in hand: a call that raises (a launch, a
    copy, or kernel C's range fault, which surfaces in the fetch) leaves
    the compressor as it was, and the caller may retry it."""

    def __init__(self, prefs: Optional[FramePreferences] = None,
                 acceleration: int = 1, min_match: int = 4,
                 reject_step: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.prefs = dataclasses.replace(prefs) if prefs \
            else FramePreferences()
        self.prefs.block_independent = False
        if self.prefs.block_size_id == 0:
            self.prefs.block_size_id = 4
        self.prefs.resolved_bsid()
        self.acceleration = acceleration
        self.min_match = min_match
        self.reject_step = reject_step
        self._tail = b""        # last 64KB of content (the window)
        self._buf = b""         # sub-block input remainder
        self._xxh = XXH32State(0)
        self._total = 0
        self._begun = False
        self._pending = None    # dispatched device work awaiting fetch
        self._tail_dev = None   # the window as a device tensor, when whole
        self._owed = b""        # fetched bytes not yet returned

    def begin(self) -> bytes:
        self._begun = True
        with span("walk"):
            return encode_frame_header(self.prefs)

    def _require_begun(self) -> None:
        if not self._begun:
            raise RuntimeError("call begin() first")

    def _emit_pending(self) -> None:
        """Fetch the previously dispatched chunk's bytes into ``_owed``;
        it stays pending until the fetch returns."""
        if self._pending is None:
            return
        flat, total = self._pending
        body = _fetch_body(flat, total, self.prefs.block_checksum)
        with span("copy"):
            self._owed = copied(self._owed + body, body)
        self._pending = None

    def _take_owed(self) -> bytes:
        out, self._owed = self._owed, b""
        return out

    def _dispatch(self, data: bytes, prefix: bytes):
        """Launch the device work for ``data`` (whole blocks, or a final
        partial) with ``prefix`` as block 0's window; returns the pending
        record and the new window on the device (None unless ``data`` is
        whole blocks) without waiting.  Changes no state."""
        dev = self.device
        nb = max(1, -(-len(data) // WINDOW))
        if data and len(data) % WINDOW == 0:
            # whole blocks: the chunk crosses the link once; the window is
            # the previous chunk's last block, already on the device
            with span("launch"):            # the stream, staged on the card
                stream = torch.empty((1, (nb + 1) * WINDOW),
                                     dtype=torch.uint8, device=dev)
                if self._tail_dev is not None:
                    stream[0, :WINDOW] = self._tail_dev
                    plen = WINDOW
                else:
                    with span("copy"):
                        window = np.zeros((WINDOW,), np.uint8)
                        if prefix:
                            window[WINDOW - len(prefix):] = np.frombuffer(
                                prefix, np.uint8)
                        COUNTS["host_copy_bytes"] += len(prefix)
                    stream[0, :WINDOW] = to_device(window, dev)
                    plen = len(prefix)
                stream[0, WINDOW:] = to_device(data, dev)
            lens = [WINDOW] * nb
            tail_dev = stream[0, nb * WINDOW:]
            zero_lanes = True
        else:
            stream, lens_np = linked_stream(data, prefix, dev)
            lens = lens_np[0].tolist()
            plen = len(prefix)
            tail_dev = None
            zero_lanes = False
        lens_d = ints_to_device([lens], dev)
        prefix_d = ints_to_device([plen], dev)
        with span("launch"):
            out, olen = encode_blocks_linked(
                stream, lens_d, self.acceleration, prefix_lens=prefix_d,
                min_match=self.min_match, reject_step=self.reject_step,
                zero_window_lanes=zero_lanes)
        with span("launch"):
            flat, total, _stored = pack_frame_payloads(
                out.reshape(nb, -1), olen.reshape(nb),
                _block_view(stream, nb), lens_d.reshape(nb))
        return (flat, total), tail_dev

    def _advance(self, data: bytes, tail_dev) -> None:
        """Account ``data`` as compressed: its length, the content checksum
        and the window move on together."""
        self._total += len(data)
        if self.prefs.content_checksum:
            self._xxh.update(data)
        with span("copy"):
            joined = copied(self._tail + data, data)
            self._tail = copied(joined[-WINDOW:], joined)
        self._tail_dev = tail_dev

    def update(self, chunk: bytes) -> bytes:
        self._require_begun()
        with span("copy"):
            chunk = copied(bytes(chunk), chunk)
            data = copied(self._buf + chunk, chunk)
            whole = (len(data) // WINDOW) * WINDOW
            body = copied(data[:whole], data) if whole else b""
        if not whole:
            self._buf = data
            return self._take_owed()
        cur, tail_dev = self._dispatch(body, self._tail)
        self._emit_pending()                # the previous chunk
        self._buf = copied(data[whole:], data)
        self._advance(body, tail_dev)
        self._pending = cur
        return self._take_owed()

    def _encode_now(self, data: bytes) -> None:
        """Compress a final or flushed partial remainder synchronously into
        ``_owed``; the remainder buffer is emptied with the rest."""
        (flat, total), tail_dev = self._dispatch(data, self._tail)
        body = _fetch_body(flat, total, self.prefs.block_checksum)
        self._advance(data, tail_dev)
        self._buf = b""
        with span("copy"):
            self._owed = copied(self._owed + body, body)

    def flush(self) -> bytes:
        """Emit the buffered sub-block remainder now as a (possibly short)
        linked block.  Parity: LZ4F_flush; the window keeps carrying.
        ``decompress_frame_device`` decodes a frame with such a short
        non-final block through the stream kernel (kernel E)."""
        self._require_begun()
        self._emit_pending()
        if self._buf:
            self._encode_now(self._buf)
        return self._take_owed()

    def end(self) -> bytes:
        self._require_begun()
        self._emit_pending()
        if self._buf:
            self._encode_now(self._buf)
        if (self.prefs.content_size is not None
                and self.prefs.content_size != self._total):
            raise Lz4FrameError("content_size does not match data")
        parts = [self._take_owed(), struct.pack("<I", 0)]
        if self.prefs.content_checksum:
            parts.append(struct.pack("<I", self._xxh.digest()))
        return _join(parts)


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

def _literal_block(payload: bytes) -> bytes:
    """Wrap raw bytes as a literal-only LZ4 block (token + run + bytes), so
    a stored block spliced into a linked chain decodes to its bytes and
    keeps the window contract intact."""
    n = len(payload)
    if n < 15:
        return copied(bytes([n << 4]) + payload)
    ext = n - 15
    out = bytearray([0xF0])
    while ext >= 255:
        out.append(255)
        ext -= 255
    out.append(ext)
    return copied(bytes(out) + payload)


class _Landing:
    """Decoded content on its way to the host, gathered for one copy out.

    Kernel D's decoded rows and kernel E's decoded runs
    (``decode_stream_runs``) land here.  On the card each run of decoded
    bytes is fetched with one non-blocking D2H into its place in one
    pinned host buffer of ``size`` bytes, a bound on the content
    (``torch.empty(..., pin_memory=True)``).  PyTorch's caching host
    allocator hands the buffer out and takes it back when the call drops
    it, so a caller in a steady state allocates no pinned memory and two
    callers at once never share one.  The cache keeps each buffer it has
    handed out, rounded up to a power of two: one per caller decoding at
    the same time (64 MiB per caller decoding objects of 64 MiB), until
    the process ends or the host cache is emptied.  On the CPU the rows
    are host memory already and are read where they lie.  ``content`` waits
    once for the stream, then joins the runs and the stored blocks, which
    come straight from the frame, in one host copy: a new ``bytes``, never
    a view of the landing."""

    def __init__(self, size: int, dev: torch.device):
        self.dev = dev
        self.pinned = None
        if dev.type == "cuda" and size > 0:
            self.pinned = torch.empty((size,), dtype=torch.uint8,
                                      pin_memory=True)
        self.used = 0
        self.fetched = False
        self.parts: list = []

    def fetch(self, flat: torch.Tensor, start: int, n: int) -> None:
        """Fetch ``flat[start:start + n]`` of 1-D decoded rows, next in
        the content."""
        if n <= 0:
            return
        with span("link"):
            COUNTS["d2h_bytes"] += n
            COUNTS["pinned_d2h_bytes"] += n
            self.fetched = True
            src = flat[start:start + n]
            if self.pinned is None:
                self.parts.append(src.numpy())
                return
            dst = self.pinned[self.used:self.used + n]
            dst.copy_(src, non_blocking=True)
            self.used += n
            self.parts.append(dst.numpy())

    def stored(self, frame: memoryview, start: int, n: int) -> None:
        """A stored block's bytes, next in the content."""
        self.parts.append(frame[start:start + n])

    def content(self) -> bytes:
        if self.fetched:
            with span("link"):
                COUNTS["syncs"] += 1
                if self.pinned is not None:
                    torch.cuda.current_stream(self.dev).synchronize()
        with span("copy"):
            return copied(b"".join(self.parts))


def _read_blocks(frame: bytes, pos: int, info):
    """Walk the block records: (payload offsets, payload sizes, stored
    flags, position after the endmark)."""
    bound = spec.compress_bound(info.block_size)
    starts: List[int] = []
    sizes: List[int] = []
    stored: List[bool] = []
    while True:
        if pos + 4 > len(frame):
            raise Lz4FrameError("truncated frame")
        raw = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if raw == 0:
            return starts, sizes, stored, pos
        size = raw & ~spec.UNCOMPRESSED_BIT
        if pos + size > len(frame):
            raise Lz4FrameError("truncated block")
        is_stored = bool(raw & spec.UNCOMPRESSED_BIT)
        if not is_stored and size > bound:
            raise Lz4FrameError(
                f"block {len(starts)}: payload of {size} bytes "
                f"exceeds compress_bound({info.block_size})")
        starts.append(pos)
        sizes.append(size)
        stored.append(is_stored)
        pos += size
        if info.block_checksum:
            if pos + 4 > len(frame):
                raise Lz4FrameError("truncated block checksum")
            want = struct.unpack_from("<I", frame, pos)[0]
            if xxh32(copied(frame[pos - size:pos]), 0) != want:
                raise Lz4FrameError("block checksum mismatch")
            pos += 4


def _runs(starts, sizes, caps, lead: int):
    """Bounds of the runs of blocks that kernel E decodes one call each: a
    run's payload bytes (from its first block's start to its last block's
    end) and the window carried into it fit STREAM_MAX_INPUT, its caps
    RUN_MAX_OUTPUT, and every run holds at least one block."""
    max_in = decode_kernel.STREAM_MAX_INPUT - lead
    max_out = RUN_MAX_OUTPUT - lead
    bounds, i, n = [0], 0, len(starts)
    while i < n:
        j, out = i + 1, caps[i]
        while j < n and starts[j] + sizes[j] - starts[i] <= max_in \
                and out + caps[j] <= max_out:
            out += caps[j]
            j += 1
        bounds.append(j)
        i = j
    return bounds


def decode_stream_runs(buf, starts: Sequence[int], sizes: Sequence[int],
                       stored: Sequence, caps: Sequence[int],
                       block_size: int, linked: bool, dev: torch.device,
                       window: bytes = b"") -> Tuple[bytes, np.ndarray]:
    """Kernel E over the blocks at ``starts`` of ``buf`` (bytes-like), with
    the result of one ``decode_stream_raw`` call over them all: (the good
    blocks' bytes in order, olen per block, -1 for a block the kernel
    rejects).  ``window`` is the history before the first block (linked
    mode).

    Kernel E holds input offsets as int32, so the blocks go in runs
    (``_runs``), each uploaded and decoded alone.  In linked mode a run
    starts with the last 64 KB decoded so far as a stored block whose
    output is dropped, so its blocks reference across the cut as in one
    call (a failed block moves nothing there either).  A block whose
    payload alone passes the bound fails without a launch, as it fails in
    one call: a block decodes to about its payload's length or more, and
    its cap is at most 8 MB.  Device memory holds one run's input and
    output, not the whole frame's.

    Each run's decoded bytes land in one ``_Landing`` of the sum of the
    caps (on the card one non-blocking D2H per run into one pinned host
    buffer), and the content is copied out of it once, after one wait.
    In linked mode the 64 KB carried into the next run is fetched from
    the run's output on the device, a small blocking copy."""
    B = len(starts)
    buf = memoryview(buf)
    stored = [bool(x) for x in stored]
    landing = _Landing(int(sum(caps)), dev)
    olen = np.zeros((B,), np.int64)
    tail = bytes(window[-WINDOW:]) if linked else b""
    bounds = _runs(starts, sizes, caps, WINDOW if linked else 0)
    for i, j in zip(bounds[:-1], bounds[1:]):
        lead = len(tail)             # a stored block: the window, dropped
        if sizes[i] + lead > decode_kernel.STREAM_MAX_INPUT:
            olen[i] = -1                 # j == i + 1: the block alone
            continue
        base = starts[i] - lead
        run = buf[starts[i]:starts[j - 1] + sizes[j - 1]]
        flat = _join([tail, run]) if lead else run
        head = [lead] if lead else []
        with span("launch"):
            out, ol = decode_stream_raw(
                to_device(flat, dev),
                [0] * len(head) + [s - base for s in starts[i:j]],
                head + list(sizes[i:j]), [True] * len(head) + stored[i:j],
                block_size, 0, linked, out_caps=head + list(caps[i:j]))
        ol = to_host(ol).astype(np.int64)[len(head):]
        olen[i:j] = ol
        got = int(ol[ol > 0].sum())
        landing.fetch(out, lead, got)
        if linked and got and j < B:
            # out begins with the window carried in, so its last 64 KB
            # decoded is the next run's window
            with span("copy"):
                tail = copied(to_host(
                    out[max(lead + got - WINDOW, 0):lead + got]).tobytes())
    return landing.content(), olen


def _decode_stream_blocks(buf, starts: List[int], sizes: List[int],
                          stored: List[bool], caps: List[int],
                          block_size: int, linked: bool,
                          dev: torch.device) -> bytes:
    """Decode the blocks at ``starts`` of ``buf`` through kernel E
    (``decode_stream_runs``); raises Lz4FrameError naming the first block
    the kernel rejects."""
    content, olen = decode_stream_runs(buf, starts, sizes, stored, caps,
                                       block_size, linked, dev)
    if (olen < 0).any():
        bad = int(np.nonzero(olen < 0)[0][0])
        raise Lz4FrameError(f"device decode failed on block {bad}")
    return content


def _decode_independent(frame: bytes, starts: List[int], sizes: List[int],
                        stored: List[bool], bs: int,
                        dev: torch.device) -> bytes:
    """Decode an independent frame of blocks of at most 64 KB: the
    compressed blocks in one batch through kernel D, each run of rows that
    lies in the content as it lies in the rows (every row but the run's
    last decoded to the full ``bs``) fetched at once, stored blocks taken
    from the frame (``_Landing``).  Raises Lz4FrameError naming the first
    block the kernel rejects."""
    todo = [i for i, st in enumerate(stored) if not st]
    flat, olen = None, []
    if todo:
        with span("copy"):
            payloads = [frame[starts[i]:starts[i] + sizes[i]] for i in todo]
            COUNTS["host_copy_bytes"] += sum(sizes[i] for i in todo)
        rows, lens = byte_rows(payloads, max(len(p) for p in payloads), dev)
        with span("launch"):
            out, olen_d = decode_blocks(rows, lens, bs)
        olen = to_host(olen_d)
        if (olen < 0).any():
            bad = todo[int(np.nonzero(olen < 0)[0][0])]
            raise Lz4FrameError(f"device decode failed on block {bad}")
        flat, olen = out.reshape(-1), olen.tolist()
    landing = _Landing(sum(olen), dev)
    view = memoryview(frame)
    lo = hi = k = 0              # flat[lo:hi]: decoded rows not yet fetched
    with span("walk"):
        for st, s, n in zip(stored, starts, sizes):
            if st:
                landing.fetch(flat, lo, hi - lo)
                lo = hi
                landing.stored(view, s, n)
                continue
            if k * bs != hi:     # the row before decoded short
                landing.fetch(flat, lo, hi - lo)
                lo = k * bs
            hi = k * bs + olen[k]
            k += 1
        landing.fetch(flat, lo, hi - lo)
    return landing.content()


def _decode_linked_chain(frame: bytes, starts: List[int], sizes: List[int],
                         stored: List[bool], bs: int,
                         dev: torch.device) -> bytes:
    """Decode a linked chain of 64 KB blocks in groups of DEC_GROUP_BLOCKS:
    group g+1 is dispatched before group g is fetched, and its window is
    group g's last output block, handed over on the device.  Stored blocks
    are spliced in as literal-only blocks.  When a non-final block decodes
    short, the successors' one-block window is wrong, so the whole chain is
    decoded again by kernel E in linked mode, with caps of ``bs``."""
    G = DEC_GROUP_BLOCKS
    with span("copy"):
        payloads = [_literal_block(frame[s:s + n]) if st else frame[s:s + n]
                    for s, n, st in zip(starts, sizes, stored)]
        COUNTS["host_copy_bytes"] += sum(sizes)
    nblocks = len(payloads)
    landing = _Landing(nblocks * bs, dev)
    win = None
    pending: List[Tuple] = []

    def drain() -> bool:
        """Fetch the oldest group; False at a short non-final block."""
        out_d, olen_d, first = pending.pop(0)
        olen = to_host(olen_d).tolist()
        for i, n in enumerate(olen):
            g = first + i
            if n < 0:
                raise Lz4FrameError(f"device decode failed on block {g}")
            if n != bs and g != nblocks - 1:
                return False
        landing.fetch(out_d.reshape(-1), 0, sum(olen))
        return True

    full = True
    for first in range(0, nblocks, G):
        grp = payloads[first:first + G]
        rows, lens = byte_rows(grp, max(len(c) for c in grp), dev)
        with span("launch"):
            out_d, olen_d = decode_blocks_linked(
                rows, lens, bs, init_window=win,
                init_window_len=bs if win is not None else 0)
        win = out_d[len(grp) - 1]
        pending.append((out_d, olen_d, first))
        if len(pending) > 1 and not drain():
            full = False
            break
    while full and pending:
        full = drain()
    if not full:
        landing = None     # its pinned buffer back to the cache for E's
        return _decode_stream_blocks(frame, starts, sizes, stored,
                                     [bs] * nblocks, bs, True, dev)
    return landing.content()


@entry("decompress")
def decompress_frame_device(frame: bytes, device="cuda") -> Tuple[bytes, int]:
    """One-shot frame decompression with all block work on the device.

    Handles every block size: 64 KB blocks through kernel D (linked chains,
    or independent batches), larger ones through kernel E over the raw
    frame, in runs (``decode_stream_runs``), so a frame of any length
    decodes.  Returns (content, bytes_consumed)."""
    dev = resolve_device(device)
    with span("copy"):
        frame = copied(bytes(frame), frame)
    with span("walk"):
        info = decode_frame_header(frame)
        starts, sizes, stored, pos = _read_blocks(frame, info.header_size,
                                                  info)
    bs = info.block_size
    if not starts:
        content = b""
    elif bs > BLOCK:
        # stored blocks may fill their own length, compressed ones a block
        caps = [n if st else bs for n, st in zip(sizes, stored)]
        content = _decode_stream_blocks(frame, starts, sizes, stored, caps,
                                        bs, not info.block_independent, dev)
    elif info.block_independent:
        content = _decode_independent(frame, starts, sizes, stored, bs, dev)
    else:
        if bs < WINDOW:
            raise DeviceLayoutUnsupported(
                "linked blocks under 64 KB: the window spans several blocks")
        content = _decode_linked_chain(frame, starts, sizes, stored, bs, dev)
    if info.content_checksum:
        if pos + 4 > len(frame):
            raise Lz4FrameError("truncated content checksum")
        want = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if xxh32(content, 0) != want:
            raise Lz4FrameError("content checksum mismatch")
    if info.content_size is not None and info.content_size != len(content):
        raise Lz4FrameError("frame content size mismatch")
    return content, pos


def decompress_legacy_device(data: bytes, device="cuda") -> Tuple[bytes, int]:
    """Decode a legacy frame (magic 0x184C2102, independent 8 MB blocks,
    always compressed) through kernel E over the raw bytes, in runs
    (``decode_stream_runs``).  Stops at the end of the input or at the next
    frame's magic.  Returns (content,
    bytes_consumed)."""
    dev = resolve_device(device)
    data = bytes(data)
    if len(data) < 4 or \
            struct.unpack_from("<I", data)[0] != spec.LEGACY_MAGIC:
        raise Lz4FrameError("not a legacy frame")
    pos = 4
    starts: List[int] = []
    sizes: List[int] = []
    while pos + 4 <= len(data):
        size = struct.unpack_from("<I", data, pos)[0]
        if size in (spec.FRAME_MAGIC, spec.LEGACY_MAGIC) or \
                (size & spec.SKIPPABLE_MAGIC_MASK) == spec.SKIPPABLE_MAGIC_MIN:
            break                                   # the next frame begins
        pos += 4
        if pos + size > len(data):
            raise Lz4FrameError("truncated legacy block")
        starts.append(pos)
        sizes.append(size)
        pos += size
    if not starts:
        return b"", pos
    n = len(starts)
    bs = spec.LEGACY_BLOCK_SIZE
    return _decode_stream_blocks(data, starts, sizes, [False] * n,
                                 [bs] * n, bs, False, dev), pos
