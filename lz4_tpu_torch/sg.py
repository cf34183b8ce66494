"""LZ4_SG: scatter-gather compression into a single LZ4F-compatible frame.

Counterpart of ``lz4_tpu/sg.py`` (the fork's ``lib/lz4sg.c``): a list of
input buffers is compressed into a list of output buffers as ONE
block-linked LZ4F frame with an embedded content size and no checksums,
one LZ4 block per (input remainder x output remainder) pair.  Wire
conventions, as in the JAX package:

* fixed 15-byte header, FLG = v01|linked|contentSize;
* 4-byte LE block size headers backfilled after destSize compression;
* output buffer advanced when fewer than 5 bytes remain; the gap is filled
  with a 5-byte zero-pad block {LE32 1, 0x00} split across the boundary,
  which decode validates and skips;
* 4-byte endmark, possibly split across two buffers;
* header rewritten afterwards when the largest block exceeds 64 KB or the
  content size shrank.

Every frame made here is an ordinary LZ4F frame.

The walks of ``sg_compress`` and ``sg_decompress`` run on the host over a
block codec.  With none given, they run on ``device``:

* compression as one pass of the chain encoder (kernel G,
  ``kernels/destsize_kernel.py``) whose per-step records the walk replays;
  a partial-source walk, content over ``dsk.MAX_TOTAL``, or a walk longer
  than G's steps calls a destSize compressor over kernel H instead, one
  block at a time (``dest_size_over_h``), from its first step or from the
  step the records end;
* decompression by collecting the chain's blocks in one walk and decoding
  them all at once with kernel F (``kernels/decode_kernel.
  decode_blocks_sg_raw``); a chain with a block over 64 KB or content over
  ``MAX_DEVICE_CONTENT`` goes through kernel E in linked mode, in runs
  (``device.decode_stream_runs``), and a block over 8 MB alone through
  kernel D's batch mode with the 64 KB before it as its dictionary row.

``device="cpu"`` runs the kernels' plain versions.  The port has no host
codec, and needs none: every layout ``lz4_tpu`` hands to its host path
runs over these kernels.  A chain that does not decode to the sizes its
walk collected raises ``SgChainError``.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import spec
from .device import decode_stream_runs
from .kernels import destsize_kernel as dsk
from .kernels.common import resolve_device, to_device, to_host
from .kernels.decode_kernel import (STREAM_BLOCK_CAP, STREAM_UNIT,
                                    decode_blocks, decode_blocks_sg_raw,
                                    join_payloads)
from .ops.xxhash import xxh32

BH = spec.BLOCK_HEADER_SIZE  # 4
ZERO_PAD = struct.pack("<I", 1) + b"\x00"  # 5-byte zero-pad block
# kernel F decodes at most this much content (int32 offsets, with
# headroom), as lz4_tpu's device route does; longer chains go to kernel E
MAX_DEVICE_CONTENT = 1 << 30
# the most source bytes the walk over kernel H hands to one block: H's
# widest row less the 64 KB window before the piece
H_PIECE = dsk.MAX_BLOCK - spec.WINDOW_SIZE


class SgError(ValueError):
    def __init__(self, code: int, msg: str):
        super().__init__(f"SG error {code}: {msg}")
        self.code = code


class SgChainError(SgError):
    """A block of the chain did not decode to the size the walk collected
    for it (a corrupt or non-conformant frame)."""

    def __init__(self, msg: str):
        super().__init__(0, msg)


# (src, capacity, dict_, acceleration) -> (consumed, block_bytes)
DestSizeCompressor = Callable[[bytes, int, bytes, int], Tuple[int, bytes]]
# (comp, out_cap, dict_) -> decoded bytes
BlockDecompressor = Callable[[bytes, int, bytes], bytes]


def sg_compress_bound(source_size: int, n_in: int, n_out: int) -> int:
    """LZ4_SG_compressBound, with its fudge terms (the bound is approximate
    but sufficient)."""
    if source_size > 0x7E000000 or source_size <= n_in:
        return 0
    one = spec.compress_bound(source_size // n_in)
    zero_pads = (1 + min(n_in, n_out)) * (1 + BH)
    patch = 13 + (100 if n_in == 1 else 0)
    return (spec.SG_FRAME_HEADER_SIZE + spec.ENDMARK_SIZE + patch
            + (n_in + n_out) * BH + zero_pads + one * n_in)


def _encode_sg_header(content_size: int, max_block_size: int) -> bytes:
    """The 15-byte SG frame header."""
    flg = (spec.FLG_VERSION << 6) | (0 << 5)  # blockLinked => indep bit 0
    if content_size > 0:
        flg |= 1 << 3
    bsid = 4 if max_block_size <= 64 * 1024 else 7
    desc = bytes([flg, bsid << 4]) + struct.pack("<Q", content_size)
    hc = (xxh32(desc, 0) >> 8) & 0xFF
    return struct.pack("<I", spec.FRAME_MAGIC) + desc + bytes([hc])


def sg_decode_header(buf: bytes) -> int:
    """Validate an SG frame header; return the content size.

    Raises SgError with the fork's code for bad magic (-1), version (-2),
    header checksum (-3), block checksum present (-4), content checksum
    present (-5), missing content size (-6), independent blocks (-7).
    """
    if len(buf) < spec.SG_FRAME_HEADER_SIZE:
        raise SgError(0, "header too small")
    magic = struct.unpack_from("<I", buf)[0]
    if magic != spec.FRAME_MAGIC:
        raise SgError(-1, f"invalid magic {magic:#x}")
    flg = buf[4]
    if (flg >> 6) != spec.FLG_VERSION:
        raise SgError(-2, "unsupported version")
    hc = (xxh32(buf[4:spec.SG_FRAME_HEADER_SIZE - 1], 0) >> 8) & 0xFF
    if hc != buf[spec.SG_FRAME_HEADER_SIZE - 1]:
        raise SgError(-3, "header checksum mismatch")
    if flg & (1 << 4):
        raise SgError(-4, "block checksum unsupported")
    if flg & (1 << 2):
        raise SgError(-5, "content checksum unsupported")
    if not flg & (1 << 3):
        raise SgError(-6, "content size required")
    if flg & (1 << 5):
        raise SgError(-7, "independent blocks unsupported")
    return struct.unpack_from("<Q", buf, 6)[0]


class _OutWalk:
    """Byte-position walker over a list of output bytearrays."""

    def __init__(self, bufs: List[bytearray]):
        self.bufs = bufs
        self.idx = 0
        self.pos = 0        # position within current buffer
        self.total = 0

    def remaining_in_buf(self) -> int:
        return len(self.bufs[self.idx]) - self.pos


def sg_compress(in_bufs: Sequence[bytes], out_caps: Sequence[int],
                source_size: Optional[int] = None,
                max_output: Optional[int] = None,
                acceleration: int = 1,
                dest_size_compress: Optional[DestSizeCompressor] = None,
                device="cuda",
                ) -> Tuple[int, int, List[bytes]]:
    """Compress a scatter-gather list into one frame across ``out_caps``.

    Returns ``(total_out, consumed, out_bufs)``; total_out == 0 on failure
    (the fork's convention).  Invalid arguments raise SgError (-1..-4).

    With ``dest_size_compress`` given, the walk calls it for every block.
    Without, the whole walk runs in one pass of the chain encoder on
    ``device`` (kernel G on the card, its plain version for ``"cpu"``), and
    this function replays its per-step records to place headers, zero-pads
    and the endmark; layouts outside G's envelope call kernel H one block
    at a time (``dest_size_over_h``).
    """
    in_bufs = [bytes(b) for b in in_bufs]
    n_in, n_out = len(in_bufs), len(out_caps)
    if n_in == 0:
        raise SgError(-1, "no input buffers")
    if n_out == 0:
        raise SgError(-2, "no output buffers")
    for b in in_bufs:
        if not 1 <= len(b) <= spec.SG_MAX_BLOCK_SIZE:
            raise SgError(-3, f"input buffer length {len(b)} unsupported")
    for c in out_caps:
        if c < spec.SG_MIN_OUT_BUF:
            raise SgError(-4, f"output buffer length {c} unsupported")
    if dest_size_compress is None:
        # validated first: lz4_tpu runs its device route before these checks
        dest_size_compress = _sg_device_compressor(
            in_bufs, out_caps, source_size, max_output, acceleration, device)
    content_size = sum(len(b) for b in in_bufs) if source_size is None \
        else source_size
    max_dest = sum(out_caps) if max_output is None else max_output
    if out_caps[0] < spec.SG_MIN_FIRST_OUT:
        return 0, 0, []

    outs = [bytearray(c) for c in out_caps]
    header = _encode_sg_header(content_size, 64 * 1024)

    # --- block loop (LZ4_compress_fast_sg_extState)
    # Window model: LZ4's streaming codec remembers the current contiguous
    # run (prefix) plus ONE external-dict segment -- the previous run.  With
    # non-contiguous SG buffers that means matches may only reach into the
    # current input buffer's consumed prefix and the previous input buffer.
    prev_dict = b""       # previous input buffer (ext dict segment)
    cur_prefix = b""      # consumed bytes of the current input buffer
    in_idx, in_pos = 0, 0
    total_in = 0
    ow = _OutWalk(outs)
    ow.pos = len(header)  # out_skip_size
    ow.total = len(header)
    outs[0][:len(header)] = header
    max_out_block = 0

    while total_in < content_size and ow.total + BH < max_dest:
        # reserve block header space (always fits in current buffer: the
        # advance rule below keeps >=6 bytes available here)
        hdr_idx, hdr_pos = ow.idx, ow.pos
        ow.pos += BH
        ow.total += BH

        irem = content_size - total_in
        orem = max_dest - ow.total
        i_size = min(len(in_bufs[in_idx]) - in_pos, irem)
        o_size = min(ow.remaining_in_buf(), orem)

        src_piece = in_bufs[in_idx][in_pos:in_pos + i_size]
        window = (prev_dict + cur_prefix)[-spec.WINDOW_SIZE:]
        consumed, block = dest_size_compress(src_piece, o_size, window,
                                             acceleration)
        if consumed == 0 or len(block) == 0:
            return 0, 0, []  # no progress possible
        outs[hdr_idx][hdr_pos:hdr_pos + BH] = struct.pack("<I", len(block))
        buf = outs[ow.idx]
        buf[ow.pos:ow.pos + len(block)] = block
        o_written = len(block)
        max_out_block = max(max_out_block, o_written)
        total_in += consumed
        cur_prefix += src_piece[:consumed]

        # advance input; a buffer switch rotates the window
        if consumed == i_size:
            in_idx += 1
            in_pos = 0
            prev_dict = cur_prefix
            cur_prefix = b""
            if in_idx >= n_in:
                ow.pos += o_written
                ow.total += o_written
                break
        else:
            in_pos += consumed

        # advance output
        if o_written + 1 + BH >= o_size:
            cur_rem = o_size - o_written
            end_of_block = ow.pos + o_written
            ow.idx += 1
            ow.total += o_written
            if ow.idx >= n_out:
                ow.pos = end_of_block  # keep position coherent for endmark
                ow.idx -= 1
                break
            if o_written != o_size and ow.total + BH < max_dest:
                # zero-pad block split across the boundary
                buf[end_of_block:end_of_block + cur_rem] = ZERO_PAD[:cur_rem]
                nxt = 1 + BH - cur_rem
                outs[ow.idx][:nxt] = ZERO_PAD[cur_rem:]
                ow.pos = nxt
                ow.total += 1 + BH
            else:
                ow.pos = 0
        else:
            ow.pos += o_written
            ow.total += o_written

    # --- endmark + header rewrite (LZ4_SG_compressEnd)
    out_position = ow.total
    if out_position + spec.ENDMARK_SIZE > max_dest:
        return 0, total_in, []
    # locate endmark across buffers
    pos = 0
    end_idx = None
    for i, b in enumerate(outs):
        if pos + len(b) > out_position:
            end_idx, end_off = i, out_position - pos
            break
        pos += len(b)
    if end_idx is None:
        return 0, total_in, []
    cur_rem = len(outs[end_idx]) - end_off
    if spec.ENDMARK_SIZE <= cur_rem:
        outs[end_idx][end_off:end_off + 4] = b"\x00" * 4
    else:
        if end_idx + 1 >= n_out:
            return 0, total_in, []
        outs[end_idx][end_off:] = b"\x00" * cur_rem
        outs[end_idx + 1][:4 - cur_rem] = b"\x00" * (4 - cur_rem)

    max_in_block = max(len(b) for b in in_bufs)
    max_block = max(max_in_block, max_out_block)
    if max_block > 64 * 1024 or total_in != content_size:
        new_hdr = _encode_sg_header(total_in, max_block)
        outs[0][:len(new_hdr)] = new_hdr

    return out_position + 4, total_in, [bytes(b) for b in outs]


def sg_decompress(in_bufs: Sequence[bytes], out_caps: Sequence[int],
                  compressed_size: Optional[int] = None,
                  max_output: Optional[int] = None,
                  block_decompress: Optional[BlockDecompressor] = None,
                  device="cuda",
                  ) -> Tuple[int, List[bytes]]:
    """Decompress an SG frame back into a scatter-gather list.

    Returns ``(total_out, out_bufs)``.  Block headers straddling input
    buffers are reassembled from a 5-byte scratch, zero-pad blocks are
    validated and skipped, and decode stops once the embedded content size
    is produced.

    With ``block_decompress`` given, the walk calls it for every block.
    Without, the whole chain decodes on ``device`` (kernel F; kernel E for
    blocks over 64 KB or content over MAX_DEVICE_CONTENT, kernel D for a
    block over 8 MB; their plain versions for ``"cpu"``), and a chain that
    does not decode to the walk's sizes raises SgChainError.
    """
    if block_decompress is None:
        return _sg_decompress_device(in_bufs, out_caps, compressed_size,
                                     max_output, device)
    in_bufs = [bytes(b) for b in in_bufs]
    n_in, n_out = len(in_bufs), len(out_caps)
    if n_in == 0:
        raise SgError(-1, "no input buffers")
    if n_out == 0:
        raise SgError(-2, "no output buffers")
    for b in in_bufs:
        if len(b) < 2:
            raise SgError(-3, "input buffer too small")
    for c in out_caps:
        if c < 1:
            raise SgError(-4, "output buffer too small")
    if len(in_bufs[0]) < spec.SG_FRAME_HEADER_SIZE:
        return 0, []

    original_size = sg_decode_header(in_bufs[0])
    comp_size = sum(len(b) for b in in_bufs) if compressed_size is None \
        else compressed_size
    max_out = sum(out_caps) if max_output is None else max_output
    if max_out < original_size:
        return 0, []

    outs = [bytearray(c) for c in out_caps]
    window = b""
    in_idx, in_pos = 0, spec.SG_FRAME_HEADER_SIZE
    out_idx, out_pos = 0, 0
    total_in = in_pos
    total_out = 0

    pending_block_size = None  # set when a straddled header was consumed
    while True:
        if pending_block_size is None:
            # loop guard only applies when a fresh header must be read
            if not (total_in + BH < comp_size and total_out < original_size):
                break
            cbs = struct.unpack_from("<I",
                                     in_bufs[in_idx], in_pos)[0]
            if cbs > spec.SG_MAX_BLOCK_SIZE:
                raise SgError(-int(cbs) if cbs else -1,
                              f"unsupported compressed block size {cbs}")
            in_pos += BH
            total_in += BH
        else:
            cbs = pending_block_size
            pending_block_size = None
            if cbs > spec.SG_MAX_BLOCK_SIZE:
                raise SgError(-int(cbs) if cbs else -1,
                              f"unsupported compressed block size {cbs}")

        irem = comp_size - total_in
        orem = original_size - total_out
        i_size = min(len(in_bufs[in_idx]) - in_pos, irem)
        o_size = min(out_caps[out_idx] - out_pos, orem)
        if cbs > i_size:
            raise SgError(-int(cbs), "compressed block larger than input rem")

        comp = in_bufs[in_idx][in_pos:in_pos + cbs]
        decoded = block_decompress(comp, o_size, window)
        o_written = len(decoded)
        outs[out_idx][out_pos:out_pos + o_written] = decoded
        window = (window + decoded)[-spec.WINDOW_SIZE:]
        total_in += cbs
        total_out += o_written

        # advance output (exact fill advances the buffer)
        if o_written == o_size:
            out_idx += 1
            out_pos = 0
            if out_idx >= n_out:
                break
        else:
            out_pos += o_written

        # advance input; handle straddled headers / zero-pads
        i_used = cbs
        if i_used + 1 + BH >= i_size:
            cur_rem = i_size - i_used
            tail_start = in_pos + i_used
            in_idx += 1
            if in_idx >= n_in:
                break
            if i_used != i_size and total_in + BH < comp_size:
                scratch = (in_bufs[in_idx - 1][tail_start:tail_start + cur_rem]
                           + in_bufs[in_idx][:1 + BH - cur_rem])
                nxt_size = struct.unpack_from("<I", scratch)[0]
                in_pos = 1 + BH - cur_rem
                total_in += 1 + BH
                if nxt_size == 1:
                    if scratch[BH] != 0:
                        raise SgError(-total_in, "invalid zero-pad block")
                    # valid pad: skip it
                else:
                    # real block whose header straddles: resume with it
                    in_pos -= 1
                    total_in -= 1
                    pending_block_size = nxt_size
            else:
                in_pos = 0
        else:
            in_pos += i_used

    return total_out, [bytes(b) for b in outs]


# ---------------------------------------------------------------------------
# the device routes
# ---------------------------------------------------------------------------

def dest_size_over_h(device, tally: Optional[dict] = None
                     ) -> DestSizeCompressor:
    """A destSize compressor over kernel H on ``device``: ``[window |
    piece]`` in one row, the window as the row's prefix, at most H_PIECE
    source bytes a block (the walk takes the rest in later blocks).  Counts
    its blocks and its capacity stops (blocks that cover less than the
    piece they were given) in ``tally``, when given."""
    dev = resolve_device(device)

    def compress(src, capacity, dict_, acceleration):
        src = src[:H_PIECE]
        used = len(dict_) + len(src)
        ns = max(-(-used // 128) * 128, 128)
        row = np.zeros((ns,), np.uint8)
        row[:used] = np.frombuffer(dict_ + src, np.uint8)

        def i32(v):
            return torch.tensor([v], dtype=torch.int32, device=dev)

        out, olen, consumed = dsk.encode_blocks_dest_size(
            to_device(row, dev).reshape(1, ns), i32(len(src)),
            i32(min(capacity, (1 << 31) - 1)), acceleration,
            window_lens=i32(len(dict_)))
        olen, took = to_host(torch.cat([olen, consumed])).tolist()
        if tally is not None:
            tally["blocks"] = tally.get("blocks", 0) + 1
            tally["stops"] = tally.get("stops", 0) + (took < len(src))
        return took, to_host(out[0, :olen]).tobytes()

    return compress


def sg_scripted_replay(blocks: bytes, boff, blen, consumed, isz, osz,
                       live: int, rest: DestSizeCompressor
                       ) -> DestSizeCompressor:
    """DestSizeCompressor that replays the chain encoder's per-step records
    into the walk, while the walk presents exactly the source piece and
    capacity the encoder assumed; from the first step where it does not,
    or past the encoder's ``live`` steps, every call goes to ``rest``."""
    steps = iter(range(live))
    replaying = True

    def scripted(src_piece, o_size, window, accel):
        nonlocal replaying
        if replaying:
            t = next(steps, None)
            if t is not None and len(src_piece) == int(isz[t]) \
                    and o_size == int(osz[t]):
                b = int(boff[t])
                return int(consumed[t]), blocks[b:b + int(blen[t])]
            replaying = False            # the records end here
        return rest(src_piece, o_size, window, accel)

    return scripted


def _sg_device_compressor(in_bufs, out_caps, source_size, max_output,
                          acceleration, device) -> DestSizeCompressor:
    """The device's DestSizeCompressor for one walk: the whole walk in one
    pass of the chain encoder on ``device``, replayed step by step; a
    partial-source walk or content over ``dsk.MAX_TOTAL`` (outside the
    chain encoder's envelope) goes over kernel H from its first block, a
    walk longer than the encoder's steps from its first step past them."""
    over_h = dest_size_over_h(device)
    total = sum(len(b) for b in in_bufs)
    if total > dsk.MAX_TOTAL or (source_size is not None
                                 and source_size != total):
        return over_h
    max_dest = sum(out_caps) if max_output is None else max_output
    flat, in_ends = dsk.sg_chain_input(in_bufs, resolve_device(device))
    blocks, boff, blen, consumed, isz, osz = dsk.sg_encode_chain(
        flat, in_ends, np.asarray(out_caps, np.int64), max_dest,
        acceleration)
    # the per-step records in one transfer
    boff, blen, consumed, isz, osz = to_host(torch.stack(
        [boff, blen.long(), consumed.long(), isz.long(), osz.long()]))
    live = int((blen >= 0).sum())
    # one fetch of every live step's block bytes
    end = int(boff[live - 1] + blen[live - 1]) if live else 0
    return sg_scripted_replay(to_host(blocks[:end]).tobytes(), boff, blen,
                              consumed, isz, osz, live, over_h)


def decoded_length(comp: bytes) -> int:
    """The length an LZ4 block decodes to, from its tokens alone (offsets
    are not checked), or -1 when its sequences do not end at its last byte
    with a literal-only sequence."""
    n, ip, total = len(comp), 0, 0
    while ip < n:
        token = comp[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    return -1
                b = comp[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        ip += lit
        total += lit
        if ip == n:
            return total
        if ip + 2 > n:
            return -1
        ip += 2
        ml = (token & 15) + 4
        if ml == 19:
            while True:
                if ip >= n:
                    return -1
                b = comp[ip]
                ip += 1
                ml += b
                if b != 255:
                    break
        total += ml
    return -1


def collect_chain(in_bufs, out_caps, compressed_size=None, max_output=None):
    """Walk an SG frame's iovec list once on the host with a collecting
    stand-in codec that returns as many bytes as each block's tokens say it
    decodes to.  Returns (total_out, payloads, sizes): the chain's blocks in
    order, each decoding to sizes[k] bytes at sum(sizes[:k]) of the
    content.

    lz4_tpu's stand-in returns the whole output slice instead, which holds
    only for blocks that fill their slice; a capacity-stopped block (most
    blocks of 4 KB iovecs) sends it to its host codec.
    """
    payloads, sizes = [], []

    def collector(comp, out_cap, dict_):
        if len(comp) == 1 and comp == b"\x00":
            return b""           # empty block: contributes nothing
        size = decoded_length(comp)
        if not 0 <= size <= out_cap:
            raise SgChainError(f"block {len(payloads)} of the chain is "
                               f"malformed or decodes past its {out_cap} "
                               "bytes of output")
        payloads.append(bytes(comp))
        sizes.append(size)
        return bytes(size)

    total, _ = sg_decompress(in_bufs, out_caps, compressed_size,
                             max_output, block_decompress=collector)
    return total, payloads, sizes


def decode_chain_linked(payloads: Sequence[bytes], sizes: Sequence[int],
                        dev: torch.device) -> Tuple[bytes, np.ndarray]:
    """Decode a linked chain of compressed blocks, block k to at most
    ``sizes[k]`` bytes with everything decoded before it as its window:
    runs of blocks of at most 8 MB through kernel E (``decode_stream_runs``),
    a block over 8 MB alone through kernel D's batch mode with the 64 KB
    before it as its dictionary row.  Returns (the good blocks' bytes in
    order, olen per block, -1 for a block that failed), as one call of
    kernel E in linked mode over the chain would."""
    olen = np.zeros((len(payloads),), np.int64)
    parts: List[bytes] = []
    window = b""
    k = 0
    while k < len(payloads):
        j = k
        while j < len(payloads) and sizes[j] <= STREAM_BLOCK_CAP:
            j += 1
        if j > k:                        # blocks k..j-1 through kernel E
            flat = b"".join(payloads[k:j])
            starts = np.cumsum([0] + [len(p) for p in payloads[k:j]])
            caps = list(sizes[k:j])
            bs = -(-max(max(caps), 1) // STREAM_UNIT) * STREAM_UNIT
            got, olen[k:j] = decode_stream_runs(
                flat, starts[:-1].tolist(), np.diff(starts).tolist(),
                [0] * (j - k), caps, bs, True, dev, window=window)
        else:                            # block k, over 8 MB, through D
            comp = torch.from_numpy(np.frombuffer(payloads[k], np.uint8)
                                    .copy()).reshape(1, -1).to(dev)
            dict_row = torch.zeros((1, spec.WINDOW_SIZE), dtype=torch.uint8)
            if window:
                dict_row[0, spec.WINDOW_SIZE - len(window):] = \
                    torch.frombuffer(bytearray(window), dtype=torch.uint8)
            out, ol = decode_blocks(
                comp, torch.tensor([comp.shape[1]], dtype=torch.int32,
                                   device=dev), sizes[k],
                dict_rows=dict_row.to(dev),
                dict_lens=torch.tensor([len(window)], dtype=torch.int32,
                                       device=dev))
            olen[k] = int(to_host(ol)[0])
            got = to_host(out[0, :max(olen[k], 0)]).tobytes()
            j = k + 1
        if got:
            parts.append(got)
            window = (window + got[-spec.WINDOW_SIZE:])[-spec.WINDOW_SIZE:]
        k = j
    return b"".join(parts), olen


def _sg_decompress_device(in_bufs, out_caps, compressed_size, max_output,
                          device):
    """Device scatter-gather decode: collect the chain in one host walk,
    decode it all at once on ``device`` and slice the content into the
    output buffers."""
    dev = resolve_device(device)
    total, payloads, sizes = collect_chain(in_bufs, out_caps,
                                           compressed_size, max_output)
    if not payloads:
        return total, [bytes(bytearray(c)) for c in out_caps]
    if total > MAX_DEVICE_CONTENT or max(sizes) > spec.WINDOW_SIZE:
        # blocks over 64 KB (the fork allows any size within the output
        # buffers) or content past kernel F: a linked chain through E (and
        # D), each block capped at its collected size
        content, olen = decode_chain_linked(payloads, sizes, dev)
    else:
        flat, bstart, clen = join_payloads(payloads, dev)
        out, olen = decode_blocks_sg_raw(flat, bstart, clen, sizes)
        olen = to_host(olen)
        content = None
    if (olen != np.asarray(sizes, olen.dtype)).any():
        bad = int(np.nonzero(olen != np.asarray(sizes, olen.dtype))[0][0])
        raise SgChainError(f"block {bad} of the chain decoded to "
                           f"{int(olen[bad])} bytes, not {sizes[bad]}")
    if content is None:
        content = to_host(out[:total]).tobytes()
    return total, fill_buffers(content, total, out_caps)


def fill_buffers(content: bytes, total: int, out_caps) -> List[bytes]:
    """A decoded frame's output list: its first ``total`` content bytes cut
    into buffers of ``out_caps`` bytes, zeros past the content."""
    outs = []
    pos = 0
    for cap in out_caps:
        take = min(cap, max(total - pos, 0))
        buf = bytearray(cap)
        buf[:take] = content[pos:pos + take]
        outs.append(bytes(buf))
        pos += take
    return outs
