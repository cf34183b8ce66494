"""The one-shot block API (the ``lz4.h`` simple functions) with the block
work on the device, and the batch hooks.

Counterpart of ``lz4_tpu/block.py``, name for name:

  ``LZ4_compress_default``        -> :func:`compress_default`
  ``LZ4_compress_fast``           -> :func:`compress_fast`
  ``LZ4_compress_destSize``       -> :func:`compress_dest_size`
  ``LZ4_decompress_safe``         -> :func:`decompress_safe`
  ``LZ4_decompress_safe_partial`` -> :func:`decompress_safe_partial`
  ``LZ4_decompress_fast``         -> :func:`decompress_fast`
  the fork's destSize decode      -> :func:`decompress_dest_size`
  ``LZ4_compressBound``           -> :func:`compress_bound`

``lz4_tpu`` sends single buffers to its host codec; the port has none, and
runs each call on the kernels:

* ``compress_fast`` up to 256 KB: kernel B on a row of one (the row width a
  multiple of 128); above 256 KB, kernel A's linked chain without a prefix,
  its payloads joined into one block (``device.chain_block``).
* ``compress_dest_size``: kernel H on one row.  A source past H's row
  (256 KB) gives H its first 256 KB.
* the decoders: a walk over the block's token lengths on the host (no byte
  is decoded there) finds how far the call reads and writes, and raises
  where ``lz4_tpu`` raises, with its message; kernel D then decodes that
  prefix of the block, in batch mode (``decompress_safe``,
  ``decompress_fast``) or in its resumable mode (``decompress_dest_size``,
  ``decompress_safe_partial``, whose source may end right after a match),
  with the last 64 KB of the dictionary as a right-aligned dictionary row.
  The output row is sized from the walk, not from ``max_output``.

The encoders parse as the kernels do, so their blocks differ from
``lz4_tpu``'s host codec (which indexes every 5-byte string exactly); each
decodes to its input through either package.  With ``capacity``,
``compress_fast`` returns ``b""`` when the kernel's block is longer.

Every function takes ``device``; the default ``"cuda"`` raises on a machine
without a card, and ``"cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .device import (byte_rows, chain_block, decode_batch, encode_batch,
                     window_tensor)
from .kernels import destsize_kernel as dsk
from .kernels.common import resolve_device, to_device, to_host
from .kernels.decode_kernel import decode_blocks, decode_blocks_dest_size
from .kernels.encode_kernel import MAX_BLOCK
from .spec import MINMATCH, compress_bound  # noqa: F401  (re-export)

# the longest output row kernel D takes (int32 lengths)
MAX_DECODED = (1 << 31) - 1


class Lz4BlockError(ValueError):
    """A malformed block, an offset out of range, or output overflow."""


def _row_width(n: int) -> int:
    return max(-(-n // 128) * 128, 128)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def compress_default(src: bytes, capacity: Optional[int] = None,
                     device="cuda") -> bytes:
    """``LZ4_compress_default``: one block, acceleration 1; ``b""`` when
    ``capacity`` is given and the block would not fit."""
    return compress_fast(src, 1, capacity, device=device)


def compress_fast(src: bytes, acceleration: int = 1,
                  capacity: Optional[int] = None, device="cuda") -> bytes:
    """``LZ4_compress_fast``: one block of ``src`` at ``acceleration``.
    Up to 256 KB kernel B encodes it on a row of one; above, kernel A's
    chain, joined.  With ``capacity``, ``b""`` when the block is longer."""
    dev = resolve_device(device)
    src = bytes(src)
    acceleration = max(1, int(acceleration))
    if len(src) <= MAX_BLOCK:
        rows, lens = encode_batch([src], _row_width(len(src)), acceleration,
                                  device=dev)
        out = rows[0, :lens[0]].tobytes()
    else:
        out, _ = chain_block(src, None, acceleration, device=dev)
    if capacity is not None and len(out) > capacity:
        return b""
    return out


def dest_size_row(src: bytes, capacity: int, acceleration: int,
                  window: Optional[torch.Tensor], dev):
    """Kernel H on one row ``[window | source]``: the source (at most the
    row's 256 KB less the window) into at most ``capacity`` bytes, matching
    into ``window`` (a 1-D uint8 tensor on the device, or None).  Returns
    (block, source bytes consumed, the row as a 1-D tensor on the
    device)."""
    wlen = 0 if window is None else window.numel()
    src = src[:MAX_BLOCK - wlen]
    ns = _row_width(wlen + len(src))
    row = torch.zeros((1, ns), dtype=torch.uint8, device=dev)
    if wlen:
        row[0, :wlen] = window
    if src:
        row[0, wlen:wlen + len(src)] = to_device(src, dev)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    out, olen, consumed = dsk.encode_blocks_dest_size(
        row, i32(len(src)), i32(max(min(capacity, (1 << 31) - 1), -1)),
        acceleration, window_lens=i32(wlen))
    n, took = to_host(torch.cat([olen, consumed])).tolist()
    return to_host(out[0, :n]).tobytes(), took, row[0]


def compress_dest_size(src: bytes, capacity: int, acceleration: int = 1,
                       device="cuda") -> Tuple[bytes, int]:
    """``LZ4_compress_destSize``: fill at most ``capacity`` bytes with one
    block of a prefix of ``src``; returns (block, source bytes consumed).
    Kernel H, one row; a source past its 256 KB row gives H its first
    256 KB, so at most that much is consumed a call."""
    return dest_size_row(bytes(src), capacity, max(1, int(acceleration)),
                         None, resolve_device(device))[:2]


# ---------------------------------------------------------------------------
# the length walks: how far a decode reads and writes, and lz4_tpu's verdict
# ---------------------------------------------------------------------------

def _ext(comp, i: int, n: int, what: str):
    """A length extension at ``i``: (sum, next i); raises ``what`` when the
    block ends inside it."""
    total = 0
    while True:
        if i >= n:
            raise Lz4BlockError(what)
        b = comp[i]
        i += 1
        total += b
        if b != 255:
            return total, i


def walk_safe(comp: bytes, max_output: int, nd: int = 0,
              partial: bool = False) -> Tuple[int, int, int]:
    """The checks of ``LZ4_decompress_safe`` (``partial``: ``_partial``,
    which stops once ``max_output`` bytes are made), on lengths and offsets
    alone, in ``lz4_tpu``'s order and with its messages; ``nd`` is the
    dictionary's length.  Returns (source bytes to decode, the bytes they
    decode to, the bytes to keep): the source ends at the end of the
    block, or, when partial, at the end of the literals or of the match
    that reaches ``max_output``."""
    n = len(comp)
    if n == 0:
        raise Lz4BlockError("empty input")
    out, i = 0, 0
    while True:
        if i >= n:
            raise Lz4BlockError("truncated: missing token")
        token = comp[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            ext, i = _ext(comp, i, n, "truncated literal length")
            litlen += ext
        if i + litlen > n:
            raise Lz4BlockError("truncated literals")
        i += litlen
        if out + litlen > max_output:
            if partial:
                return i, out + litlen, max_output
            raise Lz4BlockError("output too small (literals)")
        out += litlen
        if i == n:
            return n, out, out
        if partial and out >= max_output:
            return i, out, max_output
        if i + 2 > n:
            raise Lz4BlockError("truncated offset")
        offset = comp[i] | (comp[i + 1] << 8)
        i += 2
        if offset == 0:
            raise Lz4BlockError("invalid offset 0")
        mlen = token & 15
        if mlen == 15:
            ext, i = _ext(comp, i, n, "truncated match length")
            mlen += ext
        mlen += MINMATCH
        if offset > out + nd:
            raise Lz4BlockError("offset beyond window")
        if out + mlen > max_output and not partial:
            raise Lz4BlockError("output too small (match)")
        out += mlen
        if partial and out >= max_output:
            return i, out, max_output


def walk_dest_size(comp: bytes, dest_capacity: int,
                   nd: int = 0) -> Tuple[int, int]:
    """The resumable destSize decode's stops on lengths and offsets alone,
    as ``lz4_tpu`` makes them: (source bytes consumed, bytes produced).  A
    sequence that is cut short or does not fit stops the walk at its token;
    offset 0 and an offset past the window raise."""
    n = len(comp)
    out, i = 0, 0
    while True:
        tok = i
        if i >= n:
            return tok, out
        token = comp[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            try:
                ext, i = _ext(comp, i, n, "")
            except Lz4BlockError:
                return tok, out
            litlen += ext
        if i + litlen > n or out + litlen > dest_capacity:
            return tok, out
        i += litlen
        if i == n:
            return n, out + litlen
        if i + 2 > n:
            return tok, out
        offset = comp[i] | (comp[i + 1] << 8)
        i += 2
        if offset == 0:
            raise Lz4BlockError("invalid offset 0")
        mlen = token & 15
        if mlen == 15:
            try:
                ext, i = _ext(comp, i, n, "")
            except Lz4BlockError:
                return tok, out
            mlen += ext
        mlen += MINMATCH
        if offset > out + litlen + nd:
            raise Lz4BlockError("offset beyond window")
        if out + litlen + mlen > dest_capacity:
            return tok, out
        out += litlen + mlen


def walk_fast(comp: bytes, original_size: int) -> int:
    """``LZ4_decompress_fast``'s end of block: the compressed bytes that
    decode to exactly ``original_size`` bytes, by token lengths alone."""
    n = len(comp)
    produced, i = 0, 0
    while True:
        if i >= n:
            raise Lz4BlockError("truncated: missing token")
        token = comp[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            ext, i = _ext(comp, i, n, "truncated literal length")
            litlen += ext
        i += litlen
        produced += litlen
        if produced == original_size:
            break
        if i + 2 > n:
            raise Lz4BlockError("truncated offset")
        i += 2
        mlen = token & 15
        if mlen == 15:
            ext, i = _ext(comp, i, n, "truncated match length")
            mlen += ext
        produced += mlen + MINMATCH
        if produced > original_size:
            raise Lz4BlockError("block does not decode to original_size")
    if i > n:
        raise Lz4BlockError("truncated literals")
    return i


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

def _window_args(window: Optional[torch.Tensor]):
    """(dict_rows, dict_lens) of kernel D for a 1-D window tensor."""
    if window is None or not window.numel():
        return None, None
    return (window.reshape(1, -1),
            torch.tensor([window.numel()], dtype=torch.int32,
                         device=window.device))


def decode_prefix(comp: bytes, src_end: int, out_end: int,
                  window: Optional[torch.Tensor], resumable: bool,
                  dev) -> torch.Tensor:
    """Kernel D on ``comp[:src_end]``, which a walk found to decode to
    exactly ``out_end`` bytes behind ``window`` (a 1-D uint8 tensor of at
    most 64 KB on ``dev``, or None): batch mode, or the resumable mode for
    a source that may end right after a match.  Returns the bytes as a 1-D
    tensor on ``dev``; raises Lz4BlockError if the kernel disagrees with
    the walk."""
    if out_end > MAX_DECODED:
        raise Lz4BlockError(f"the block decodes to {out_end} bytes, past "
                            f"kernel D's row of {MAX_DECODED}")
    if out_end == 0:
        return torch.empty((0,), dtype=torch.uint8, device=dev)
    rows, lens = byte_rows([comp[:src_end]], src_end, dev)
    dict_rows, dict_lens = _window_args(window)
    if resumable:
        out, olen, cons = decode_blocks_dest_size(
            rows, lens, torch.tensor([out_end], dtype=torch.int32,
                                     device=dev), out_end,
            dict_rows=dict_rows, dict_lens=dict_lens)
        got = to_host(torch.cat([olen, cons])).tolist()
        want = [out_end, src_end]
    else:
        out, olen = decode_blocks(rows, lens, out_end, dict_rows=dict_rows,
                                  dict_lens=dict_lens)
        got, want = to_host(olen).tolist(), [out_end]
    if got != want:
        raise Lz4BlockError(f"kernel D decoded {got}, the walk {want}")
    return out[0]


def _dict_window(dict_: bytes, dev) -> Optional[torch.Tensor]:
    return window_tensor(dict_, dev) if dict_ else None


def decompress_safe(comp: bytes, max_output: int, dict_: bytes = b"",
                    device="cuda") -> bytes:
    """``LZ4_decompress_safe`` / ``_usingDict``: decode one block into at
    most ``max_output`` bytes, ``dict_`` the history right before its
    output; raises :class:`Lz4BlockError` where ``lz4_tpu`` does."""
    dev = resolve_device(device)
    comp, dict_ = bytes(comp), bytes(dict_)
    src_end, out_end, _ = walk_safe(comp, max_output, len(dict_))
    return to_host(decode_prefix(comp, src_end, out_end,
                                 _dict_window(dict_, dev), False,
                                 dev)).tobytes()


def decompress_safe_partial(comp: bytes, target: int,
                            device="cuda") -> bytes:
    """``LZ4_decompress_safe_partial``: the first ``target`` decoded bytes
    (fewer when the block ends first), stopping in the middle of a
    sequence if need be; the rest of the block is not read.  Kernel D
    decodes through the end of the sequence that reaches ``target``; the
    host keeps ``target`` bytes."""
    dev = resolve_device(device)
    comp = bytes(comp)
    src_end, out_end, keep = walk_safe(comp, target, 0, partial=True)
    out = decode_prefix(comp, src_end, out_end, None, True, dev)
    return to_host(out[:keep]).tobytes()


def decompress_dest_size(comp: bytes, dest_capacity: int,
                         dict_: bytes = b"",
                         device="cuda") -> Tuple[bytes, int]:
    """The fork's resumable destSize decode: at most ``dest_capacity``
    bytes, stopping at a token boundary.  Returns (produced, source bytes
    consumed); the block is done when all of ``comp`` is consumed.  Kernel
    D's resumable mode decodes the consumed prefix."""
    dev = resolve_device(device)
    comp, dict_ = bytes(comp), bytes(dict_)
    consumed, produced = walk_dest_size(comp, dest_capacity, len(dict_))
    out = decode_prefix(comp, consumed, produced, _dict_window(dict_, dev),
                        True, dev)
    return to_host(out).tobytes(), consumed


def decompress_fast(comp: bytes, original_size: int, dict_: bytes = b"",
                    device="cuda") -> Tuple[bytes, int]:
    """``LZ4_decompress_fast`` / ``_fast_usingDict``: decode exactly
    ``original_size`` bytes and report the compressed bytes read, so that
    callers can walk concatenated blocks.  A walk over the token lengths
    finds the block's end; kernel D decodes it, bounds-checked."""
    dev = resolve_device(device)
    comp, dict_ = bytes(comp), bytes(dict_)
    end = walk_fast(comp, original_size)
    try:
        out = decode_prefix(comp, end, original_size,
                            _dict_window(dict_, dev), False, dev)
    except Lz4BlockError:
        walk_safe(comp[:end], original_size, len(dict_))  # lz4_tpu's error
        raise
    return to_host(out).tobytes(), end


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def compress_batch(buffers: List[bytes], block_size: int = 65536,
                   acceleration: int = 1, min_match: int = 4,
                   device="cuda") -> List[bytes]:
    """Compress every buffer (each at most ``block_size`` bytes, up to
    256 KB) as one LZ4 block: one launch of the independent-row encoder
    (kernel B).  Returns the compressed blocks."""
    rows, lens = encode_batch(buffers, block_size, acceleration, min_match,
                              device=device)
    return [rows[i, :lens[i]].tobytes() for i in range(len(buffers))]


def decompress_batch(comp_list: List[bytes], out_cap: int,
                     out_lens: Optional[List[int]] = None,
                     device="cuda") -> List[bytes]:
    """Decode a list of independent blocks (kernel D, batch mode), each to
    at most ``out_cap`` bytes, or to at most ``out_lens[i]``.  Returns the
    decoded byte strings; raises Lz4FrameError naming the first malformed
    block."""
    return decode_batch(comp_list, out_cap, out_lens, device=device)


__all__ = ["Lz4BlockError", "compress_bound", "compress_default",
           "compress_fast", "compress_dest_size", "decompress_safe",
           "decompress_safe_partial", "decompress_dest_size",
           "decompress_fast", "compress_batch", "decompress_batch"]
