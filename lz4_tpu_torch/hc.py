"""The HC block API (``lz4hc.h``) with the block work on the device.

Counterpart of ``lz4_tpu/hc.py``, name for name:

  ``LZ4_compress_HC`` / ``LZ4_compress_HC_continue`` -> :func:`compress_hc_block`
  the fork's HC destSize                           -> :func:`compress_hc_dest_size`
  ``LZ4_streamHC_t`` and its calls                 -> :class:`HcCompressStream`

``lz4_tpu`` runs these on its host HC codec; the port has none, and runs
them on kernel I (``kernels/hc_kernel.encode_blocks_hc``):

* A source is cut into pieces of 64 KB.  Each piece is one row of kernel I
  behind the 64 KB of history before it (the end of ``dict_`` or of the
  stream's window for the first piece, the content before it for the
  others), so its matches reach into that history; the pieces go through
  one launch (``device.HC_GROUP_ROWS`` rows a launch), and their payloads
  are joined into one block from the kernel's ``tails``
  (``legacy.merge_payloads``).  A source of 64 KB or less without history
  is one row, and its block is kernel I's row byte for byte.
* ``capacity`` (``compress_hc_block``, ``compress_continue``): the block,
  or ``b""`` when it is longer.  Kernel I's sequences never depend on the
  capacity, so this is ``lz4_tpu``'s answer (``b""`` unless the whole
  source fits).
* ``compress_hc_dest_size`` applies ``lz4_tpu``'s capacity rule to kernel
  I's block on the host, by a walk over its sequences' lengths (no byte is
  parsed there): it keeps the sequences before the first one that does not
  fit with its tail, then the most final literals that fit.  Where the rule
  asks for a parse of a shorter source, kernel I runs again on it.
* ``HcCompressStream`` keeps the last 64 KB of its history on the device,
  as ``stream.BlockCompressStream`` does.

The blocks parse as kernel I does, not as ``lz4_tpu``'s host HC; each
decodes to its input through either package.  ``FrameCompressor`` and
``compress_frame`` write their HC blocks through :func:`hc_payloads`.

Every entry point takes ``device``; the default ``"cuda"`` raises on a
machine without a card, and ``"cpu"`` runs kernel I's plain version.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import spec
from .device import HC_GROUP_ROWS, _fetch_payloads, join_block, window_tensor
from .kernels.common import resolve_device, to_device, to_host
from .kernels.destsize_kernel import _max_final_literals
from .kernels.encode_kernel import _final_run_size
from .kernels.hc_kernel import MAX_BLOCK, TABLE_ROWS, encode_blocks_hc
from .legacy import _ext, _literal_run, literal_head

__all__ = ["DEFAULT_CLEVEL", "MAX_CLEVEL", "compress_hc_block",
           "compress_hc_dest_size", "HcCompressStream"]

DEFAULT_CLEVEL = 9
MAX_CLEVEL = 16
PIECE = MAX_BLOCK           # source bytes of one row of kernel I
WINDOW = spec.WINDOW_SIZE


def _level(level) -> int:
    return max(1, min(MAX_CLEVEL, level or DEFAULT_CLEVEL))


def _pieces(n: int, block: int, history: int, linked: bool):
    """(source start, length, prefix length) of every piece of ``n`` bytes
    cut into blocks of ``block`` bytes, and the pieces of each block.  A
    piece after a block's first has the 64 KB before it as its prefix; a
    block's first has the history before it (``history`` bytes before the
    content, then the content) when ``linked``, else none.  Empty content
    is one empty piece."""
    pieces, per_block = [], []
    for b0 in range(0, max(n, 1), block):
        b1 = min(b0 + block, n)
        starts = range(b0, max(b1, b0 + 1), PIECE)
        for s in starts:
            first = min(PIECE, s + history) if linked else 0
            pieces.append((s, min(PIECE, b1 - s),
                           PIECE if s > b0 else first))
        per_block.append(len(starts))
    return pieces, per_block


def _rows(hist: torch.Tensor, at: List[int], lens: List[int], ns: int):
    """[R, ns] uint8 rows on ``hist``'s device: row r holds
    ``hist[at[r]:at[r] + lens[r]]``, zero padded; gathered TABLE_ROWS rows
    at a time."""
    dev = hist.device
    rows = torch.zeros((len(at), ns), dtype=torch.uint8, device=dev)
    if not hist.numel():
        return rows
    cols = torch.arange(ns, device=dev)
    at_t = torch.tensor(at, dtype=torch.int64, device=dev)
    len_t = torch.tensor(lens, dtype=torch.int64, device=dev)
    for g in range(0, len(at), TABLE_ROWS):
        idx = (at_t[g:g + TABLE_ROWS, None] + cols).clamp_(
            max=hist.numel() - 1)
        rows[g:g + TABLE_ROWS] = torch.where(
            cols < len_t[g:g + TABLE_ROWS, None], hist[idx], 0)
    return rows


def hc_payloads(data: bytes, block: int, window: Optional[torch.Tensor],
                linked: bool, level: int, device="cuda"):
    """Kernel I over ``data`` cut into blocks of ``block`` bytes (the last
    may be shorter), each block into 64 KB pieces, each piece a row behind
    its prefix (``_pieces``; with ``linked``, block 0's first piece sits
    behind ``window``, a 1-D uint8 tensor of at most 64 KB on the device,
    or None), HC_GROUP_ROWS rows a launch, each launch's input uploaded and
    its payloads fetched in one copy.

    Returns (a list per block of (payload views, tails), which
    ``device.join_block`` joins into the block; with ``linked``, the last
    64 KB of ``window`` and ``data`` as a tensor on the device, else
    None)."""
    dev = resolve_device(device)
    n = len(data)
    if window is not None and window.numel() > WINDOW:
        raise ValueError("a window holds at most 64 KB")
    w0 = window.numel() if linked and window is not None else 0
    pieces, per_block = _pieces(n, block, w0, linked)
    views, tails, hist = [], [], None

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    for g in range(0, len(pieces), HC_GROUP_ROWS):
        grp = pieces[g:g + HC_GROUP_ROWS]
        # the group's span of the history: window, then data
        lo = min(w0 + s - wl for s, _, wl in grp)
        hi = max(w0 + s + z for s, z, _ in grp)
        hist = to_device(data[max(lo - w0, 0):hi - w0], dev)
        if lo < w0:
            hist = torch.cat([window[lo:], hist])
        ns = max(-(-max(wl + z for _, z, wl in grp) // 128) * 128, 128)
        rows = _rows(hist, [w0 + s - wl - lo for s, _, wl in grp],
                     [wl + z for _, z, wl in grp], ns)
        wls = [wl for _, _, wl in grp]
        out, olen, tl = encode_blocks_hc(
            rows, i32([z for _, z, _ in grp]), level, tails=True,
            window_lens=i32(wls) if any(wls) else None)
        flat, olen_h, tails_h = _fetch_payloads(out, olen, tl)
        ends = np.cumsum(olen_h)
        views += [flat[e - k:e] for e, k in zip(ends.tolist(),
                                                 olen_h.tolist())]
        tails += tails_h.tolist()
    groups, at = [], 0
    for k in per_block:
        groups.append((views[at:at + k], tails[at:at + k]))
        at += k
    if not linked:
        return groups, None
    # the last row reaches back 64 KB, or to the start of the history
    return groups, (hist[-WINDOW:].clone() if n else window)


def _hc_block(src: bytes, window: Optional[torch.Tensor], level: int,
              dev) -> Tuple[bytes, Optional[torch.Tensor]]:
    """``src`` as ONE block behind ``window`` (the history right before it
    on the device, or None): its pieces through kernel I, joined.  Returns
    (block, the new window on the device)."""
    groups, win = hc_payloads(src, max(len(src), 1), window, True, level,
                              dev)
    views, tails = groups[0]
    return join_block(views, tails), win


def _dict_window(dict_: bytes, dev) -> Optional[torch.Tensor]:
    dict_ = bytes(dict_)
    return window_tensor(dict_, dev) if dict_ else None


def compress_hc_block(src, level: int = DEFAULT_CLEVEL, dict_: bytes = b"",
                      capacity: Optional[int] = None,
                      device="cuda") -> bytes:
    """``LZ4_compress_HC``: one block of ``src`` at HC ``level``; ``dict_``
    is the history right before it (its last 64 KB are used;
    ``LZ4_compress_HC_continue``).  With ``capacity``, ``b""`` unless the
    whole block fits."""
    dev = resolve_device(device)
    block, _ = _hc_block(bytes(src), _dict_window(dict_, dev),
                         _level(level), dev)
    if capacity is not None and len(block) > capacity:
        return b""
    return block


def _capacity_cut(block: bytes, src: bytes, capacity: int):
    """``lz4_tpu.hc``'s capacity rule on ``block``, the full block of
    ``src``, by a walk over its sequences' lengths: (consumed, the bounded
    block), or (None, k) when the rule asks for a parse of ``src[:k]``."""
    n = len(src)
    i = kept = anchor = 0
    while True:
        t = i
        lit, i = _literal_run(block, i)
        i += lit
        if i >= len(block):
            break                               # the final run
        ml, i = (_ext(block, i + 2, 15) if block[t] & 15 == 15
                 else (block[t] & 15, i + 2))
        mp, ml = anchor + lit, ml + 4
        # the sequence (it ends at i) and a final run of its tail
        if i + _final_run_size(min(spec.LASTLITERALS, n - (mp + ml))) \
                > capacity:
            break
        anchor, kept = mp + ml, i
    avail = n - anchor
    lit = _max_final_literals(capacity - kept, avail)
    if lit < 0:
        return 0, b""
    if anchor > 0 and avail > lit and lit < spec.LASTLITERALS:
        return None, anchor + max(lit, 0)
    return anchor + lit, (block[:kept] + literal_head(lit)
                          + src[anchor:anchor + lit])


def compress_hc_dest_size(src, capacity: int, level: int = DEFAULT_CLEVEL,
                          dict_: bytes = b"",
                          device="cuda") -> Tuple[int, bytes]:
    """HC compression into at most ``capacity`` bytes: (source bytes
    consumed, block).  The block decodes, behind ``dict_``, to
    ``src[:consumed]``; ``(0, b"")`` when not one literal fits."""
    dev = resolve_device(device)
    src, level = bytes(src), _level(level)
    window = _dict_window(dict_, dev)
    while True:
        block, _ = _hc_block(src, window, level, dev)
        consumed, out = _capacity_cut(block, src, capacity)
        if consumed is not None:
            return consumed, out
        src = src[:out]                        # parse the shorter source


class HcCompressStream:
    """Streaming HC compression over a sliding 64 KB window kept on the
    device.  Parity: ``LZ4_streamHC_t`` with ``LZ4_resetStreamHC``,
    ``LZ4_loadDictHC``, ``LZ4_saveDictHC`` and
    ``LZ4_compress_HC_continue``; as ``lz4_tpu``'s, the window is a copy of
    the last 64 KB of history, so any caller buffer layout is valid."""

    def __init__(self, level: int = DEFAULT_CLEVEL, device="cuda"):
        self.device = resolve_device(device)
        self.level = _level(level)
        self.reset()

    def reset(self, level: Optional[int] = None) -> None:
        """Parity: LZ4_resetStreamHC."""
        if level is not None:
            self.level = max(1, min(MAX_CLEVEL, level))
        self._window: Optional[torch.Tensor] = None

    def load_dict(self, dictionary: bytes) -> int:
        """Prime the window with the last 64 KB of ``dictionary``; returns
        the loaded size.  Parity: LZ4_loadDictHC."""
        self._window = _dict_window(bytes(dictionary)[-WINDOW:], self.device)
        return 0 if self._window is None else self._window.numel()

    def save_dict(self, max_bytes: int = WINDOW) -> bytes:
        """The last ``max_bytes`` of the window (fetched from the device).
        Parity: LZ4_saveDictHC."""
        if max_bytes <= 0 or self._window is None:
            return b""
        return to_host(self._window).tobytes()[-max_bytes:]

    def compress_continue(self, src, capacity: Optional[int] = None) -> bytes:
        """Compress the next chunk against the window.  With ``capacity``,
        ``b""`` (and the window as it was) when the block is longer.
        Parity: LZ4_compress_HC_continue."""
        block, window = _hc_block(bytes(src), self._window, self.level,
                                  self.device)
        if capacity is not None and len(block) > capacity:
            return b""
        self._window = window
        return block
