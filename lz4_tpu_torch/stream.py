"""Streaming block compression and decompression over a 64 KB window, with
the block work on the device.

Counterpart of ``lz4_tpu/stream.py``, with its names and return shapes:

* :class:`BlockCompressStream`: ``LZ4_loadDict``, ``LZ4_saveDict``,
  ``LZ4_resetStream``, ``LZ4_compress_fast_continue`` and the fork's
  ``LZ4_compress_fast_destSize_continue``;
* :class:`BlockDecompressStream`: ``LZ4_setStreamDecode``,
  ``LZ4_decompress_safe_continue`` and the destSize decode in a chained
  stream.

Like ``lz4_tpu``'s, a stream owns a copy of the last 64 KB of its history,
so any caller buffer layout (double buffer, ring buffer, line by line) is
valid.  Here that window is a tensor on the device, kept there between
calls: a call uploads its chunk, launches, and fetches its result.

* ``compress_continue``: kernel A's linked chain over the chunk, the window
  as its dictionary prefix, the payloads joined into one block
  (``device.chain_block``), for chunks of any size.
* ``compress_dest_size_continue``: kernel H on one row ``[window |
  chunk]``; the chunk gives H at most its row's 256 KB less the window.
* ``decompress_continue`` and ``decompress_dest_size_continue``: the host's
  walk over the block's lengths (``block.walk_safe``, ``walk_dest_size``),
  then kernel D (batch, or resumable) with the window as its dictionary
  row.

The compressors parse as the kernels do, not as ``lz4_tpu``'s host codec
(whose match index persists across calls): the blocks differ, and each
decodes through either package's stream decoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import spec
from .block import decode_prefix, dest_size_row, walk_dest_size, walk_safe
from .device import chain_block, next_window, window_tensor
from .kernels.common import resolve_device, to_host

__all__ = ["BlockCompressStream", "BlockDecompressStream"]


class BlockCompressStream:
    """Chained block compression over a sliding 64 KB window on the
    device."""

    def __init__(self, acceleration: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.acceleration = max(1, acceleration)
        self.reset()

    def reset(self) -> None:
        """Parity: LZ4_resetStream."""
        self._window: Optional[torch.Tensor] = None

    def load_dict(self, dictionary: bytes) -> int:
        """Prime the window with the last 64 KB of ``dictionary``; returns
        the loaded size.  Parity: LZ4_loadDict."""
        self.reset()
        d = bytes(dictionary)[-spec.WINDOW_SIZE:]
        if d:
            self._window = window_tensor(d, self.device)
        return len(d)

    def save_dict(self, max_size: int = spec.WINDOW_SIZE) -> bytes:
        """The window, most recent byte last (fetched from the device).
        Parity: LZ4_saveDict."""
        if self._window is None:
            return b""
        return to_host(self._window).tobytes()[-max_size:]

    def compress_continue(self, chunk: bytes, capacity=None) -> bytes:
        """Compress the next chunk of the stream as one block.  With
        ``capacity`` set, returns b"" (and keeps the window) when the block
        is longer.  Parity: LZ4_compress_fast_continue."""
        block, window = chain_block(bytes(chunk), self._window,
                                    self.acceleration, device=self.device)
        if capacity is not None and len(block) > capacity:
            return b""
        self._window = window
        return block

    def compress_dest_size_continue(self, chunk: bytes,
                                    capacity: int) -> Tuple[int, bytes]:
        """destSize variant: (consumed, block).  The window advances by the
        bytes consumed.  Parity: LZ4_compress_fast_destSize_continue."""
        block, consumed, row = dest_size_row(
            bytes(chunk), capacity, self.acceleration, self._window,
            self.device)
        end = (0 if self._window is None else self._window.numel()) \
            + consumed
        if consumed:
            self._window = row[max(end - spec.WINDOW_SIZE, 0):end].clone()
        return consumed, block


class BlockDecompressStream:
    """Chained block decompression mirroring a compress stream; the window
    stays on the device."""

    def __init__(self, dictionary: bytes = b"", device="cuda"):
        self.device = resolve_device(device)
        self.set_stream_decode(dictionary)

    def set_stream_decode(self, dictionary: bytes = b"") -> None:
        """Parity: LZ4_setStreamDecode."""
        d = bytes(dictionary)[-spec.WINDOW_SIZE:]
        self._window = window_tensor(d, self.device) if d else None

    def _nd(self) -> int:
        return 0 if self._window is None else self._window.numel()

    def _advance(self, out: torch.Tensor) -> bytes:
        if out.numel():
            self._window = next_window(self._window, out)
        return to_host(out).tobytes()

    def decompress_continue(self, comp: bytes, out_size: int) -> bytes:
        """Decode the next block of the stream into at most ``out_size``
        bytes.  Parity: LZ4_decompress_safe_continue."""
        comp = bytes(comp)
        src_end, out_end, _ = walk_safe(comp, out_size, self._nd())
        return self._advance(decode_prefix(comp, src_end, out_end,
                                           self._window, False, self.device))

    def decompress_dest_size_continue(self, comp: bytes,
                                      dest_capacity: int
                                      ) -> Tuple[int, bytes]:
        """Resumable destSize decode within the stream: at most
        ``dest_capacity`` bytes, stopping at a token boundary; the bytes
        produced join the window, so ``comp[consumed:]`` resumes the same
        block.  Returns ``(consumed, produced)``."""
        comp = bytes(comp)
        consumed, produced = walk_dest_size(comp, dest_capacity, self._nd())
        return consumed, self._advance(decode_prefix(
            comp, consumed, produced, self._window, True, self.device))
