"""Batch block codec on the device: bytes in, bytes out.

Counterpart of the device hooks of ``lz4_tpu/block.py``
(``compress_batch``, ``decompress_batch``).  The JAX package's host block
codec is not part of the port: a single block goes through these with a
list of one.
"""

from __future__ import annotations

from typing import List, Optional

from .device import decode_batch, encode_batch


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
