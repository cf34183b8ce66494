"""Frame body assembly on the device: kernel C.

Counterpart of ``lz4_tpu/kernels/pack_kernel.py``.  Every block becomes
``[LE32 block header | payload]`` at its offset in one flat buffer, so one
fetch returns the whole frame body.  A block whose compressed size reaches
its plaintext size ships its plaintext instead, with ``blen | 0x80000000``
as its header (lz4frame.c's stored-block fallback).  Rows with ``blen == 0``
(padding) write nothing.  The offsets are an exclusive ``torch.cumsum`` of
``4 + payload size``, as the JAX package's were an XLA cumsum.
"""

from __future__ import annotations

import torch

from .. import spec
from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, use_kernel


def pack_frame_payloads(comp_rows: torch.Tensor, olen: torch.Tensor,
                        src_rows: torch.Tensor, blens) -> tuple:
    """Assemble ``[header | payload]`` for every block into one flat buffer.

    Args:
      comp_rows: [B, M] uint8 compressed rows (encode kernel output).
      olen: [B] int32 compressed lengths.
      src_rows: [B, NS] uint8 plaintext blocks (rows may be a view into a
        larger contiguous stream), the stored-block source.
      blens: [B] plaintext block lengths (tensor or array-like).

    Returns (flat [B * (4 + max(M, NS))] uint8, total, stored): ``total`` is a
    0-d int64 tensor with the body's byte count and ``stored`` a [B] bool
    tensor, both left on the device so that packing never waits for it.
    """
    check(comp_rows, "comp_rows", torch.uint8, 2)
    check(olen, "olen", torch.int32, 1)
    check(src_rows, "src_rows", torch.uint8, 2)
    B, M = comp_rows.shape
    NS = src_rows.shape[1]
    if olen.shape[0] != B or src_rows.shape[0] != B:
        raise ValueError("comp_rows, olen and src_rows must have B rows")
    dev = comp_rows.device
    blen = torch.as_tensor(blens, dtype=torch.int32).to(dev)
    if blen.shape != (B,):
        raise ValueError("blens must be [B]")
    on_card = use_kernel(comp_rows, olen, src_rows, blen)
    live = blen > 0
    stored = (olen >= blen) & live
    # the kernel copies eff[b] bytes of row b: every length must fit its row
    # (one reduction, one sync)
    if bool(((blen < 0) | (blen > NS)
             | (live & ~stored & ((olen < 0) | (olen > M)))).any()):
        raise ValueError("a block length exceeds its row: blens must lie in "
                         "[0, NS] and a compressed olen in [0, M]")
    eff = torch.where(stored, blen, olen) * live
    hdr64 = torch.where(stored, blen.to(torch.int64) | spec.UNCOMPRESSED_BIT,
                        olen.to(torch.int64))
    hdr = torch.where(hdr64 >= 1 << 31, hdr64 - (1 << 32), hdr64).to(
        torch.int32)
    step = (4 + eff.to(torch.int64)) * live
    dst = torch.cumsum(step, 0) - step
    total = step.sum()
    size = B * (4 + max(M, NS))
    if not on_card:
        PLAIN_CALLS["pack"] += 1
        flat = torch.zeros((size,), dtype=torch.uint8)
        for b, (d, e, h, s, lv) in enumerate(zip(
                dst.tolist(), eff.tolist(), hdr.tolist(), stored.tolist(),
                live.tolist())):
            if not lv:
                continue
            flat[d:d + 4] = torch.tensor(
                list((h & 0xFFFFFFFF).to_bytes(4, "little")),
                dtype=torch.uint8)
            flat[d + 4:d + 4 + e] = (src_rows if s else comp_rows)[b, :e]
        return flat, total, stored
    flat = torch.empty((size,), dtype=torch.uint8, device=dev)
    dst = dst.contiguous()
    err = build.kernels_lib().lz4tt_pack(
        comp_rows.data_ptr(), M, src_rows.data_ptr(), src_rows.stride(0),
        eff.data_ptr(), hdr.data_ptr(), dst.data_ptr(),
        blen.data_ptr(), flat.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("pack", err)
    LAUNCHES["pack"] += 1
    return flat, total, stored
