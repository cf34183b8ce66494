"""Frame body assembly on the device: kernel C.

Counterpart of ``lz4_tpu/kernels/pack_kernel.py``.  Every block becomes
``[LE32 block header | payload]`` at its offset in one flat buffer, so one
fetch returns the whole frame body.  A block whose compressed size reaches
its plaintext size ships its plaintext instead, with ``blen | 0x80000000``
as its header (lz4frame.c's stored-block fallback).  Rows with ``blen == 0``
(padding) write nothing.  The offsets are an exclusive scan of
``4 + payload size``, as the JAX package's were an XLA cumsum.

On the card the bookkeeping (stored flags, sizes, headers, offsets, the
total) is kernel C's first launch (``pack_prologue_plain`` is its plain
version), so packing never waits for the device.  A length outside its row
is a fault: on the CPU ``pack_frame_payloads`` raises at once; on the card
the kernels read and write nothing for it, and ``body_length`` raises when
the total is read.
"""

from __future__ import annotations

import torch

from .. import spec
from ..trace import COUNTS, span
from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, on_device, use_kernel

ROW_FAULT = ("a block length exceeds its row: blens must lie in [0, NS] and "
             "a compressed olen in [0, M]")


def pack_prologue_plain(olen: torch.Tensor, blen: torch.Tensor, M: int,
                        NS: int):
    """Kernel C's bookkeeping, as its first launch computes it.

    Returns (stored [B] bool, eff [B] int32 payload sizes, hdr [B] int32
    headers, dst [B] int64 record offsets, total [2] int64): ``total`` is
    (body bytes, fault), fault 1 when a length falls outside its row."""
    live = blen > 0
    stored = (olen >= blen) & live
    fault = ((blen < 0) | (blen > NS)
             | (live & ~stored & ((olen < 0) | (olen > M)))).any()
    eff = (torch.where(stored, blen, olen) * live).to(torch.int32)
    hdr64 = torch.where(stored, blen.to(torch.int64) | spec.UNCOMPRESSED_BIT,
                        olen.to(torch.int64))
    hdr = torch.where(hdr64 >= 1 << 31, hdr64 - (1 << 32), hdr64).to(
        torch.int32)
    step = (4 + eff.to(torch.int64)) * live
    dst = torch.cumsum(step, 0) - step
    total = torch.stack([step.sum(), fault.to(torch.int64)])
    return stored, eff, hdr, dst, total


def body_length(total: torch.Tensor) -> int:
    """The body's byte count from ``pack_frame_payloads``' ``total``, read
    with its fault flag in one copy (a ``link`` span, counted as a wait);
    raises ValueError on a fault."""
    with span("link"):
        COUNTS["d2h_bytes"] += total.numel() * total.element_size()
        COUNTS["syncs"] += 1
        n, fault = total.tolist()
    if fault:
        raise ValueError(ROW_FAULT)
    return n


def pack_frame_payloads(comp_rows: torch.Tensor, olen: torch.Tensor,
                        src_rows: torch.Tensor, blens) -> tuple:
    """Assemble ``[header | payload]`` for every block into one flat buffer.

    Args:
      comp_rows: [B, M] uint8 compressed rows (encode kernel output).
      olen: [B] int32 compressed lengths.
      src_rows: [B, NS] uint8 plaintext blocks (rows may be a view into a
        larger contiguous stream), the stored-block source.
      blens: [B] plaintext block lengths (tensor or array-like).

    Returns (flat [B * (4 + max(M, NS))] uint8, total, stored): ``total`` is
    a [2] int64 tensor (body bytes, fault) and ``stored`` a [B] bool tensor,
    both left on the device so that packing never waits for it; read the
    byte count with ``body_length(total)``.  Every length must fit its row:
    on the CPU a length outside it raises ValueError here, on the card when
    ``body_length`` reads the total (nothing is packed then).
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
    size = B * (4 + max(M, NS))
    if not use_kernel(comp_rows, olen, src_rows, blen):
        PLAIN_CALLS["pack"] += 1
        stored, eff, hdr, dst, total = pack_prologue_plain(olen, blen, M, NS)
        body_length(total)
        flat = torch.zeros((size,), dtype=torch.uint8)
        for b, (d, e, h, s, n) in enumerate(zip(
                dst.tolist(), eff.tolist(), hdr.tolist(), stored.tolist(),
                blen.tolist())):
            if n <= 0:
                continue
            flat[d:d + 4] = torch.tensor(
                list((h & 0xFFFFFFFF).to_bytes(4, "little")),
                dtype=torch.uint8)
            flat[d + 4:d + 4 + e] = (src_rows if s else comp_rows)[b, :e]
        return flat, total, stored
    flat = torch.empty((size,), dtype=torch.uint8, device=dev)
    sizes = torch.empty((2, B), dtype=torch.int32, device=dev)  # eff, hdr
    dst = torch.empty((B,), dtype=torch.int64, device=dev)
    stored = torch.empty((B,), dtype=torch.bool, device=dev)
    total = torch.empty((2,), dtype=torch.int64, device=dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_pack(
            comp_rows.data_ptr(), M, src_rows.data_ptr(), src_rows.stride(0),
            NS, olen.data_ptr(), blen.data_ptr(), B, sizes[0].data_ptr(),
            sizes[1].data_ptr(), dst.data_ptr(), stored.data_ptr(),
            total.data_ptr(), flat.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("pack", err)
    LAUNCHES["pack"] += 1
    return flat, total, stored
