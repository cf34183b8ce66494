"""Batched XXH32 of rows on the device: kernel J.

Counterpart of ``lz4_tpu/kernels/xxh32_kernel.py`` (``xxh32_batch`` over
``_xxh32_stripes``).  The JAX kernel computes the stripe accumulators and
finishes tail and avalanche on the host; here the kernel
(``csrc/xxh.cu``) computes the whole digest and the wrapper fetches one
word per row.  Rows are uint8 bytes, not packed words.  It serves checks on
data already on the device; the host's native XXH32 (``ops/xxhash.py``)
stays the frame path's hash.

``xxh32_batch`` launches the kernel for tensors on the card and runs
``xxh32_rows_plain`` (numpy, vectorised over the batch) for tensors on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, use_kernel

P1, P2, P3, P4, P5 = (np.uint32(2654435761), np.uint32(2246822519),
                      np.uint32(3266489917), np.uint32(668265263),
                      np.uint32(374761393))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def tail_bytes(rows: np.ndarray, start: np.ndarray, width: int) -> np.ndarray:
    """[B, width] uint8: row b's bytes from ``start[b]`` on, zeros past the
    row's end."""
    B, N = rows.shape
    padded = np.zeros((B, N + width), np.uint8)
    padded[:, :N] = rows
    idx = start[:, None] + np.arange(width)[None, :]
    return np.take_along_axis(padded, idx, axis=1)


def xxh32_rows_plain(rows: np.ndarray, lens: np.ndarray, seed: int
                     ) -> np.ndarray:
    """XXH32 of ``rows[b, :lens[b]]`` for every b ([B, N] uint8, [B] ints):
    the stripe loop runs once per 16-byte stripe over the whole batch, rows
    that have ended keep their accumulators."""
    B, N = rows.shape
    lens = np.asarray(lens, np.int64)
    seed = np.uint32(seed & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        stripes = lens // 16
        top = int(stripes.max(initial=0))
        words = np.ascontiguousarray(rows[:, :16 * top]).view("<u4") \
            .reshape(B, top, 4)
        v = np.tile(np.array([seed + P1 + P2, seed + P2, seed, seed - P1],
                             np.uint32), (B, 1))
        for s in range(top):
            live = (s < stripes)[:, None]
            v = np.where(live, _rotl(v + words[:, s] * P2, 13) * P1, v)
        h = np.where(lens >= 16,
                     _rotl(v[:, 0], 1) + _rotl(v[:, 1], 7)
                     + _rotl(v[:, 2], 12) + _rotl(v[:, 3], 18), seed + P5)
        h = (h + lens.astype(np.uint32)).astype(np.uint32)
        rem = lens % 16
        tail = tail_bytes(rows, stripes * 16, 16)
        tail_words = tail.view("<u4")
        for j in range(3):
            step = _rotl(h + tail_words[:, j] * P3, 17) * P4
            h = np.where(rem >= 4 * (j + 1), step, h)
        at = rem // 4 * 4
        for j in range(3):
            byte = np.take_along_axis(
                tail, np.minimum(at + j, 15)[:, None], axis=1)[:, 0]
            step = _rotl(h + byte.astype(np.uint32) * P5, 11) * P1
            h = np.where(rem % 4 > j, step, h)
        h ^= h >> np.uint32(15)
        h *= P2
        h ^= h >> np.uint32(13)
        h *= P3
        h ^= h >> np.uint32(16)
    return h.astype(np.uint32)


def check_rows(rows: torch.Tensor, lens: torch.Tensor) -> None:
    check(rows, "rows", torch.uint8, 2)
    check(lens, "lens", torch.int32, 1)
    if lens.shape[0] != rows.shape[0]:
        raise ValueError("lens must be [B]")


def xxh32_batch(rows: torch.Tensor, lens: torch.Tensor, seed: int = 0
                ) -> np.ndarray:
    """XXH32 of B independent buffers.

    Args:
      rows: [B, N] uint8, zero padded.
      lens: [B] int32 byte lengths (clamped to [0, N]).
      seed: the common seed (its low 32 bits).

    Returns a numpy array of B uint32 digests (bit-exact XXH32), fetched
    from the device in one copy.
    """
    check_rows(rows, lens)
    B, N = rows.shape
    if not use_kernel(rows, lens):
        PLAIN_CALLS["xxh32"] += 1
        return xxh32_rows_plain(rows.numpy(), lens.numpy().clip(0, N), seed)
    out = torch.empty((B,), dtype=torch.int32, device=rows.device)
    err = build.kernels_lib().lz4tt_xxh32_rows(
        rows.data_ptr(), rows.stride(0), lens.data_ptr(), N,
        seed & 0xFFFFFFFF, out.data_ptr(), B,
        torch.cuda.current_stream(rows.device).cuda_stream)
    build.check_launch("xxh32", err)
    LAUNCHES["xxh32"] += 1
    return out.cpu().numpy().view(np.uint32)
