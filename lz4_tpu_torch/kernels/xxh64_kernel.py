"""Batched XXH64 of rows on the device: kernel K.

Counterpart of ``lz4_tpu/kernels/xxh64_kernel.py`` (``xxh64_batch`` over
``_xxh64_stripes``).  The JAX kernel carries each 64-bit accumulator as a
hi/lo pair of 32-bit lanes and finishes tail and avalanche on the host;
here the kernel (``csrc/xxh.cu``) computes the whole digest in 64-bit
integers and the wrapper fetches one word per row.  Rows are uint8 bytes,
not packed words.

``xxh64_batch`` launches the kernel for tensors on the card and runs
``xxh64_rows_plain`` (numpy, vectorised over the batch) for tensors on the
CPU.  ``xxh64_rows_tiled_plain`` and ``xxh64_rows_narrow_plain`` model the
kernel's staging, as their ``xxh32_kernel`` twins do kernel J's; only the
tests call them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .common import LAUNCHES, PLAIN_CALLS, on_device, use_kernel
from .xxh32_kernel import (NSTAGE, TILE, check_rows, funnel, narrow_layout,
                           stage_rows, tail_bytes, tile_layout)

P1, P2, P3, P4, P5 = (np.uint64(11400714785074694791),
                      np.uint64(14029467366897019727),
                      np.uint64(1609587929392839161),
                      np.uint64(9650029242287828579),
                      np.uint64(2870177450012600261))


def _rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _round(acc, w):
    return _rotl(acc + w * P2, 31) * P1


def _word64(words, q, sh):
    """The 8 bytes at word q (read as ``funnel`` does), as uint64."""
    return (funnel(words, q, sh).astype(np.uint64)
            | (funnel(words, q + 1, sh).astype(np.uint64) << np.uint64(32)))


def xxh64_rows_tiled_plain(rows: np.ndarray, lens: np.ndarray, seed: int,
                           starts=None, tile: int = TILE,
                           stages=None) -> np.ndarray:
    """XXH64 of ``rows[b, :lens[b]]`` as kernel K computes it: the staging
    of ``xxh32_kernel.xxh32_rows_tiled_plain`` with 32-byte stripes, each
    lane's 8 bytes read as two funnelled words."""
    B, N = rows.shape
    lens = np.clip(np.asarray(lens, np.int64), 0, N)
    starts = (np.zeros(B, np.int64) if starts is None
              else np.asarray(starts, np.int64) & (-1 if stages else 15))
    seed = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    zero = np.uint64(0)
    per = tile // 32
    m, span, last = tile_layout(lens, starts, tile, 32)
    sh = (starts & 3) * 8
    h = np.zeros(B, np.uint64)
    with np.errstate(over="ignore"):
        v = np.tile(np.array([seed + P1 + P2, seed + P2, seed, seed - P1],
                             np.uint64), (B, 1))
        for t in range(int(last.max(initial=-1)) + 1):
            stage = (stages(t) if stages
                     else stage_rows(rows, lens, starts, span, last, t, tile))
            words = np.ascontiguousarray(stage).view("<u4")
            for j in range(per):
                live = (t * per + j < m) & (t <= last)
                if not live.any():
                    break
                q = (starts >> 2) + 8 * j
                w = np.stack([_word64(words, q + 2 * k, sh)
                              for k in range(4)], 1)
                v = np.where(live[:, None], _round(v, w), v)
            ends = last == t
            o = np.where(ends, starts + 32 * m - t * tile, 0)
            big = (_rotl(v[:, 0], 1) + _rotl(v[:, 1], 7) + _rotl(v[:, 2], 12)
                   + _rotl(v[:, 3], 18))
            for k in range(4):
                big = (big ^ _round(zero, v[:, k])) * P1 + P4
            d = np.where(lens >= 32, big, seed + P5) + lens.astype(np.uint64)
            rem = lens % 32
            for j in range(3):
                step = _rotl(d ^ _round(zero, _word64(words, (o >> 2) + 2 * j,
                                                      sh)), 27) * P1 + P4
                d = np.where(rem >= 8 * (j + 1), step, d)
            at = o + rem // 8 * 8
            word = funnel(words, at >> 2, sh).astype(np.uint64)
            step = _rotl(d ^ (word * P1), 23) * P2 + P3
            d = np.where(rem % 8 >= 4, step, d)
            at = o + rem // 4 * 4
            for j in range(3):
                byte = np.take_along_axis(stage, (at + j)[:, None],
                                          axis=1)[:, 0]
                step = _rotl(d ^ (byte.astype(np.uint64) * P5), 11) * P1
                d = np.where(rem % 4 > j, step, d)
            d ^= d >> np.uint64(33)
            d *= P2
            d ^= d >> np.uint64(29)
            d *= P3
            d ^= d >> np.uint64(32)
            h = np.where(ends, d, h)
    return h.astype(np.uint64)


def xxh64_rows_narrow_plain(rows: np.ndarray, lens: np.ndarray, seed: int,
                            start: int = 0) -> np.ndarray:
    """XXH64 of contiguous rows of at most NARROW bytes as kernel K's
    narrow path computes it (``xxh32_kernel.narrow_layout``)."""
    stages, starts = narrow_layout(rows, start)
    return xxh64_rows_tiled_plain(rows, lens, seed, starts, NSTAGE, stages)


def xxh64_rows_plain(rows: np.ndarray, lens: np.ndarray, seed: int
                     ) -> np.ndarray:
    """XXH64 of ``rows[b, :lens[b]]`` for every b ([B, N] uint8, [B] ints):
    the stripe loop runs once per 32-byte stripe over the whole batch, rows
    that have ended keep their accumulators."""
    B, N = rows.shape
    lens = np.asarray(lens, np.int64)
    seed = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    zero = np.uint64(0)
    with np.errstate(over="ignore"):
        stripes = lens // 32
        top = int(stripes.max(initial=0))
        words = np.ascontiguousarray(rows[:, :32 * top]).view("<u8") \
            .reshape(B, top, 4)
        v = np.tile(np.array([seed + P1 + P2, seed + P2, seed, seed - P1],
                             np.uint64), (B, 1))
        for s in range(top):
            live = (s < stripes)[:, None]
            v = np.where(live, _round(v, words[:, s]), v)
        big = (_rotl(v[:, 0], 1) + _rotl(v[:, 1], 7) + _rotl(v[:, 2], 12)
               + _rotl(v[:, 3], 18))
        for k in range(4):
            big = (big ^ _round(zero, v[:, k])) * P1 + P4
        h = np.where(lens >= 32, big, seed + P5) + lens.astype(np.uint64)
        rem = lens % 32
        tail = tail_bytes(rows, stripes * 32, 32)
        for j in range(3):
            step = _rotl(h ^ _round(zero, tail.view("<u8")[:, j]), 27) \
                * P1 + P4
            h = np.where(rem >= 8 * (j + 1), step, h)
        at = rem // 8 * 8
        word = np.take_along_axis(
            tail.view("<u4"), np.minimum(at // 4, 7)[:, None], axis=1)[:, 0]
        step = _rotl(h ^ (word.astype(np.uint64) * P1), 23) * P2 + P3
        h = np.where(rem % 8 >= 4, step, h)
        at = rem // 4 * 4
        for j in range(3):
            byte = np.take_along_axis(
                tail, np.minimum(at + j, 31)[:, None], axis=1)[:, 0]
            step = _rotl(h ^ (byte.astype(np.uint64) * P5), 11) * P1
            h = np.where(rem % 4 > j, step, h)
        h ^= h >> np.uint64(33)
        h *= P2
        h ^= h >> np.uint64(29)
        h *= P3
        h ^= h >> np.uint64(32)
    return h.astype(np.uint64)


def xxh64_batch(rows: torch.Tensor, lens: torch.Tensor, seed: int = 0
                ) -> np.ndarray:
    """XXH64 of B independent buffers.

    Args:
      rows: [B, N] uint8, zero padded.
      lens: [B] int32 byte lengths (clamped to [0, N]).
      seed: the common seed (its low 64 bits).

    Returns a numpy array of B uint64 digests (bit-exact XXH64), fetched
    from the device in one copy.
    """
    check_rows(rows, lens)
    B, N = rows.shape
    if not use_kernel(rows, lens):
        PLAIN_CALLS["xxh64"] += 1
        return xxh64_rows_plain(rows.numpy(), lens.numpy().clip(0, N), seed)
    out = torch.empty((B,), dtype=torch.int64, device=rows.device)
    with on_device(rows.device):
        err = build.kernels_lib().lz4tt_xxh64_rows(
            rows.data_ptr(), rows.stride(0), lens.data_ptr(), N,
            seed & 0xFFFFFFFFFFFFFFFF, out.data_ptr(), B,
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check_launch("xxh64", err)
    LAUNCHES["xxh64"] += 1
    return out.cpu().numpy().view(np.uint64)
