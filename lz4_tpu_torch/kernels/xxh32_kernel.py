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
CPU.  ``xxh32_rows_tiled_plain`` models the kernel's staging (rows copied
in tiles from the 16-byte granule of their first byte) and
``xxh32_rows_narrow_plain`` its narrow path (short rows copied a group at
a time); only the tests call them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, on_device, use_kernel

P1, P2, P3, P4, P5 = (np.uint32(2654435761), np.uint32(2246822519),
                      np.uint32(3266489917), np.uint32(668265263),
                      np.uint32(374761393))
# csrc/xxh.cu's staging: TILE bytes of a row a stage, ROOM more of room;
# rows at most NARROW bytes apart go whole, in stages of NSTAGE bytes, up to
# RMAX of them a stage
TILE = 2048
ROOM = 48
NARROW, NSTAGE, RMAX = 256, 4096, 256


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


def tile_layout(lens, starts, tile: int, stripe: int):
    """Per row, as kernels J and K (``csrc/xxh.cu``) stage it: (m, span,
    last), m whole stripes, the span's length (from the 16-byte granule of
    the row's first byte, ``starts[b]`` bytes into it, to the granule of its
    last; 0 for an empty row), and the tile that holds the tail (the last
    stripe's when the tail is empty)."""
    per = tile // stripe
    m = lens // stripe
    span = np.where(lens > 0, (starts + lens + 15) // 16 * 16, 0)
    last = np.where(lens % stripe != 0, m // per, np.maximum(m - 1, 0) // per)
    return m, span, last


def stage_rows(rows, lens, starts, span, last, t: int, tile: int):
    """[B, tile + ROOM] uint8: what stage t holds of every row, the span's
    bytes [t * tile, t * tile + tile + 16) cut at the span's end (a row past
    its last tile copies nothing).  The span's bytes outside the row, and
    the room the copy leaves, hold noise that must never be hashed."""
    B, N = rows.shape
    stage = np.random.default_rng(t).integers(0, 256, (B, tile + ROOM),
                                              dtype=np.uint8)
    j = t * tile + np.arange(tile + 16)[None, :]
    src = j - starts[:, None]
    copied = (j < span[:, None]) & (t <= last)[:, None]
    live = copied & (src >= 0) & (src < lens[:, None])
    got = np.take_along_axis(rows, np.clip(src, 0, max(N - 1, 0)), axis=1) \
        if N else np.zeros(src.shape, np.uint8)
    stage[:, :tile + 16] = np.where(live, got, stage[:, :tile + 16])
    return stage


def narrow_rows(stride: int) -> int:
    """Rows a stage of the narrow path holds (csrc/xxh.cu's)."""
    return min(RMAX, (NSTAGE - 32) // stride) // 8 * 8


def narrow_layout(rows, start: int):
    """Kernels J and K's narrow path (rows of N <= NARROW bytes, contiguous):
    each group of ``narrow_rows(N)`` rows copied as one range, from the
    16-byte granule of its first byte to that of its last row's end, the
    rows' storage starting ``start`` (0..15) bytes into a granule.  Returns
    (stages, starts) for the tiled models with ``tile=NSTAGE``: stages(0) is
    every row's group stage, starts[b] row b's first byte in it."""
    B, N = rows.shape
    R = narrow_rows(N)
    noise = np.random.default_rng(N).integers(0, 256, start + B * N + NSTAGE
                                              + ROOM, dtype=np.uint8)
    noise[start:start + B * N] = rows.reshape(-1)
    b = np.arange(B)
    first = start + b // R * R * N              # the group's first byte
    s0 = first & 15
    last = np.minimum(b // R * R + R, B) - 1    # the group's last row
    copied = (start + last * N + N + 15) // 16 * 16 - (first - s0)

    def stages(t):
        idx = (first - s0)[:, None] + np.arange(NSTAGE + ROOM)[None, :]
        stage = np.take_along_axis(
            np.broadcast_to(noise, (B, len(noise))), idx, axis=1)
        filler = np.random.default_rng(7).integers(0, 256, stage.shape,
                                                   dtype=np.uint8)
        return np.where(np.arange(NSTAGE + ROOM)[None, :] < copied[:, None],
                        stage, filler)
    return stages, s0 + b % R * N


def funnel(words, q, sh):
    """Word q of each row's bytes read at byte offset sh / 8 past word q of
    ``words`` ([B, W] uint32): the kernels' ``__funnelshift_r``."""
    lo = np.take_along_axis(words, q[:, None], axis=1)[:, 0].astype(np.uint64)
    hi = np.take_along_axis(words, q[:, None] + 1, axis=1)[:, 0]
    return (((hi.astype(np.uint64) << np.uint64(32)) | lo)
            >> sh.astype(np.uint64)).astype(np.uint32)


def xxh32_rows_tiled_plain(rows: np.ndarray, lens: np.ndarray, seed: int,
                           starts=None, tile: int = TILE,
                           stages=None) -> np.ndarray:
    """XXH32 of ``rows[b, :lens[b]]`` as kernel J computes it: row b's first
    byte ``starts[b]`` (0..15, default 0) bytes into its 16-byte granule,
    the row staged ``tile`` bytes at a time (``stage_rows``), the stripes
    starting in a tile hashed from its stage through ``funnel``, and the
    tail and avalanche from the stage of the row's last tile.  ``stages``
    (t -> [B, tile + ROOM] uint8) replaces ``stage_rows``, with row b's
    first byte at any ``starts[b]`` of it (the narrow path:
    ``narrow_layout``)."""
    B, N = rows.shape
    lens = np.clip(np.asarray(lens, np.int64), 0, N)
    starts = (np.zeros(B, np.int64) if starts is None
              else np.asarray(starts, np.int64) & (-1 if stages else 15))
    seed = np.uint32(seed & 0xFFFFFFFF)
    per = tile // 16
    m, span, last = tile_layout(lens, starts, tile, 16)
    sh = (starts & 3) * 8
    h = np.zeros(B, np.uint32)
    with np.errstate(over="ignore"):
        v = np.tile(np.array([seed + P1 + P2, seed + P2, seed, seed - P1],
                             np.uint32), (B, 1))
        for t in range(int(last.max(initial=-1)) + 1):
            stage = (stages(t) if stages
                     else stage_rows(rows, lens, starts, span, last, t, tile))
            words = np.ascontiguousarray(stage).view("<u4")
            for j in range(per):
                live = (t * per + j < m) & (t <= last)
                if not live.any():
                    break
                q = (starts >> 2) + 4 * j
                w = np.stack([funnel(words, q + k, sh) for k in range(4)], 1)
                v = np.where(live[:, None], _rotl(v + w * P2, 13) * P1, v)
            # the rows whose tail lies in this tile, at byte o of the stage
            ends = last == t
            o = np.where(ends, starts + 16 * m - t * tile, 0)
            d = np.where(lens >= 16,
                         _rotl(v[:, 0], 1) + _rotl(v[:, 1], 7)
                         + _rotl(v[:, 2], 12) + _rotl(v[:, 3], 18),
                         seed + P5) + lens.astype(np.uint32)
            rem = lens % 16
            for j in range(3):
                step = _rotl(d + funnel(words, (o >> 2) + j, sh) * P3, 17) * P4
                d = np.where(rem >= 4 * (j + 1), step, d)
            at = o + rem // 4 * 4
            for j in range(3):
                byte = np.take_along_axis(stage, (at + j)[:, None],
                                          axis=1)[:, 0]
                step = _rotl(d + byte.astype(np.uint32) * P5, 11) * P1
                d = np.where(rem % 4 > j, step, d)
            d ^= d >> np.uint32(15)
            d *= P2
            d ^= d >> np.uint32(13)
            d *= P3
            d ^= d >> np.uint32(16)
            h = np.where(ends, d, h)
    return h.astype(np.uint32)


def xxh32_rows_narrow_plain(rows: np.ndarray, lens: np.ndarray, seed: int,
                            start: int = 0) -> np.ndarray:
    """XXH32 of contiguous rows of at most NARROW bytes as kernel J's
    narrow path computes it (``narrow_layout``)."""
    stages, starts = narrow_layout(rows, start)
    return xxh32_rows_tiled_plain(rows, lens, seed, starts, NSTAGE, stages)


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
    with on_device(rows.device):
        err = build.kernels_lib().lz4tt_xxh32_rows(
            rows.data_ptr(), rows.stride(0), lens.data_ptr(), N,
            seed & 0xFFFFFFFF, out.data_ptr(), B,
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check_launch("xxh32", err)
    LAUNCHES["xxh32"] += 1
    return out.cpu().numpy().view(np.uint32)
