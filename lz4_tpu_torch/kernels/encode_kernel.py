"""Greedy LZ4 block encoder over a sorted candidate table: kernels A and B.

Counterpart of ``lz4_tpu/kernels/encode_kernel.py``.  The parse is the JAX
package's, bit for bit: ``cand_delta_rows`` finds, by one sort, the nearest
previous position with the same 5 bytes within 65535; a scan per block takes
each candidate, extends it backward, then forward (8 and 4 bytes at a time
with a <4-byte tail), applies the ``min_match``/``reject_step`` reject, and
jumps barren runs through a jump table.

* ``encode_blocks_linked`` (kernel A, ``csrc/encode.cu``): linked 64 KB
  blocks of one or more streams, each block matching into its predecessor
  (or a dictionary prefix for block 0).  The candidate table is built over
  ``[window | 6 blocks]`` tiles exactly as the JAX package builds it, and
  its jump table is 4-granular.  Its adaptive mode (``mm_rows``) gives each
  block its own min_match; ``cand_frac8_rows`` is the long-match density
  such a choice can read.
* ``encode_blocks`` (kernel B): independent rows of up to 256 KB, with a
  full-resolution jump table.

The tables are PyTorch ops (the JAX package left them to XLA).  Each wrapper
launches its CUDA kernel for tensors on the card and runs the plain Python
scan below for tensors on the CPU.  On the card the scan runs in three
launches (probe words, speculative walks, emission; ``csrc/encode.cu``),
modelled here by ``probe_words_plain``, ``walk_plain`` and ``emit_plain``
for the CPU tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import spec, trace
from . import build
from .common import (LAUNCHES, PLAIN_CALLS, check, le32_lanes, on_device,
                     use_kernel)

WINDOW = spec.WINDOW_SIZE
ENC_TILE_BLOCKS = 6        # blocks per sorted tile of the linked tables
SKIP_TRIGGER = 6
MAX_BLOCK = 1 << 18        # kernel B rows: positions fit 18 bits


def out_width(ns: int) -> int:
    """Output row width for ``ns``-byte blocks: compress_bound, 128-aligned."""
    return -(-spec.compress_bound(ns) // 128) * 128


def cand_delta_rows(val: torch.Tensor, filter_mm=None) -> torch.Tensor:
    """[B, N] int32 val32 rows -> [B, N] int32 candidate deltas: lane p holds
    ``p - p'`` for the nearest p' < p whose 5 bytes (val32 lane and the low
    byte of lane p+4, wrapping at the row end) equal p's, within 65535, or
    0 when there is none.

    ``filter_mm`` (an int or a [B] tensor of per-row min_match) zeroes, for
    rows with mm >= 6, candidates that the scan would provably reject: the
    val32 lanes at +4 and -4 ride the sort, and the byte runs they share
    with the sort neighbour bound the match length (see the JAX package).
    It may also be a function of the sorted positions' (query, candidate)
    pairs, both [B, N-1] int64, that returns the min_match of each query,
    a mask and the -4 lanes to take for the candidates where the mask is
    set, all [B, N-1] (``linked_tables``' per-block filter).  The filter
    only zeroes a delta; it never moves one to an earlier candidate.
    """
    B, N = val.shape
    if N > 1 << 19:
        raise ValueError("rows longer than 2^19 lanes")
    pos_bits = 18 if N <= 1 << 18 else 19
    pos = torch.arange(N, dtype=torch.int64, device=val.device).expand(B, N)
    b5 = torch.roll(val, -4, dims=1).to(torch.int64) & 0xFF
    key = (val.to(torch.int64) << 32) | (b5 << pos_bits) | pos
    skey, perm = torch.sort(key, dim=1)
    sp = skey & ((1 << pos_bits) - 1)
    grp = skey >> pos_bits                  # (val32, byte +4) of each lane
    same = grp[:, 1:] == grp[:, :-1]
    if filter_mm is not None:
        sv4 = torch.roll(val, -4, dims=1).gather(1, perm)
        svm4 = torch.roll(val, 4, dims=1).gather(1, perm)
        cand_m4 = svm4[:, :-1]
        if callable(filter_mm):
            mm_row, fix, lanes = filter_mm(sp[:, 1:], sp[:, :-1])
            cand_m4 = torch.where(fix, lanes, cand_m4)
        else:
            mm_row = torch.as_tensor(filter_mm, dtype=torch.int32,
                                     device=val.device).reshape(-1, 1)
        tf = sv4[:, 1:] ^ sv4[:, :-1]       # bytes +4..+7 (byte +4 = key)
        tb = svm4[:, 1:] ^ cand_m4          # bytes -4..-1
        m5 = (tf & 0x00FF00) == 0
        m6 = (tf & 0xFFFF00) == 0
        m7 = tf == 0
        fwd = 5 + m5.int() + m6.int() + m7.int()          # exact up to 8
        n4 = tb == 0
        bwd = ((((tb >> 24) & 0xFF) == 0).int()
               + (((tb >> 16) & 0xFFFF) == 0).int()
               + (((tb >> 8) & 0xFFFFFF) == 0).int() + n4.int())
        same &= m7 | n4 | (fwd + bwd >= mm_row)
    d = torch.where(same, sp[:, 1:] - sp[:, :-1], 0)
    d = torch.where(d <= 65535, d, 0)
    out = torch.zeros((B, N), dtype=torch.int64, device=val.device)
    out[:, 1:] = d
    # un-permute: the delta found for sorted slot i belongs to position sp[i]
    return torch.zeros_like(out).scatter_(1, sp, out).to(torch.int32)


def cand_frac8_rows(rows: torch.Tensor) -> torch.Tensor:
    """[B, N] uint8 rows -> [B] float32: the share of sorted neighbour pairs
    whose later position's nearest earlier 5-byte-equal candidate within
    65535 also matches the 8 bytes from the position (val32 lanes wrapping
    at the row end), i.e. would survive any min_match pre-filter.  The
    long-match density that adaptive mode's per-block min_match can be
    chosen by; the JAX package's ``cand_frac8_rows`` on the same lanes,
    equal to it exactly (positions in 18 bits, as there; rows of up to
    2^18 bytes).  One sort, the +4 lane riding it; PyTorch ops on either
    device (the JAX package computes it outside its kernels too)."""
    check(rows, "rows", torch.uint8, 2)
    B, N = rows.shape
    val = le32_lanes(torch.cat([rows, rows[:, :3]], dim=1))
    pos = torch.arange(N, dtype=torch.int64, device=rows.device).expand(B, N)
    v4 = torch.roll(val, -4, dims=1)
    k2 = ((v4.to(torch.int64) & 0xFF) << 18) | pos
    skey, perm = torch.sort((val.to(torch.int64) << 32) | k2, dim=1)
    sk2 = skey & 0xFFFFFFFF
    sp = sk2 & ((1 << 18) - 1)
    sv4 = v4.gather(1, perm)
    same = ((skey[:, 1:] >> 32) == (skey[:, :-1] >> 32)) & (
        (sk2[:, 1:] >> 18) == (sk2[:, :-1] >> 18))
    near = (sp[:, 1:] - sp[:, :-1]) <= 65535
    m8 = same & near & (sv4[:, 1:] == sv4[:, :-1])
    count = m8.sum(dim=1).to(torch.float32)
    # a divisor tensor of the count's shape: a scalar divisor may be taken
    # as a product with its reciprocal, which rounds differently
    return count / torch.full_like(count, N - 1)


def _next_candidate(d: torch.Tensor) -> torch.Tensor:
    """[R, N] deltas -> [R, N] position of the next lane >= p holding a
    candidate (N when none)."""
    N = d.shape[1]
    pos = torch.arange(N, dtype=torch.int32, device=d.device)
    cand = torch.where(d > 0, pos, N).flip(1)
    return torch.cummin(cand, dim=1).values.flip(1)


@trace.timed("tables")
def linked_tables(stream: torch.Tensor, nb: int, min_match: int = 4,
                  zero_window_lanes: Optional[torch.Tensor] = None,
                  mm_rows: Optional[torch.Tensor] = None):
    """Candidate and jump tables of kernel A for ``nb`` linked 64 KB blocks.

    ``stream`` is [S, L] uint8: row s holds stream s's 64 KB window, then
    its ``nb`` blocks, zeros past the data.  The val32 tiles reproduce the
    JAX package's ``[window | K blocks]`` layout, including its edges: the
    last 3 lanes of the final block row wrap to that row's start when no
    padding row follows it, and read zeros when one does.
    ``zero_window_lanes`` ([S] int32, optional) zeroes block 0's window lanes
    below ``WINDOW - zero_window_lanes[s]``, as the JAX package's chunked
    window builder does.

    ``mm_rows`` ([S, nb] int32, optional) filters each block's candidates
    at its own min_match (adaptive mode) in place of ``min_match``.  The
    JAX package sorts per-block ``[window | block]`` rows there; the tiles
    give the same deltas with each sorted slot's threshold taken from the
    block of its position (see ``_per_block_filter``).

    Returns (delta [S*nb, 65536] int32, jump [S*nb, 16384] int32): jump[k]
    is the block-relative position of the next candidate at or after lane
    4k, the 4-granular table of the linked scan.
    """
    S = stream.shape[0]
    K = min(ENC_TILE_BLOCKS, nb)
    T = -(-nb // K)
    end = (nb + 1) * WINDOW                 # end of the data rows
    need = (T * K + 1) * WINDOW + 3
    u = torch.zeros((S, need), dtype=torch.uint8, device=stream.device)
    take = min(end, stream.shape[1])
    u[:, :take] = stream[:, :take]
    lanes = le32_lanes(u)                   # [S, (T*K+1)*WINDOW]
    if T * K > nb:
        # the block after the last is a zero padding row: its window lanes
        # (which repair the last block's final 3 lanes) are zero
        lanes[:, end - 3:end] = 0
    else:
        # no row follows the last block: its final lanes wrap to the start
        # of its own [previous block | block] row
        row = torch.cat([u[:, end - 3:end], u[:, end - 2 * WINDOW:
                                                end - 2 * WINDOW + 3]], 1)
        lanes[:, end - 3:end] = le32_lanes(row)
    if zero_window_lanes is not None:
        keep = torch.arange(WINDOW, device=stream.device)[None, :] >= (
            WINDOW - zero_window_lanes.to(stream.device)[:, None])
        lanes[:, :WINDOW] = torch.where(keep, lanes[:, :WINDOW], 0)
    tiles = lanes.unfold(1, (K + 1) * WINDOW, K * WINDOW)   # [S, T, W+K*64K]
    if mm_rows is not None:
        filt = _per_block_filter(u, mm_rows, nb, K, T)
    else:
        filt = min_match if min_match >= 6 else None
    d_tiles = cand_delta_rows(tiles.reshape(S * T, (K + 1) * WINDOW), filt)
    delta = d_tiles[:, WINDOW:].reshape(S, T * K, WINDOW)[:, :nb]
    delta = delta.reshape(S * nb, WINDOW).clone()
    # matches never start in a block's last 12 bytes: masking them keeps
    # the parse independent of the tile layout
    delta[:, WINDOW - 12:] = 0
    jump = _next_candidate(delta)[:, ::4].contiguous()
    return delta, jump


def _per_block_filter(u: torch.Tensor, mm_rows: torch.Tensor, nb: int,
                      K: int, T: int):
    """The ``filter_mm`` function of ``cand_delta_rows`` that makes the
    tiles of ``linked_tables`` give the JAX package's per-block deltas.

    Each query q (a tile position) takes the min_match of its block.  The
    two layouts read the same bytes for every pair but one kind: a query
    in its block's first 3 lanes whose candidate lies in lanes 1-3 of the
    block's window (65,533-65,535 back).  In a per-block row the
    candidate's -4 lane wraps to that row's last 3 lanes (the block's last
    bytes, then the window's first); in a tile it reads the bytes before
    the window.  For those pairs the function hands over the wrapped
    lanes.  ``u`` is the zero-padded stream, [S, (T*K+1)*65536 + 3]."""
    S = u.shape[0]
    dev = u.device
    mm = torch.zeros((S, T * K), dtype=torch.int32, device=dev)
    mm[:, :nb] = mm_rows
    mm = mm.reshape(S * T, K).to(torch.int64)
    # each block's [window | block] row's last 3 lanes, wrapped to its start
    g = torch.arange(T * K, device=dev)[:, None] * WINDOW
    i = torch.arange(3, device=dev)
    at = torch.cat([g + 2 * WINDOW - 3 + i, g + i], 1).reshape(-1)
    wrap = le32_lanes(u[:, at].reshape(S * T * K, 6)).reshape(S * T, K * 3)

    def filt(q, c):
        blk = ((q - WINDOW) >> 16).clamp(0, K - 1)
        w = c - blk * WINDOW                # the candidate in q's window
        fix = ((q >= WINDOW) & (((q - WINDOW) & 0xFFFF) < 3) & (w >= 1)
               & (w <= 3))
        lane = blk * 3 + (w - 1).clamp(0, 2)
        return mm.gather(1, blk), fix, wrap.gather(1, lane)

    return filt


def independent_tables(rows: torch.Tensor, min_match: int = 4):
    """Candidate and full-resolution jump tables of kernel B for [B, NS]
    uint8 rows (val32 lanes wrap at the row end, as in the JAX package).
    Returns (delta, jump), both [B, NS] int32; jump is clipped to 65535."""
    B, NS = rows.shape
    val = le32_lanes(torch.cat([rows, rows[:, :3]], dim=1))
    delta = cand_delta_rows(val, min_match if min_match >= 6 else None)
    pos = torch.arange(NS, dtype=torch.int32, device=rows.device)
    jump = torch.clamp(_next_candidate(delta) - pos, max=65535)
    return delta, jump.to(torch.int32)


# ---------------------------------------------------------------------------
# plain version of the scan (CPU tensors)
# ---------------------------------------------------------------------------

def _emit_ext(out: bytearray, extra: int) -> None:
    while extra >= 255:
        out.append(255)
        extra -= 255
    out.append(extra)


def _emit_seq(out: bytearray, buf: bytes, anchor: int, litlen: int,
              offset: int, ml_code: int) -> None:
    """One sequence: ``litlen`` literals from ``buf[anchor:]``, then a match
    of ml_code + 4 bytes at distance ``offset`` (csrc/emit.cuh emit_seq)."""
    out.append((min(litlen, 15) << 4) | min(ml_code, 15))
    if litlen >= 15:
        _emit_ext(out, litlen - 15)
    out += buf[anchor:anchor + litlen]
    out.append(offset & 0xFF)
    out.append(offset >> 8)
    if ml_code >= 15:
        _emit_ext(out, ml_code - 15)


def _emit_final(out: bytearray, buf: bytes, anchor: int, n_end: int) -> None:
    """The block's trailing literal-only sequence, up to ``n_end``."""
    litlen = n_end - anchor
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        _emit_ext(out, litlen - 15)
    out += buf[anchor:n_end]


def _ext_bytes(x: int) -> int:
    """Length-extension byte count for a nibble value x (0 when < 15)."""
    return 0 if x < 15 else 1 + (x - 15) // 255


def _seq_size(litlen: int, mlc: int) -> int:
    """Encoded size of one sequence (csrc/emit.cuh seq_size)."""
    return 1 + litlen + 2 + _ext_bytes(litlen) + _ext_bytes(mlc)


def _final_run_size(litlen: int) -> int:
    return 1 + litlen + _ext_bytes(litlen)


def _common_run(data: bytes, a: int, b: int, room: int) -> int:
    """Length of the common prefix of data[a:] and data[b:], at most
    ``room``: what the kernels' word-wise extension with its XOR tail
    computes, capped at matchlimit."""
    k = 0
    for step in (256, 16):
        while k + step <= room and data[a + k:a + k + step] == \
                data[b + k:b + k + step]:
            k += step
    while k < room and data[a + k] == data[b + k]:
        k += 1
    return k


def _scan_plain(buf: bytes, start: int, n: int, low: int, ip: int,
                delta, jump, linked: bool, acceleration: int,
                min_match: int, reject_step: int,
                tails: Optional[list] = None) -> bytearray:
    """One block's greedy parse; positions index ``buf`` directly.  Same
    decisions as the kernels' scan (csrc/encode.cu) and the JAX package's.
    Appends the offset of the final literal run's token to ``tails``."""
    out = bytearray()
    n_end = start + n
    mflimit, matchlimit = n_end - 12, n_end - 5
    accel0 = acceleration << SKIP_TRIGGER
    anchor, scnt = start, accel0
    ns4 = len(jump) - 1
    while n >= 13 and ip <= mflimit:
        d = delta[ip - start]
        q = ip - d
        if d > 0 and q >= low:
            mp, qq = ip, q
            while mp > anchor and qq > low and buf[mp - 1] == buf[qq - 1]:
                mp -= 1
                qq -= 1
            # forward: the common run from ip + 4, capped at matchlimit
            # (equal to the 8/4-step loops plus the XOR tail)
            ml = ip + 4 - mp + _common_run(buf, q + 4, ip + 4,
                                           matchlimit - ip - 4)
            if ml >= min_match:
                _emit_seq(out, buf, anchor, mp - anchor, ip - q, ml - 4)
                ip = anchor = mp + ml
                scnt = accel0
            else:
                ip += max(scnt >> SKIP_TRIGGER, reject_step)
                scnt += 1
        else:
            step = scnt >> SKIP_TRIGGER
            if linked:
                ip2 = ip + step
                j = ip2 - start
                if j < WINDOW:
                    ip2 = max(ip2, start + jump[min(j >> 2, ns4)])
                ip = ip2
            else:
                ip += max(step, jump[ip - start])
            scnt += 1
    if tails is not None:
        tails.append(len(out))
    _emit_final(out, buf, anchor, n_end)
    return out


# ---------------------------------------------------------------------------
# the card's three phases, modelled (test-only): probe words, walk, emission
# ---------------------------------------------------------------------------
# csrc/encode.cu splits the scan above.  A candidate's forward end does not
# depend on the walk (it runs from ip + 4 to the first mismatch, capped at
# matchlimit), and its backward run depends on it only through the clamp
# mp >= anchor.  So phase 1 measures both runs at every position, in
# parallel, each up to a cap; phase 2 walks the decisions of the scan over
# those words (and finishes a capped run itself); phase 3 writes the
# sequences the walk recorded, each at the offset the walk summed.

FWD_CAP = 127            # forward run measured per position: 7 bits
BACK_CAP = 63            # backward run: 6 bits
PROBE_VALID = 1 << 31    # word: valid | d (18 bits) << 13 | fwd << 6 | back
WALKERS = 128            # speculative walks per block (four warps)
WALK_OVERLAP = 512       # bytes a walk goes past its segment
WALK_HEADS = 8           # first match ends a walker publishes
WALK_RUN = 128           # bytes a walk follows a capped forward run


def probe_words_plain(buf: torch.Tensor, start: int, n: int, low: int,
                      delta: torch.Tensor,
                      jump: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 1 of the card's scan for one block, vectorised.

    ``buf`` is the 1-D uint8 row the block's positions index, the block is
    ``[start, start + n)``, matches reach back to ``low``; ``delta`` holds
    the block's candidate deltas.  Returns int64 words, one per lane of
    ``delta``: for a probe the scan can take (``d > 0``, ``q = p - d >=
    low``, ``p <= mflimit``) ``PROBE_VALID | d << 13 | fwd << 6 | back``,
    where ``fwd`` counts the equal bytes from ``p + 4`` (against ``q + 4``)
    up to ``min(FWD_CAP, matchlimit - p - 4)`` and ``back`` the equal bytes
    before ``p`` (against before ``q``) up to ``min(BACK_CAP, p - start,
    q - low)``.  Other lanes hold ``jump`` clamped to [0, 2^30] (kernel B's
    full-resolution table), or 0 without one.
    """
    ns = delta.shape[0]
    b = buf.to(torch.int64)
    p = start + torch.arange(ns, dtype=torch.int64)
    d = delta.to(torch.int64)
    q = p - d
    valid = (d > 0) & (q >= low) & (p <= start + n - 12)
    idx = valid.nonzero().reshape(-1)
    fwd = _equal_run(b, p[idx] + 4, q[idx] + 4, torch.clamp(
        start + n - 5 - p[idx] - 4, max=FWD_CAP), 1)
    back = _equal_run(b, p[idx] - 1, q[idx] - 1, torch.minimum(
        torch.clamp(p[idx] - start, max=BACK_CAP), q[idx] - low), -1)
    if jump is None:
        words = torch.zeros(ns, dtype=torch.int64)
    else:
        words = torch.clamp(jump.to(torch.int64), 0, 1 << 30)
    words[idx] = PROBE_VALID | d[idx] << 13 | fwd << 6 | back
    return words


def _equal_run(b: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               room: torch.Tensor, step: int) -> torch.Tensor:
    """Per lane, the count of k < room with b[x + step*k] == b[y + step*k]
    for all smaller k too."""
    run = torch.zeros_like(x)
    live = (room > 0).nonzero().reshape(-1)
    k = 0
    while live.numel():
        eq = b[x[live] + step * k] == b[y[live] + step * k]
        live = live[eq]
        run[live] += 1
        k += 1
        live = live[room[live] > k]
    return run


def _walk_from(words, jump, buf: bytes, start: int, n: int, low: int,
               state, stop: int, linked: bool, acceleration: int,
               min_match: int, reject_step: int, can_open: bool = False,
               meet=None):
    """The scan's decisions over ``probe_words_plain``'s words (a list) from
    ``state`` = (ip, anchor, scnt) while ip <= min(stop, mflimit), finishing
    a capped backward run byte by byte.  A capped forward run is finished
    byte by byte too; with ``can_open`` it is followed WALK_RUN bytes only,
    and if it is still equal there and the match is taken whatever its end,
    the walk stops at it.  ``meet``, a predicate on a match's end: the walk
    also stops after a match whose end it holds.  Returns (matches [(mp,
    end, d)], final state, steps, first, open): ``first`` the (x, d) of the
    first match taken or opened (x = its probe + 4, where its forward run
    starts), ``open`` the (mp, x, d) of the match the walk stopped at (its
    run goes on from x), or None."""
    ip, anchor, scnt = state
    n_end = start + n
    mflimit, matchlimit = n_end - 12, n_end - 5
    accel0 = acceleration << SKIP_TRIGGER
    ns4 = len(jump) - 1 if linked else 0
    matches, steps, first = [], 0, None
    while n >= 13 and ip <= mflimit and ip <= stop:
        steps += 1
        w = words[ip - start]
        if w & PROBE_VALID:
            d = (w >> 13) & 0x3FFFF
            back, fwd = w & 63, (w >> 6) & 127
            mp = max(ip - back, anchor)
            if back == BACK_CAP and mp > anchor:
                qq = mp - d
                while mp > anchor and qq > low and buf[mp - 1] == buf[qq - 1]:
                    mp -= 1
                    qq -= 1
            end = ip + 4 + fwd
            if fwd == FWD_CAP and end < matchlimit:
                lim = min(matchlimit, end + WALK_RUN) if can_open \
                    else matchlimit
                end += _common_run(buf, end - d, end, lim - end)
                if end == lim < matchlimit:
                    if end - mp >= min_match:
                        first = first or (ip + 4, d)
                        return matches, (ip, anchor, scnt), steps, first, \
                            (mp, end, d)
                    end += _common_run(buf, end - d, end, matchlimit - end)
            if end - mp >= min_match:
                first = first or (ip + 4, d)
                matches.append((mp, end, d))
                ip = anchor = end
                scnt = accel0
                if meet and meet(end):
                    break
                continue
            ip += max(scnt >> SKIP_TRIGGER, reject_step)
        elif linked:
            ip2 = ip + (scnt >> SKIP_TRIGGER)
            j = ip2 - start
            if j < WINDOW:
                ip2 = max(ip2, start + jump[min(j >> 2, ns4)])
            ip = ip2
        else:
            ip += max(scnt >> SKIP_TRIGGER, w)
        scnt += 1
    return matches, (ip, anchor, scnt), steps, first, None


def _sync(matches, s_next: int, ends_next) -> tuple:
    """(index of the first of a lane's matches whose end is the next lane's
    start ``s_next`` or one of its match ends ``ends_next``, index of the
    next lane's match after that end), or (-1, 0): the card's sync."""
    h = 0
    for i, (_, e, _) in enumerate(matches):
        if e < s_next:
            continue
        if e == s_next:
            return i, 0
        while h < len(ends_next) and ends_next[h] < e:
            h += 1
        if h == len(ends_next):
            break
        if ends_next[h] == e:
            return i, h + 1
    return -1, 0


def _heads(lane) -> set:
    """The first match ends a walker publishes."""
    return {e for _, e, _ in lane["matches"][:WALK_HEADS]}


def walk_plain(words, jump, buf: bytes, start: int, n: int, low: int,
               ip: int, linked: bool, acceleration: int, min_match: int,
               reject_step: int):
    """Phase 2 of the card's scan.  WALKERS speculative walks, one per
    segment of the block (the first from the block's true start, the others
    from a fresh state at their segment's start), each WALK_OVERLAP bytes
    past its segment; a walk stops at a capped forward run, and the runs
    are finished from the last lane to the first, each one as the next
    lane's first match if that match has the same distance and its run
    starts at or after the stopped run's start and all bytes between are
    equal; the walks go on until none stops.  The parse is taken from lane
    to lane at their first shared match end; a serial walk goes on from the
    last lane taken until it takes a match whose end a later lane's walk
    starts at or also took, and the parse follows the lanes again from
    there, to the block's end.  Returns (records, olen, steps): a record
    ``(mp, end, d, op)`` per sequence, then the final one ``(n_end, n_end,
    0, op)``; ``steps`` counts the decisions on the critical path (the
    longest walk of each round, then the serial walk's).

    The joins, the parking at capped runs and the rejoin search are the
    card's.  One thing is a schedule: a walk also stops early at a match
    ending at one of the next walk's first WALK_HEADS ends.  Here the lanes
    of a round run last to first, so every such end is known; on the card
    the lanes run at once and a walk sees the ends published so far.  The
    stop only saves steps (the joins read the final records), so the
    records and payload are the card's under any schedule, and ``steps``
    is this schedule's count."""
    n_end = start + n
    mflimit, matchlimit = n_end - 12, n_end - 5
    accel0 = acceleration << SKIP_TRIGGER
    seg = max(-(-n // WALKERS), 1)
    args = (words, jump, buf, start, n, low)
    knobs = (linked, acceleration, min_match, reject_step)
    lanes = []
    for k in range(WALKERS):
        s_k = start + k * seg
        lanes.append({"state": (ip if k == 0 else s_k, s_k, accel0),
                      "stop": mflimit if k == WALKERS - 1
                      else s_k + seg + WALK_OVERLAP - 1,
                      "matches": [], "first": None, "open": True})
    steps = 0
    while any(lane["open"] for lane in lanes):
        longest = 0
        for k in reversed(range(WALKERS)):
            lane = lanes[k]
            if not lane["open"] or lane.get("met"):
                continue
            meet = None
            if k + 1 < WALKERS:
                s_next = start + (k + 1) * seg
                if lane["matches"] and lane["matches"][-1][1] in (
                        s_next, *_heads(lanes[k + 1])):
                    lane["met"], lane["open"] = True, None
                    continue
                meet = {s_next, *_heads(lanes[k + 1])}.__contains__
            m, lane["state"], st, first, lane["open"] = _walk_from(
                *args, lane["state"], lane["stop"], *knobs, can_open=True,
                meet=meet)
            lane["matches"] += m
            lane["first"] = lane["first"] or first
            longest = max(longest, st)
        steps += longest
        for k in reversed(range(WALKERS)):
            if lanes[k]["open"] is None:
                continue
            mp, x, d = lanes[k]["open"]
            nxt = lanes[k + 1] if k + 1 < WALKERS else None
            follow = (nxt is not None and nxt["first"] is not None
                      and nxt["first"][0] >= x and nxt["first"][1] == d)
            lim = nxt["first"][0] if follow else matchlimit
            end = x + _common_run(buf, x - d, x, lim - x)
            if follow and end == lim:
                end = nxt["matches"][0][1]
            lanes[k]["matches"].append((mp, end, d))
            lanes[k]["state"] = (end, end, accel0)
    walks = [(lane["matches"], lane["state"]) for lane in lanes]
    syncs = [_sync(walks[k][0], start + (k + 1) * seg,
                   [e for _, e, _ in walks[k + 1][0]])
             for k in range(WALKERS - 1)] + [(-1, 0)]
    ends = [{e: i + 1 for i, (_, e, _) in enumerate(w[0])} for w in walks]
    last_end = [w[0][-1][1] if w[0] else -1 for w in walks]

    def follow(k, idx):
        """Take lane k's matches from idx on, and the next lane's wherever
        they meet; returns the lane whose final state the walk goes on
        from."""
        while True:
            at, nxt_i = syncs[k]
            if at < 0 or at < idx - 1:  # at == idx - 1: the end we came in by
                parse.extend(walks[k][0][idx:])
                return k
            parse.extend(walks[k][0][idx:at + 1])
            idx = nxt_i
            k += 1

    def rejoin(k, end):
        """(a lane after k whose walk starts at ``end`` or took a match
        ending there, the index of its next match), or None.  As on the
        card, the search passes the lanes whose matches all end before
        ``end`` and stops at the first lane that starts at or after it or
        took a match ending at or after it."""
        for j in range(k + 1, WALKERS):
            s_j = start + j * seg
            if end <= s_j:
                return (j, 0) if end == s_j else None
            if last_end[j] >= end:
                return (j, ends[j][end]) if end in ends[j] else None
        return None

    parse = []
    k = follow(0, 0)
    tail_steps = 0
    while True:
        more, (_, anchor, _), st, _, _ = _walk_from(
            *args, walks[k][1], mflimit, *knobs,
            meet=lambda e, k=k: rejoin(k, e) is not None)
        parse += more
        tail_steps += st
        back = rejoin(k, more[-1][1]) if more else None
        if back is None:
            break
        k = follow(*back)
    recs, op, prev = [], 0, start
    for mp, end, d in parse:
        recs.append((mp, end, d, op))
        op += _seq_size(mp - prev, end - mp - 4)
        prev = end
    recs.append((n_end, n_end, 0, op))
    return recs, op + _final_run_size(n_end - anchor), steps + tail_steps


def emit_plain(buf: bytes, start: int, recs, olen: int) -> bytearray:
    """Phase 3: every record's sequence written at its own offset, as the
    card's warps write them (any order gives the same bytes)."""
    out = bytearray(olen)
    anchor = start
    for i, (mp, end, d, op) in enumerate(recs):
        seq = bytearray()
        if i == len(recs) - 1:
            _emit_final(seq, buf, anchor, mp)
        else:
            _emit_seq(seq, buf, anchor, mp - anchor, d, end - mp - 4)
        out[op:op + len(seq)] = seq
        anchor = end
    return out


SCAN_SCRATCH = 1 << 28    # bytes of the card's scan scratch per call


def _scratch_shape(ns: int):
    """(stride, lcap, rec_cap) of the card's scan scratch for rows of up to
    ``ns`` bytes: words rows of ``stride`` int32 (ns rounded up to 4, so
    that a row starts on 16 bytes), ``lcap`` matches per speculative walk
    (a bound over its segment and the overlap: a match ends at least 4
    bytes past its probe, so every match moves the anchor 4 bytes or more),
    ``rec_cap`` records per block (up to ns / 4 sequences and the final
    run)."""
    return (-(-ns // 4) * 4, (-(-ns // WALKERS) + WALK_OVERLAP) // 4 + 2,
            ns // 4 + 1)


def scan_row_bytes(ns: int) -> int:
    """Bytes of the card's scan scratch per block of up to ``ns`` bytes
    (about 16 per input byte): its words, its walks' matches ([lcap,
    WALKERS] of 4 int32), its (mp, end, d, op) records and their count."""
    stride, lcap, rec_cap = _scratch_shape(ns)
    return 4 * (stride + lcap * WALKERS * 4 + rec_cap * 4 + 1)


def _scan_scratch(rows: int, ns: int, dev):
    """The card's scratch for one group of the ``rows`` blocks of up to
    ``ns`` bytes, the group as many blocks as fit SCAN_SCRATCH (16 MB of
    input for 64 KB blocks).  Returns (words, lrec, rec, nrec, group)."""
    stride, lcap, rec_cap = _scratch_shape(ns)
    group = max(1, min(rows, SCAN_SCRATCH // scan_row_bytes(ns)))
    return (torch.empty((group, stride), dtype=torch.int32, device=dev),
            torch.empty((group, lcap, WALKERS, 4), dtype=torch.int32,
                        device=dev),
            torch.empty((group, rec_cap, 4), dtype=torch.int32, device=dev),
            torch.empty((group,), dtype=torch.int32, device=dev), group)


def _fill_rows(out: torch.Tensor, olen: torch.Tensor, rows) -> None:
    for i, payload in enumerate(rows):
        if payload:
            out[i, :len(payload)] = torch.frombuffer(payload,
                                                     dtype=torch.uint8)
        olen[i] = len(payload)


# ---------------------------------------------------------------------------
# kernel A: linked 64 KB blocks
# ---------------------------------------------------------------------------

def encode_blocks_linked(stream: torch.Tensor, src_lens: torch.Tensor,
                         acceleration: int = 1,
                         prefix_lens: Optional[torch.Tensor] = None,
                         min_match: int = 4, reject_step: int = 1,
                         zero_window_lanes: bool = False,
                         tails: bool = False,
                         mm_rows: Optional[torch.Tensor] = None):
    """Compress streams of linked 64 KB blocks.

    Args:
      stream: [S, L] uint8; row s is ``[64 KB window | NB blocks | zeros]``
        with L >= (NB + 1) * 65536.  Block 0's window holds the dictionary
        prefix right-aligned (zeros below it).
      src_lens: [S, NB] int32 block lengths (65536 except the last nonzero
        block of a stream; zero rows are padding).
      prefix_lens: optional [S] int32 prefix length of each stream's block 0.
      zero_window_lanes: zero the candidate table's window lanes below the
        prefix, as the JAX package's chunked compressor does (its one-shot
        path does not).
      tails: also return each block's offset of the token of its final
        literal-only sequence ([S, NB] int32; 0 for a padding row), which
        lets consecutive payloads be joined into one block without a walk
        over their tokens (``lz4_tpu_torch.legacy.merge_payloads``).
      mm_rows: optional [S, NB] int32 per-block min_match (adaptive mode),
        on the stream's device; overrides ``min_match`` in the tables and
        the scan, as in the JAX package (a value of 4 or less takes every
        match, as 4 does).

    Returns (out [S, NB, M] uint8, olen [S, NB] int32), and the tails when
    asked; only ``out[s, k, :olen[s, k]]`` is meaningful.
    """
    if prefix_lens is None:
        prefix_lens = torch.zeros((src_lens.shape[0],), dtype=torch.int32,
                                  device=stream.device)
    _check_linked(stream, src_lens, prefix_lens, mm_rows)
    delta, jump = linked_tables(stream, src_lens.shape[1], min_match,
                                prefix_lens if zero_window_lanes else None,
                                mm_rows)
    return scan_linked(stream, src_lens, prefix_lens, delta, jump,
                       acceleration, min_match, reject_step, tails, mm_rows)


def _check_linked(stream, src_lens, prefix_lens, mm_rows=None) -> None:
    check(stream, "stream", torch.uint8, 2)
    check(src_lens, "src_lens", torch.int32, 2)
    check(prefix_lens, "prefix_lens", torch.int32, 1)
    S, NB = src_lens.shape
    if stream.shape[0] != S or stream.shape[1] < (NB + 1) * WINDOW:
        raise ValueError("stream must be [S, >= (NB+1)*65536]")
    if (NB + 2) * WINDOW >= 1 << 31:
        raise ValueError("the kernel addresses a stream with int32 "
                         "positions: at most 32766 blocks per stream")
    if prefix_lens.shape[0] != S:
        raise ValueError("prefix_lens must be [S]")
    if mm_rows is not None:
        check(mm_rows, "mm_rows", torch.int32, 2)
        if tuple(mm_rows.shape) != (S, NB):
            raise ValueError("mm_rows must be [S, NB]")
        if mm_rows.device != stream.device:
            raise ValueError(f"mm_rows on {mm_rows.device}, the stream on "
                             f"{stream.device}")


def scan_linked(stream: torch.Tensor, src_lens: torch.Tensor,
                prefix_lens: torch.Tensor, delta: torch.Tensor,
                jump: torch.Tensor, acceleration: int = 1,
                min_match: int = 4, reject_step: int = 1,
                tails: bool = False,
                mm_rows: Optional[torch.Tensor] = None):
    """Kernel A proper: the scan of ``encode_blocks_linked`` over tables
    from ``linked_tables``.  Launches csrc/encode.cu for tensors on the
    card, runs the plain scan for tensors on the CPU.  With ``tails``,
    returns (out, olen, tails) as ``encode_blocks_linked`` does; with
    ``mm_rows``, each block's scan takes its own min_match."""
    _check_linked(stream, src_lens, prefix_lens, mm_rows)
    S, NB = src_lens.shape
    check(delta, "delta", torch.int32, 2)
    check(jump, "jump", torch.int32, 2)
    if delta.shape != (S * NB, WINDOW) or jump.shape != (S * NB, WINDOW // 4):
        raise ValueError("tables must be [S*NB, 65536] and [S*NB, 16384]")
    M = out_width(WINDOW)
    acceleration = max(1, int(acceleration))   # 0 would never advance
    if not use_kernel(stream, src_lens, prefix_lens, delta, jump):
        return _encode_linked_plain(stream, src_lens, prefix_lens, delta,
                                    jump, M, acceleration, min_match,
                                    reject_step, tails, mm_rows)
    dev = stream.device
    out = torch.empty((S, NB, M), dtype=torch.uint8, device=dev)
    olen = torch.empty((S, NB), dtype=torch.int32, device=dev)
    tail = torch.empty((S, NB), dtype=torch.int32, device=dev) if tails \
        else None
    words, lrec, rec, nrec, group = _scan_scratch(S * NB, WINDOW, dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_encode_linked(
            stream.data_ptr(), stream.stride(0), delta.data_ptr(),
            jump.data_ptr(), src_lens.data_ptr(), prefix_lens.data_ptr(),
            words.data_ptr(), lrec.data_ptr(), lrec.shape[1], rec.data_ptr(),
            rec.shape[1], nrec.data_ptr(), group,
            out.data_ptr(), M, olen.data_ptr(),
            tail.data_ptr() if tails else None, S, NB, int(acceleration),
            int(min_match),
            mm_rows.data_ptr() if mm_rows is not None else None,
            int(reject_step), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("encode_linked", err)
    LAUNCHES["encode_linked"] += 1
    return (out, olen, tail) if tails else (out, olen)


def _encode_linked_plain(stream, src_lens, prefix_lens, delta, jump, M,
                         acceleration, min_match, reject_step, tails,
                         mm_rows=None):
    PLAIN_CALLS["encode_linked"] += 1
    S, NB = src_lens.shape
    lens = src_lens.tolist()
    prefix = prefix_lens.tolist()
    mms = (mm_rows.tolist() if mm_rows is not None
           else [[min_match] * NB] * S)
    out = torch.zeros((S, NB, M), dtype=torch.uint8)
    olen = torch.zeros((S, NB), dtype=torch.int32)
    tail = []
    for s in range(S):
        buf = stream[s].numpy().tobytes()
        rows = []
        for k in range(NB):
            n = min(lens[s][k], WINDOW)          # clamped as in the kernel
            if n <= 0:
                rows.append(b"")
                tail.append(0)
                continue
            start = (k + 1) * WINDOW
            pre = min(max(prefix[s], 0), WINDOW) if k == 0 else WINDOW
            r = s * NB + k
            rows.append(_scan_plain(
                buf, start, n, start - pre, start + (0 if pre > 0 else 1),
                delta[r].tolist(), jump[r].tolist(), True, acceleration,
                mms[s][k], reject_step, tail))
        _fill_rows(out[s], olen[s], rows)
    if tails:
        return out, olen, torch.tensor(tail, dtype=torch.int32).view(S, NB)
    return out, olen


# ---------------------------------------------------------------------------
# kernel B: independent rows
# ---------------------------------------------------------------------------

def encode_blocks(src_rows: torch.Tensor, src_lens: torch.Tensor,
                  acceleration: int = 1, min_match: int = 4,
                  reject_step: int = 1):
    """Compress a batch of independent blocks.

    Args:
      src_rows: [B, NS] uint8 rows, zero padded (NS <= 262144).
      src_lens: [B] int32 source lengths (each <= NS).

    Returns (out [B, M] uint8, olen [B] int32), M = 128-aligned
    compress_bound(NS).  A row of length 0 still gets its one-byte block.
    """
    _check_rows(src_rows, src_lens)
    delta, jump = independent_tables(src_rows, min_match)
    return scan_blocks(src_rows, src_lens, delta, jump, acceleration,
                       min_match, reject_step)


def _check_rows(src_rows, src_lens) -> None:
    check(src_rows, "src_rows", torch.uint8, 2)
    check(src_lens, "src_lens", torch.int32, 1)
    B, NS = src_rows.shape
    if NS > MAX_BLOCK:
        raise ValueError(f"block too large for kernel ({NS} > {MAX_BLOCK})")
    if src_lens.shape[0] != B:
        raise ValueError("src_lens must be [B]")


def scan_blocks(src_rows: torch.Tensor, src_lens: torch.Tensor,
                delta: torch.Tensor, jump: torch.Tensor,
                acceleration: int = 1, min_match: int = 4,
                reject_step: int = 1):
    """Kernel B proper: the scan of ``encode_blocks`` over tables from
    ``independent_tables``.  Launches csrc/encode.cu for tensors on the
    card, runs the plain scan for tensors on the CPU."""
    _check_rows(src_rows, src_lens)
    B, NS = src_rows.shape
    check(delta, "delta", torch.int32, 2)
    check(jump, "jump", torch.int32, 2)
    if delta.shape != (B, NS) or jump.shape != (B, NS):
        raise ValueError("tables must be [B, NS]")
    M = out_width(NS)
    acceleration = max(1, int(acceleration))   # 0 would never advance
    if not use_kernel(src_rows, src_lens, delta, jump):
        PLAIN_CALLS["encode"] += 1
        out = torch.zeros((B, M), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        lens = src_lens.tolist()
        rows = [_scan_plain(src_rows[b].numpy().tobytes(), 0,
                            min(max(lens[b], 0), NS), 0, 1,
                            delta[b].tolist(), jump[b].tolist(), False,
                            acceleration, min_match, reject_step)
                for b in range(B)]
        _fill_rows(out, olen, rows)
        return out, olen
    dev = src_rows.device
    out = torch.empty((B, M), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    words, lrec, rec, nrec, group = _scan_scratch(B, NS, dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_encode(
            src_rows.data_ptr(), NS, delta.data_ptr(), jump.data_ptr(),
            src_lens.data_ptr(), words.data_ptr(), words.shape[1],
            lrec.data_ptr(), lrec.shape[1], rec.data_ptr(), rec.shape[1],
            nrec.data_ptr(), group, out.data_ptr(), M,
            olen.data_ptr(), B, int(acceleration), int(min_match),
            int(reject_step), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("encode", err)
    LAUNCHES["encode"] += 1
    return out, olen
