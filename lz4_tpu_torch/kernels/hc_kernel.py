"""High-compression (HC) block encoder: kernel I.

Counterpart of ``lz4_tpu/kernels/hc_kernel.py``.  The parse is the JAX
package's, decision for decision, so payloads are bit-identical to
``lz4_tpu``'s:

* ``cand_delta48_rows`` builds both candidate chains by sorting, as the
  JAX package does: lane p's low 16 bits hold the distance to the nearest
  earlier position with the same 4 bytes, its high 16 bits the same for the
  same 8 bytes (0 when there is none within 65535).  Walking
  ``p - d[p] - d[.] - ...`` lists every earlier 4-byte match, newest first,
  with no hash table.
* The scan walks a position's chain for the widest match (forward plus
  backward length), at most ``1 << (level - 1)`` candidates.  A candidate is
  extended only if it can beat the best so far (its bytes still agree at the
  best frontier, or it can extend backward); once the best reaches
  ``8 + p - anchor`` the walk steps the 8-byte chain; it stops at
  ``SUFFICIENT_LEN``.  A match is deferred while the next position yields a
  strictly wider one (an iterative one-step lazy parse).  ``_hc_row_plain``
  is that walk over the d48 table, step by step.

Kernel I reads the chains from one stable sort instead
(``hc_sorted_tables``): the 4-byte chain of p is the run of equal keys just
before p's slot in the sorted order, newest first, so a warp reads 32
candidates with one load; the 8-byte chain is that run filtered on bytes
4..7.  A round of 32 candidates makes the walk's decisions with ballots,
popcounts and a warp maximum, and P consecutive positions are searched at
once (every search between two taken matches has the same anchor).
``hc_row_rounds_plain`` models that decomposition on the CPU.

A row may hold a prefix: ``[prefix | source]``, as kernel H's rows do.
The prefix's positions are in the chain tables, so a match may reach into
it (at most 65,535 bytes back), but none of them is parsed: the parse
starts at the source's first byte and the block is the source's alone.
Rows of at most 64 KB keep 16-bit tables; wider rows (a 64 KB prefix and a
64 KB source make 128 KB) take 32-bit ones.

``hc_scan`` launches ``csrc/hc.cu`` for tensors on the card and runs
``hc_row_rounds_plain`` for tensors on the CPU; ``encode_blocks_hc`` builds
the tables and calls it.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from .. import trace
from . import build
from .common import (LAUNCHES, PLAIN_CALLS, check, le32_lanes, on_device,
                     use_kernel)
from .encode_kernel import (_common_run, _emit_final, _emit_seq, _fill_rows,
                            _final_run_size, _seq_size, out_width)

MAX_BLOCK = 1 << 16           # the widest row with 16-bit tables
MAX_ROW = 2 * MAX_BLOCK       # the widest row: a 64 KB prefix, 64 KB source
MAX_DISTANCE = 65535          # the farthest a match reaches back
DEFAULT_LEVEL = 9
SUFFICIENT_LEN = 64           # the walk stops once the best score reaches it
LANES = 32                    # candidates per round: a warp's lanes
POSITIONS = 2                 # positions searched at once (P in csrc/hc.cu)
TABLE_ROWS = 128              # rows per sort in hc_sorted_tables


def _chain_deltas(keys: torch.Tensor) -> torch.Tensor:
    """[B, N] keys -> [B, N] int64: lane p holds p - p' for the nearest
    p' < p with an equal key, when that is within 65535, else 0.  The
    stable sort keeps equal keys in position order."""
    skey, perm = torch.sort(keys, dim=1, stable=True)
    d = torch.where(skey[:, 1:] == skey[:, :-1], perm[:, 1:] - perm[:, :-1],
                    0)
    d = torch.where(d <= 65535, d, 0)
    out = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    out[:, 1:] = d
    # un-permute: the delta found for sorted slot i belongs to position perm[i]
    return torch.zeros_like(out).scatter_(1, perm, out)


def cand_delta48_rows(val: torch.Tensor) -> torch.Tensor:
    """[B, N] int32 val32 rows -> [B, N] int32: the 4-byte chain's delta in
    the low 16 bits, the 8-byte chain's in the high 16 (the key of lane p is
    ``(val[p], val[p + 4])``, the +4 lane wrapping at the row end)."""
    v = val.to(torch.int64)
    d4 = _chain_deltas(val)
    d8 = _chain_deltas((v << 32) | (torch.roll(v, -4, dims=1) & 0xFFFFFFFF))
    w = d4 | (d8 << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _val32_rows(rows: torch.Tensor) -> torch.Tensor:
    """val32 lanes of [B, NS] uint8 rows, wrapping at the row end as in the
    JAX package."""
    return le32_lanes(torch.cat([rows, rows[:, :3]], 1))


def hc_tables(rows: torch.Tensor) -> torch.Tensor:
    """The d48 chain table of [B, NS] uint8 rows (``cand_delta48_rows``),
    which ``_hc_row_plain`` walks."""
    return cand_delta48_rows(_val32_rows(rows))


def _u16(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 65535] -> int16 with the same 16 bits."""
    return (t - ((t >> 15) << 16)).to(torch.int16)


def table_dtype(ns: int) -> torch.dtype:
    """The dtype of kernel I's tables for rows of ``ns`` bytes: int16
    holding unsigned 16-bit positions up to 64 KB, int32 past it."""
    return torch.int16 if ns <= MAX_BLOCK else torch.int32


@trace.timed("tables")
def hc_sorted_tables(rows: torch.Tensor):
    """Kernel I's tables for [B, NS] uint8 rows: ``(perm, slot)``, both
    [B, NS] of ``table_dtype(NS)``.

    ``perm[b]`` is one stable sort of row b's val32 lanes (wrapping at the
    row end): the positions in key order, equal keys in position order.
    ``slot[b]`` is its inverse.  The 4-byte chain of p is
    ``perm[slot[p] - 1], perm[slot[p] - 2], ...`` for as long as the key
    equals p's.  Rows are sorted TABLE_ROWS at a time, which bounds the
    sort's temporaries."""
    B, NS = rows.shape
    dev = rows.device
    dtype = table_dtype(NS)
    narrow = _u16 if dtype == torch.int16 else (lambda t: t)
    perm = torch.empty((B, NS), dtype=dtype, device=dev)
    slot = torch.empty((B, NS), dtype=dtype, device=dev)
    for g in range(0, B, TABLE_ROWS):
        r = rows[g:g + TABLE_ROWS]
        _, p = torch.sort(_val32_rows(r), dim=1, stable=True)
        pos = torch.arange(NS, device=dev).expand_as(p)
        perm[g:g + TABLE_ROWS] = narrow(p)
        slot[g:g + TABLE_ROWS] = narrow(torch.empty_like(p).scatter_(1, p,
                                                                     pos))
    return perm, slot


def encode_blocks_hc(rows: torch.Tensor, src_lens: torch.Tensor,
                     level: int = DEFAULT_LEVEL, tails: bool = False,
                     window_lens: Optional[torch.Tensor] = None):
    """HC-compress a batch of blocks, each behind an optional prefix.

    Args:
      rows: [B, NS] uint8 rows ``[prefix | source]``, zero padded; NS a
        multiple of 128, at most MAX_ROW (128 KB).
      src_lens: [B] int32 source lengths.
      level: clamped to 1..16; a walk tries at most 1 << (level - 1)
        candidates.
      tails: also return each row's offset of the token of its final
        literal-only sequence ([B] int32), as ``encode_blocks_linked``
        does.
      window_lens: optional [B] int32 prefix lengths (none when absent):
        row b's source starts at byte ``window_lens[b]``, and its matches
        may reach into the bytes before it, at most 65,535 back.  Clamped
        to the row as kernel H clamps them: window_lens to [0, NS],
        src_lens to [0, NS - window_lens].

    Returns (out [B, M] uint8, olen [B] int32), M = 128-aligned
    compress_bound(NS), and the tails when asked; ``out[b, :olen[b]]`` is
    the source's block alone, which decodes with the prefix as its
    dictionary.  A row of length 0 still gets its one-byte block.
    """
    _check_rows(rows, src_lens, window_lens)
    return _scan(rows, src_lens, hc_sorted_tables(rows), level, tails,
                 window_lens)


def _check_rows(rows, src_lens, window_lens=None) -> None:
    check(rows, "rows", torch.uint8, 2)
    B, NS = rows.shape
    if NS % 128:
        raise ValueError("NS must be a multiple of 128")
    if NS > MAX_ROW:
        raise ValueError(f"block too large for the HC kernel ({NS})")
    for t, name in ((src_lens, "src_lens"), (window_lens, "window_lens")):
        if t is not None:
            check(t, name, torch.int32, 1)
            if t.shape[0] != B:
                raise ValueError(f"{name} must be [B]")


def hc_scan(rows: torch.Tensor, src_lens: torch.Tensor, tables,
            level: int = DEFAULT_LEVEL, tails: bool = False,
            window_lens: Optional[torch.Tensor] = None):
    """Kernel I proper: the parse of ``encode_blocks_hc`` over the
    ``(perm, slot)`` tables of ``hc_sorted_tables``.  Launches csrc/hc.cu
    for tensors on the card, runs ``hc_row_rounds_plain`` for tensors on the
    CPU.  Returns as ``encode_blocks_hc`` does."""
    _check_rows(rows, src_lens, window_lens)
    perm, slot = tables
    dtype = table_dtype(rows.shape[1])
    check(perm, "perm", dtype, 2)
    check(slot, "slot", dtype, 2)
    if perm.shape != rows.shape or slot.shape != rows.shape:
        raise ValueError("perm and slot must be [B, NS]")
    return _scan(rows, src_lens, (perm, slot), level, tails, window_lens)


def _spans(src_lens, window_lens, NS):
    """Each row's (prefix length, source length), clamped to the row."""
    lens = src_lens.tolist()
    wls = [0] * len(lens) if window_lens is None else window_lens.tolist()
    return [(w, min(max(n, 0), NS - w))
            for w, n in zip((min(max(w, 0), NS) for w in wls), lens)]


def _scan(rows, src_lens, tables, level, tails=False, window_lens=None):
    """hc_scan on checked arguments."""
    perm, slot = tables
    B, NS = rows.shape
    M = out_width(NS)
    max_attempts = 1 << (max(1, min(int(level), 16)) - 1)
    extra = () if window_lens is None else (window_lens,)
    if not use_kernel(rows, src_lens, perm, slot, *extra):
        PLAIN_CALLS["encode_hc"] += 1
        out = torch.zeros((B, M), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        tail = []
        _fill_rows(out, olen, [
            hc_row_rounds_plain(rows[b].numpy().tobytes(), n, perm[b].numpy(),
                                slot[b].numpy(), max_attempts, tails=tail,
                                start=w)
            for b, (w, n) in enumerate(_spans(src_lens, window_lens, NS))])
        if tails:
            return out, olen, torch.tensor(tail, dtype=torch.int32)
        return out, olen
    out = torch.empty((B, M), dtype=torch.uint8, device=rows.device)
    olen = torch.empty((B,), dtype=torch.int32, device=rows.device)
    tail = torch.empty((B,), dtype=torch.int32, device=rows.device) \
        if tails else None
    with on_device(rows.device):
        err = build.kernels_lib().lz4tt_encode_hc(
            rows.data_ptr(), NS, perm.data_ptr(), slot.data_ptr(),
            int(perm.dtype == torch.int32), src_lens.data_ptr(),
            window_lens.data_ptr() if window_lens is not None else None,
            out.data_ptr(), M, olen.data_ptr(),
            tail.data_ptr() if tails else None, B, max_attempts,
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check_launch("encode_hc", err)
    LAUNCHES["encode_hc"] += 1
    return (out, olen, tail) if tails else (out, olen)


# ---------------------------------------------------------------------------
# plain versions of the parse (CPU tensors)
# ---------------------------------------------------------------------------

def _hc_row_plain(buf: bytes, n: int, d48: np.ndarray, max_attempts: int,
                  start: int = 0, capacity: Optional[int] = None):
    """One row's HC parse, the serial walk over the d48 table: the same
    decisions as the JAX kernel.  Forward lengths come from byte runs
    instead of the kernels' words and XOR tail; every candidate shares its
    first 4 bytes with p, so both give min(common run, matchlimit - p).

    The source is ``buf[start:start + n]``, behind the prefix
    ``buf[:start]``.  With ``capacity``, the walk stops before the first
    sequence that does not fit with a final run of its tail (at most 5
    literals), as ``lz4_tpu.hc.compress_hc_dest_size`` does, and returns
    (the sequences, the anchor) without a final run."""
    out = bytearray()
    end = start + n
    if n < 13:
        if capacity is not None:
            return out, start
        _emit_final(out, buf, start, end)
        return out
    u = np.frombuffer(buf, np.uint8).astype(np.uint32)
    u = np.concatenate([u, u[:3]])
    val = memoryview(u[:-3] | (u[1:-2] << 8) | (u[2:-1] << 16) | (u[3:] << 24))
    d = memoryview(d48.astype(np.int64))
    mflimit, matchlimit = end - 12, end - 5

    def search(p: int, anchor: int):
        """Walk p's chain for the widest match: (score, forward length,
        candidate position); score < 4 means none."""
        d0 = d[p] & 0xFFFF
        cand = p - d0 if d0 > 0 else p
        vp4 = val[p + 4]
        tier8 = 8 + p - anchor
        gmax = matchlimit - p - 1
        room = matchlimit - p - 4
        att, bs, bf, bp = max_attempts, 0, 0, 0
        while att > 0 and bs < SUFFICIENT_LEN and 0 <= cand < p \
                and p - cand <= MAX_DISTANCE:
            # beat-gate: extend only a candidate that can exceed the best
            g = min(max(bs - 3, 0), gmax)
            if val[cand + g] == val[p + g] or (
                    p > anchor and cand > 0 and buf[cand - 1] == buf[p - 1]):
                fwd = 4 + _common_run(buf, cand + 4, p + 4, room)
                k = 0
                while p - k > anchor and cand - k > 0 and \
                        buf[p - k - 1] == buf[cand - k - 1]:
                    k += 1
                if fwd + k > bs:
                    bs, bf, bp = fwd + k, fwd, cand
            pair = d[cand]
            if bs >= tier8 and val[cand + 4] == vp4:
                step = (pair >> 16) & 0xFFFF        # the 8-byte chain
            else:
                step = pair & 0xFFFF
            cand = cand - step if step > 0 else p   # 0 ends the chain
            att -= 1
        return bs, bf, bp

    ip = anchor = start
    while ip <= mflimit:
        sc, ml, mpos = search(ip, anchor)
        if sc < 4:
            ip += 1
            continue
        # lazy: defer while the next position yields a strictly wider match
        cur = ip
        while cur + 1 <= mflimit:
            sc2, ml2, mp2 = search(cur + 1, anchor)
            if sc2 <= sc:
                break
            cur, sc, ml, mpos = cur + 1, sc2, ml2, mp2
        mp, q = cur, mpos
        while mp > anchor and q > 0 and buf[mp - 1] == buf[q - 1]:
            mp -= 1
            q -= 1
        ml += cur - mp
        if capacity is not None and len(out) + _seq_size(
                mp - anchor, ml - 4) + _final_run_size(
                    min(5, end - (mp + ml))) > capacity:
            return out, anchor
        _emit_seq(out, buf, anchor, mp - anchor, cur - mpos, ml - 4)
        ip = anchor = mp + ml
    if capacity is not None:
        return out, anchor
    _emit_final(out, buf, anchor, end)
    return out


def hc_scan_serial(rows: torch.Tensor, src_lens: torch.Tensor,
                   level: int = DEFAULT_LEVEL,
                   window_lens: Optional[torch.Tensor] = None):
    """The parse of ``encode_blocks_hc`` by the serial walk
    ``_hc_row_plain`` over the d48 table of ``hc_tables``, for rows on the
    CPU: the reference that ``hc_row_rounds_plain`` and kernel I are held
    against.  Returns (out, olen) as ``hc_scan`` does."""
    _check_rows(rows, src_lens, window_lens)
    B, NS = rows.shape
    d48 = hc_tables(rows).numpy()
    max_attempts = 1 << (max(1, min(int(level), 16)) - 1)
    out = torch.zeros((B, out_width(NS)), dtype=torch.uint8)
    olen = torch.zeros((B,), dtype=torch.int32)
    _fill_rows(out, olen, [
        _hc_row_plain(rows[b].numpy().tobytes(), n, d48[b], max_attempts,
                      start=w)
        for b, (w, n) in enumerate(_spans(src_lens, window_lens, NS))])
    return out, olen


def hc_row_rounds_plain(buf: bytes, n: int, perm: np.ndarray,
                        slot: np.ndarray, max_attempts: int,
                        lanes: int = LANES, positions: int = POSITIONS,
                        stats: Optional[collections.Counter] = None,
                        tails: Optional[list] = None,
                        start: int = 0) -> bytearray:
    """One row's HC parse as csrc/hc.cu decomposes it; the same bytes as
    ``_hc_row_plain``.  ``perm`` and ``slot`` are the row's tables from
    ``hc_sorted_tables``; the source is ``buf[start:start + n]``, behind
    the prefix ``buf[:start]``.

    A search reads the 4-byte chain of p as the run before p's slot, in
    rounds of ``lanes`` candidates; a lane holds a candidate while it lies
    before p, at most MAX_DISTANCE back, and shares p's 4 bytes (the run
    is newest first, so the first lane too far back ends the chain).  Every lane scores its candidate
    (forward plus backward run) unless the beat gate, against the best at
    the round's start, shows it cannot win.  The round then makes the
    serial walk's decisions at once: the best after lane i is the prefix
    maximum; the switch to the 8-byte chain falls on the first lane whose
    best reaches ``8 + p - anchor`` and whose bytes 4..7 equal p's; after
    it only such lanes are visited and count against the budget; the walk
    stops after the first visited lane where the budget runs out or the
    best reaches SUFFICIENT_LEN, or at the run's end; the hit is the first
    lane that holds the final maximum.  Each of these is a prefix
    quantity (a prefix maximum, the first lane of a ballot, a popcount of
    the lanes below), so the lanes after the stop lane change nothing and
    the model scores the lanes in order up to it.  ``positions``
    consecutive positions are searched at once, and the lazy parse reads
    their results in order; the take's backward run is the one its
    search counted.

    ``stats``, when given, counts the kernel's schedule: it then searches
    every position of a batch, as the kernel does, and adds up
    ``searches``, ``rounds``, ``batches``, ``path_rounds`` (per batch the
    rounds of its longest search: the row's critical path), the rounds
    that the budget stops before their last lane (``budget_mid_round``)
    and those that switch to the 8-byte chain at a lane that is neither
    their first nor their last (``switch_mid_round``).  ``tails``, when
    given, gets the offset of the final literal run's token."""
    out = bytearray()
    end = start + n
    if n < 13:
        if tails is not None:
            tails.append(0)
        _emit_final(out, buf, start, end)
        return out
    u = np.frombuffer(buf, np.uint8).astype(np.int64)
    u = np.concatenate([u, u[:3]])
    val = (u[:-3] | (u[1:-2] << 8) | (u[2:-1] << 16) | (u[3:] << 24)).tolist()
    mask = 0xFFFF if perm.dtype == np.int16 else -1
    perm = (perm.astype(np.int64) & mask).tolist()
    slot = (slot.astype(np.int64) & mask).tolist()
    mflimit, matchlimit = end - 12, end - 5

    def search(p: int, anchor: int):
        """(score, forward length, candidate position) of p's widest
        match; score < 4 means none."""
        vp, vp4 = val[p], val[p + 4]
        tier8 = 8 + p - anchor
        gmax = matchlimit - p - 1
        room = matchlimit - p - 4
        bs = bf = bp = 0
        att, switched = max_attempts, False
        i = slot[p] - 1
        rounds[0] = 0
        while True:                     # one round
            rounds[0] += 1
            g = min(max(bs - 3, 0), gmax)   # the gate's best: the round's start
            pm, cnt, sw = bs, 0, switched
            for k in range(lanes):
                c = perm[i - k] if i - k >= 0 else p
                if c >= p or p - c > MAX_DISTANCE or val[c] != vp:
                    return pm, bf, bp   # the run ends: so does the chain
                if val[c + g] == val[p + g] or (
                        p > anchor and c > 0 and buf[c - 1] == buf[p - 1]):
                    fwd = 4 + _common_run(buf, c + 4, p + 4, room)
                    back = 0
                    while p - back > anchor and c - back > 0 and \
                            buf[p - back - 1] == buf[c - back - 1]:
                        back += 1
                    if fwd + back > pm:     # the first lane of a new maximum
                        pm, bf, bp = fwd + back, fwd, c
                m8 = val[c + 4] == vp4
                if sw:
                    visited = m8            # past the switch: the 8-byte chain
                else:
                    visited = True
                    sw = m8 and pm >= tier8     # this lane is the switch lane
                    if sw and stats is not None and 0 < k < lanes - 1:
                        stats["switch_mid_round"] += 1
                cnt += visited
                if visited and (cnt == att or pm >= SUFFICIENT_LEN):
                    if stats is not None and cnt == att and \
                            k < lanes - 1:
                        stats["budget_mid_round"] += 1
                    return pm, bf, bp   # the stop lane
            bs, att, switched = pm, att - cnt, sw
            i -= lanes

    rounds = [0]                         # the last search's rounds
    ip = anchor = start
    pending = None                       # (score, fwd, pos, cur)
    while True:
        q0 = pending[3] + 1 if pending else ip
        took = q0 > mflimit
        if not took:
            batch = range(q0, min(q0 + positions, mflimit + 1))
            if stats is not None:
                found = {}
                for q in batch:
                    found[q] = search(q, anchor)
                    stats["searches"] += 1
                    stats["rounds"] += rounds[0]
                    stats["path"] = max(stats["path"], rounds[0])
                stats["batches"] += 1
                stats["path_rounds"] += stats.pop("path")
            for q in batch:
                sc, f, pos = found[q] if stats is not None else \
                    search(q, anchor)
                if pending is None:
                    if sc < 4:
                        ip = q + 1
                        continue
                    pending = (sc, f, pos, q)
                elif sc <= pending[0]:
                    took = True
                    break
                else:
                    pending = (sc, f, pos, q)
        if took:
            if pending is None:
                break
            # the hit's backward run is the one its search counted
            sc, f, pos, cur = pending
            mp = cur - (sc - f)
            _emit_seq(out, buf, anchor, mp - anchor, cur - pos, sc - 4)
            ip = anchor = mp + sc
            pending = None
    if tails is not None:
        tails.append(len(out))
    _emit_final(out, buf, anchor, end)
    return out
