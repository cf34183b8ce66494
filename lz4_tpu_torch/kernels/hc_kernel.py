"""High-compression (HC) block encoder: kernel I.

Counterpart of ``lz4_tpu/kernels/hc_kernel.py``.  The parse is the JAX
package's, decision for decision, so payloads are bit-identical to
``lz4_tpu``'s:

* ``cand_delta48_rows`` builds both candidate chains by sorting: lane p's low
  16 bits hold the distance to the nearest earlier position with the same 4
  bytes, its high 16 bits the same for the same 8 bytes (0 when there is
  none within 65535).  Walking ``p - d[p] - d[.] - ...`` lists every earlier
  4-byte match, newest first, with no hash table.
* The scan walks a position's chain for the widest match (forward plus
  backward length), at most ``1 << (level - 1)`` candidates.  A candidate is
  extended only if it can beat the best so far (its bytes still agree at the
  best frontier, or it can extend backward); once the best reaches
  ``8 + p - anchor`` the walk steps the 8-byte chain; it stops at
  ``SUFFICIENT_LEN``.  A match is deferred while the next position yields a
  strictly wider one (an iterative one-step lazy parse).

``hc_scan`` launches ``csrc/hc.cu`` for tensors on the card and runs the
plain Python parse below for tensors on the CPU; ``encode_blocks_hc`` builds
the table and calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, le32_lanes, use_kernel
from .encode_kernel import (_common_run, _emit_final, _emit_seq, _fill_rows,
                            out_width)

MAX_BLOCK = 1 << 16           # one independent 64 KB block per row
DEFAULT_LEVEL = 9
SUFFICIENT_LEN = 64           # the walk stops once the best score reaches it


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


def hc_tables(rows: torch.Tensor) -> torch.Tensor:
    """The chain table of kernel I for [B, NS] uint8 rows (val32 lanes wrap
    at the row end, as in the JAX package)."""
    return cand_delta48_rows(le32_lanes(torch.cat([rows, rows[:, :3]], 1)))


def encode_blocks_hc(rows: torch.Tensor, src_lens: torch.Tensor,
                     level: int = DEFAULT_LEVEL):
    """HC-compress a batch of independent blocks.

    Args:
      rows: [B, NS] uint8 rows, zero padded; NS <= 65536, a multiple of 128.
      src_lens: [B] int32 source lengths (each <= NS).
      level: clamped to 1..16; a walk tries at most 1 << (level - 1)
        candidates.

    Returns (out [B, M] uint8, olen [B] int32), M = 128-aligned
    compress_bound(NS); only ``out[b, :olen[b]]`` is meaningful.  A row of
    length 0 still gets its one-byte block.
    """
    _check_rows(rows, src_lens)
    return _scan(rows, src_lens, hc_tables(rows), level)


def _check_rows(rows, src_lens) -> None:
    check(rows, "rows", torch.uint8, 2)
    check(src_lens, "src_lens", torch.int32, 1)
    B, NS = rows.shape
    if NS % 128:
        raise ValueError("NS must be a multiple of 128")
    if NS > MAX_BLOCK:
        raise ValueError(f"block too large for the HC kernel ({NS})")
    if src_lens.shape[0] != B:
        raise ValueError("src_lens must be [B]")


def hc_scan(rows: torch.Tensor, src_lens: torch.Tensor, d48: torch.Tensor,
            level: int = DEFAULT_LEVEL):
    """Kernel I proper: the parse of ``encode_blocks_hc`` over a table from
    ``hc_tables``.  Launches csrc/hc.cu for tensors on the card, runs the
    plain parse for tensors on the CPU."""
    _check_rows(rows, src_lens)
    check(d48, "d48", torch.int32, 2)
    if d48.shape != rows.shape:
        raise ValueError("d48 must be [B, NS]")
    return _scan(rows, src_lens, d48, level)


def _scan(rows, src_lens, d48, level):
    """hc_scan on checked arguments."""
    B, NS = rows.shape
    M = out_width(NS)
    max_attempts = 1 << (max(1, min(int(level), 16)) - 1)
    if not use_kernel(rows, src_lens, d48):
        PLAIN_CALLS["encode_hc"] += 1
        out = torch.zeros((B, M), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        lens = src_lens.tolist()
        _fill_rows(out, olen, [
            _hc_row_plain(rows[b].numpy().tobytes(),
                          min(max(lens[b], 0), NS), d48[b].numpy(),
                          max_attempts) for b in range(B)])
        return out, olen
    out = torch.empty((B, M), dtype=torch.uint8, device=rows.device)
    olen = torch.empty((B,), dtype=torch.int32, device=rows.device)
    err = build.kernels_lib().lz4tt_encode_hc(
        rows.data_ptr(), NS, d48.data_ptr(), src_lens.data_ptr(),
        out.data_ptr(), M, olen.data_ptr(), B, max_attempts,
        torch.cuda.current_stream(rows.device).cuda_stream)
    build.check_launch("encode_hc", err)
    LAUNCHES["encode_hc"] += 1
    return out, olen


# ---------------------------------------------------------------------------
# plain version of the parse (CPU tensors)
# ---------------------------------------------------------------------------

def _hc_row_plain(buf: bytes, n: int, d48: np.ndarray,
                  max_attempts: int) -> bytearray:
    """One row's HC parse; the same decisions as csrc/hc.cu and the JAX
    kernel.  ``d48`` is the row's chain table.  Forward lengths come from
    byte runs instead of the kernels' words and XOR tail; every candidate
    shares its first 4 bytes with p, so both give min(common run,
    matchlimit - p)."""
    out = bytearray()
    if n < 13:
        _emit_final(out, buf, 0, n)
        return out
    u = np.frombuffer(buf, np.uint8).astype(np.uint32)
    u = np.concatenate([u, u[:3]])
    val = memoryview(u[:-3] | (u[1:-2] << 8) | (u[2:-1] << 16) | (u[3:] << 24))
    d = memoryview(d48.astype(np.int64))
    mflimit, matchlimit = n - 12, n - 5

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
                and p - cand <= 65535:
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

    ip = anchor = 0
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
        _emit_seq(out, buf, anchor, mp - anchor, cur - mpos, ml - 4)
        ip = anchor = mp + ml
    _emit_final(out, buf, anchor, n)
    return out
