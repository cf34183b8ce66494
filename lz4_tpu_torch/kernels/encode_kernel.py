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
  its jump table is 4-granular.
* ``encode_blocks`` (kernel B): independent rows of up to 256 KB, with a
  full-resolution jump table.

The tables are PyTorch ops (the JAX package left them to XLA).  Each wrapper
launches its CUDA kernel for tensors on the card and runs the plain Python
scan below for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import spec
from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, le32_lanes, use_kernel

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
        tf = sv4[:, 1:] ^ sv4[:, :-1]       # bytes +4..+7 (byte +4 = key)
        tb = svm4[:, 1:] ^ svm4[:, :-1]     # bytes -4..-1
        m5 = (tf & 0x00FF00) == 0
        m6 = (tf & 0xFFFF00) == 0
        m7 = tf == 0
        fwd = 5 + m5.int() + m6.int() + m7.int()          # exact up to 8
        n4 = tb == 0
        bwd = ((((tb >> 24) & 0xFF) == 0).int()
               + (((tb >> 16) & 0xFFFF) == 0).int()
               + (((tb >> 8) & 0xFFFFFF) == 0).int() + n4.int())
        mm_row = torch.as_tensor(filter_mm, dtype=torch.int32,
                                 device=val.device).reshape(-1, 1)
        same &= m7 | n4 | (fwd + bwd >= mm_row)
    d = torch.where(same, sp[:, 1:] - sp[:, :-1], 0)
    d = torch.where(d <= 65535, d, 0)
    out = torch.zeros((B, N), dtype=torch.int64, device=val.device)
    out[:, 1:] = d
    # un-permute: the delta found for sorted slot i belongs to position sp[i]
    return torch.zeros_like(out).scatter_(1, sp, out).to(torch.int32)


def _next_candidate(d: torch.Tensor) -> torch.Tensor:
    """[R, N] deltas -> [R, N] position of the next lane >= p holding a
    candidate (N when none)."""
    N = d.shape[1]
    pos = torch.arange(N, dtype=torch.int32, device=d.device)
    cand = torch.where(d > 0, pos, N).flip(1)
    return torch.cummin(cand, dim=1).values.flip(1)


def linked_tables(stream: torch.Tensor, nb: int, min_match: int = 4,
                  zero_window_lanes: Optional[torch.Tensor] = None):
    """Candidate and jump tables of kernel A for ``nb`` linked 64 KB blocks.

    ``stream`` is [S, L] uint8: row s holds stream s's 64 KB window, then
    its ``nb`` blocks, zeros past the data.  The val32 tiles reproduce the
    JAX package's ``[window | K blocks]`` layout, including its edges: the
    last 3 lanes of the final block row wrap to that row's start when no
    padding row follows it, and read zeros when one does.
    ``zero_window_lanes`` ([S] int32, optional) zeroes block 0's window lanes
    below ``WINDOW - zero_window_lanes[s]``, as the JAX package's chunked
    window builder does.

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
    filt = min_match if min_match >= 6 else None
    d_tiles = cand_delta_rows(tiles.reshape(S * T, (K + 1) * WINDOW), filt)
    delta = d_tiles[:, WINDOW:].reshape(S, T * K, WINDOW)[:, :nb]
    delta = delta.reshape(S * nb, WINDOW).clone()
    # matches never start in a block's last 12 bytes: masking them keeps
    # the parse independent of the tile layout
    delta[:, WINDOW - 12:] = 0
    jump = _next_candidate(delta)[:, ::4].contiguous()
    return delta, jump


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
                min_match: int, reject_step: int) -> bytearray:
    """One block's greedy parse; positions index ``buf`` directly.  Same
    decisions as the kernels' scan (csrc/encode.cu) and the JAX package's."""
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
    _emit_final(out, buf, anchor, n_end)
    return out


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
                         zero_window_lanes: bool = False):
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

    Returns (out [S, NB, M] uint8, olen [S, NB] int32); only
    ``out[s, k, :olen[s, k]]`` is meaningful.
    """
    if prefix_lens is None:
        prefix_lens = torch.zeros((src_lens.shape[0],), dtype=torch.int32,
                                  device=stream.device)
    _check_linked(stream, src_lens, prefix_lens)
    delta, jump = linked_tables(stream, src_lens.shape[1], min_match,
                                prefix_lens if zero_window_lanes else None)
    return scan_linked(stream, src_lens, prefix_lens, delta, jump,
                       acceleration, min_match, reject_step)


def _check_linked(stream, src_lens, prefix_lens) -> None:
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


def scan_linked(stream: torch.Tensor, src_lens: torch.Tensor,
                prefix_lens: torch.Tensor, delta: torch.Tensor,
                jump: torch.Tensor, acceleration: int = 1,
                min_match: int = 4, reject_step: int = 1):
    """Kernel A proper: the scan of ``encode_blocks_linked`` over tables
    from ``linked_tables``.  Launches csrc/encode.cu for tensors on the
    card, runs the plain scan for tensors on the CPU."""
    _check_linked(stream, src_lens, prefix_lens)
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
                                    reject_step)
    dev = stream.device
    out = torch.empty((S, NB, M), dtype=torch.uint8, device=dev)
    olen = torch.empty((S, NB), dtype=torch.int32, device=dev)
    err = build.kernels_lib().lz4tt_encode_linked(
        stream.data_ptr(), stream.stride(0), delta.data_ptr(),
        jump.data_ptr(), src_lens.data_ptr(), prefix_lens.data_ptr(),
        out.data_ptr(), M, olen.data_ptr(), S, NB, int(acceleration),
        int(min_match), int(reject_step),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("encode_linked", err)
    LAUNCHES["encode_linked"] += 1
    return out, olen


def _encode_linked_plain(stream, src_lens, prefix_lens, delta, jump, M,
                         acceleration, min_match, reject_step):
    PLAIN_CALLS["encode_linked"] += 1
    S, NB = src_lens.shape
    lens = src_lens.tolist()
    prefix = prefix_lens.tolist()
    out = torch.zeros((S, NB, M), dtype=torch.uint8)
    olen = torch.zeros((S, NB), dtype=torch.int32)
    for s in range(S):
        buf = stream[s].numpy().tobytes()
        rows = []
        for k in range(NB):
            n = min(lens[s][k], WINDOW)          # clamped as in the kernel
            if n <= 0:
                rows.append(b"")
                continue
            start = (k + 1) * WINDOW
            pre = min(max(prefix[s], 0), WINDOW) if k == 0 else WINDOW
            r = s * NB + k
            rows.append(_scan_plain(
                buf, start, n, start - pre, start + (0 if pre > 0 else 1),
                delta[r].tolist(), jump[r].tolist(), True, acceleration,
                min_match, reject_step))
        _fill_rows(out[s], olen[s], rows)
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
    out = torch.empty((B, M), dtype=torch.uint8, device=src_rows.device)
    olen = torch.empty((B,), dtype=torch.int32, device=src_rows.device)
    err = build.kernels_lib().lz4tt_encode(
        src_rows.data_ptr(), NS, delta.data_ptr(), jump.data_ptr(),
        src_lens.data_ptr(), out.data_ptr(), M, olen.data_ptr(), B,
        int(acceleration), int(min_match), int(reject_step),
        torch.cuda.current_stream(src_rows.device).cuda_stream)
    build.check_launch("encode", err)
    LAUNCHES["encode"] += 1
    return out, olen
