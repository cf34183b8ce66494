"""The destSize encoders: kernel H (a batch of bounded blocks) and kernel G
(the scatter-gather chain).

Both run one parse, ``_dest_size_block``: a greedy hash-table scan that
fills a bounded destination, stops at a token boundary when the next
sequence and a minimal final literal run would not fit, and reports the
source bytes its block covers.

``encode_blocks_dest_size`` is the counterpart of
``lz4_tpu/kernels/destsize_kernel.py`` ``encode_blocks_dest_size``
(``_make_destsize_kernel``, launched by ``_encode_dest_size``): every row
holds ``[prefix | source]`` and has its own capacity; matches may reach into
the prefix (LZ4_compress_fast_destSize, with a prefix the ``_continue``
form).  It launches ``csrc/destsize.cu`` for tensors on the card and runs
the plain version for tensors on the CPU.

``sg_encode_chain`` is the counterpart of ``sg_encode_chain``
(``_make_sg_chain_kernel``, launched by ``_sg_encode_chain``): the whole
LZ4_SG buffer-pair walk of ``sg_compress`` in one sequential pass.  Each
step takes the rest of the current input buffer (at most 64 KB of it) and
destSize-compresses it into the room left in the current output buffer,
then advances the walk the way ``sg.sg_compress`` does (input buffer
switch, output buffer switch with an optional 5-byte zero-pad block).  A
16K-entry hash table of global positions persists across every step and
buffer, and a match may reach back to the start of the previous input
buffer (the window the SG decoder keeps).

The parse is the JAX kernel's, decision for decision, so every step's block
bytes, lengths and consumed counts are bit-identical to ``lz4_tpu``'s
wherever its int32 capacity arithmetic is exact: ``_div255`` is exact here,
so a final literal run of 65,295 bytes or more never passes its room.

``sg_encode_chain`` launches ``csrc/sg_chain.cu`` for tensors on the card
and runs ``sg_encode_chain_plain`` for tensors on the CPU.  Unlike the TPU
kernel, which wrote every step into its own ``[T, M]`` row, both write the
steps' blocks one after another into one flat buffer at ``boff``.

On the card one warp runs the parse, in rounds of 32 speculative probes;
``dest_size_block_rounds_plain`` is that schedule on the CPU, and the tests
hold it equal to ``_dest_size_block``.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import spec
from . import build
from .common import (LAUNCHES, PLAIN_CALLS, check, to_device, on_device,
                     use_kernel)
from .encode_kernel import (MAX_BLOCK, _common_run, _emit_final, _emit_seq,
                            _fill_rows, _final_run_size, _seq_size,
                            out_width)

HASH_LOG = 14
HASH_SIZE = 1 << HASH_LOG
SKIP_TRIGGER = 6
PRIME = 2654435761          # -1640531535 as an unsigned 32-bit word
SG_HEADER = spec.SG_FRAME_HEADER_SIZE
BH = spec.BLOCK_HEADER_SIZE
CHAIN_BLOCK = 65536         # source bytes a step takes at most
TAIL = 8                    # bytes the input holds past the content
MAX_TOTAL = 1 << 28         # the walk's envelope (int32 positions)


class ChainEnvelopeError(ValueError):
    """The input is outside the chain encoder's envelope."""


def _div255(y: int) -> int:
    """y // 255 for y >= 0.  The JAX kernel's int32 magic multiply is exact
    only below 65,280 and sizes literal runs of 65,295 bytes or more short;
    the port does not copy that."""
    return y // 255


def _max_final_literals(room: int, avail: int) -> int:
    """Largest L <= avail with _final_run_size(L) <= room (-1 if none): the
    JAX kernel's closed-form guess and its two fix-ups."""
    best14 = min(min(room - 1, 14), avail)
    guess = min(avail, room - 2 - _div255(max(room - 17, 0)))

    def fix(g):
        return g - 1 if g >= 15 and _final_run_size(g) > room else g

    guess = fix(fix(guess))
    big_ok = guess >= 15 and _final_run_size(guess) <= room
    best = max(guess, best14) if big_ok else best14
    return -1 if room < 1 else best


# ---------------------------------------------------------------------------
# the block parse both kernels share (plain version)
# ---------------------------------------------------------------------------

def _hash_table_inputs(u: np.ndarray):
    """LE32 word and 5-byte hash at every position of ``u``, as memoryviews
    (scalar reads return Python ints)."""
    w = (u[:-3].astype(np.uint32) | (u[1:-2].astype(np.uint32) << 8)
         | (u[2:-1].astype(np.uint32) << 16)
         | (u[3:].astype(np.uint32) << 24))
    p = np.uint32(PRIME)
    x = (w[:-1] ^ (u[4:].astype(np.uint32) * p)) * p
    h = ((x >> np.uint32(32 - HASH_LOG)) & np.uint32(HASH_SIZE - 1))
    return memoryview(w), memoryview(h.astype(np.int32))


def _dest_size_block(data: bytes, vals, hashes, table: List[int], start: int,
                     n_end: int, low: int, first: int, cap: int,
                     acceleration: int, min_match: int
                     ) -> Tuple[bytearray, int]:
    """One destSize block, as ``csrc/destsize.cuh`` dest_size_block: source
    bytes ``data[start:n_end]`` into at most ``cap`` bytes.  Matches reach
    back to ``low``; ``table`` holds positions into ``data`` (-1 where
    empty) and keeps its entries for the next call; the scan starts at
    ``first``.  ``vals`` and ``hashes`` come from ``_hash_table_inputs`` and
    are read only when the scan runs (13 bytes or more).  Returns (block,
    consumed), both empty and 0 when not one literal fits.

    The forward extension compares byte runs instead of the kernel's
    4-byte words and XOR tail; both give min(common run, matchlimit - mp).
    """
    mflimit, matchlimit = n_end - 12, n_end - 5
    accel0 = acceleration << SKIP_TRIGGER
    out = bytearray()
    ip, anchor, scnt = first, start, accel0
    while n_end - start >= 13 and ip <= mflimit:
        h = hashes[ip]
        e = table[h]
        table[h] = ip
        # a capacity-stopped block may have left entries at or past ip
        if not (low <= e < ip and ip - e <= 65535 and vals[e] == vals[ip]):
            ip += scnt >> SKIP_TRIGGER
            scnt += 1
            continue
        mp, q2 = ip, e
        while mp > anchor and q2 > low and data[mp - 1] == data[q2 - 1]:
            mp -= 1
            q2 -= 1
        room = matchlimit - ip - 4
        ml = ip + 4 - mp + _common_run(data, e + 4, ip + 4, room)
        if ml < min_match:          # (min_match > 4): a skip, not a stop
            ip += scnt >> SKIP_TRIGGER
            scnt += 1
            continue
        litlen = mp - anchor
        need = _seq_size(litlen, ml - 4) + _final_run_size(
            min(5, n_end - (mp + ml)))
        if len(out) + need > cap:
            break                   # capacity stop
        _emit_seq(out, data, anchor, litlen, ip - e, ml - 4)
        ip = anchor = mp + ml
        table[hashes[ip - 2]] = ip - 2
        scnt = accel0
    lit = _max_final_literals(cap - len(out), n_end - anchor)
    if lit < 0:
        return bytearray(), 0
    _emit_final(out, data, anchor, anchor + lit)
    return out, anchor - start + lit


# ---------------------------------------------------------------------------
# the same parse as the card's warp runs it
# ---------------------------------------------------------------------------

WARP = 32                   # probes per round, and bytes per ballot


def _skip_sum(scnt: int, k: int) -> int:
    """How far k probes without a match move ip from a skip count of
    ``scnt``: the sum of (scnt + i) >> SKIP_TRIGGER over i < k, in the
    closed form lane k of the kernel computes."""
    def below(n):               # sum of j >> SKIP_TRIGGER over j < n
        q, r = n >> SKIP_TRIGGER, n & ((1 << SKIP_TRIGGER) - 1)
        return ((q * (q - 1) // 2) << SKIP_TRIGGER) + q * r
    return below(scnt + k) - below(scnt)


def _first_diff(x: bytes, y: bytes) -> int:
    return next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))


def _warp_runs(data: bytes, p: int, e: int, back_limit: int, fwd_limit: int,
               counts) -> Tuple[int, int]:
    """The common runs at a match of p with e, as the kernel's warp_runs
    measures them: backward from p - 1 and e - 1 (at most ``back_limit``)
    and forward from p + 4 and e + 4 (at most ``fwd_limit``), both WARP
    bytes a round (a byte a lane, one ballot a side), until both ends are
    found."""
    back = -1 if back_limit > 0 else 0
    fwd, k = -1, 0
    while back < 0 or fwd < 0:
        counts["ballots"] += 1
        if back < 0:
            n = min(WARP, back_limit - k)
            i = _first_diff(data[p - k - n:p - k][::-1],
                            data[e - k - n:e - k][::-1])
            if i < WARP:            # a difference, or the limit
                back = k + i
        if fwd < 0:
            n = min(WARP, fwd_limit - k)
            i = _first_diff(data[p + 4 + k:p + 4 + k + n],
                            data[e + 4 + k:e + 4 + k + n])
            if i < WARP:
                fwd = k + i
        k += WARP
    return back, fwd


def dest_size_block_rounds_plain(data: bytes, vals, hashes, table: List[int],
                                 start: int, n_end: int, low: int,
                                 first: int, cap: int, acceleration: int,
                                 min_match: int, counts=None
                                 ) -> Tuple[bytearray, int]:
    """``_dest_size_block`` as one warp of ``csrc/destsize.cuh`` runs it:
    the same arguments and results, in rounds of WARP speculative probes.

    Lane k of a round probes where the serial scan would after k probes
    without a match (``_skip_sum``).  Its candidate is the position of the
    latest lower lane with the same hash slot, else the table's entry as
    it stood before the round: what the serial scan reads, since every
    probe writes its slot before the next one reads.  The lanes that pass
    the serial test are taken in lane order and extended (``_warp_runs``);
    one whose match is shorter than ``min_match`` is passed over, as the
    serial scan skips it, and the first that holds ends the round.  The
    table takes the positions of the lanes up to that one (all lanes when
    none holds), the highest lane of a slot last, even when that lane's
    sequence then stops the block at its capacity.  ``counts`` (a
    collections.Counter) adds up rounds, probes, the probes the serial scan
    makes (``serial_probes``), candidates taken from a lower lane
    (``from_lane``), extension rounds (``ballots``, a ballot a side each)
    and sequences.
    """
    counts = collections.Counter() if counts is None else counts
    mflimit, matchlimit = n_end - 12, n_end - 5
    accel0 = acceleration << SKIP_TRIGGER
    out = bytearray()
    ip, anchor, scnt = first, start, accel0
    while n_end - start >= 13 and ip <= mflimit:
        pos = [p for p in (ip + _skip_sum(scnt, k) for k in range(WARP))
               if p <= mflimit]
        hs = [hashes[p] for p in pos]
        cand, latest = [], {}
        for k, h in enumerate(hs):
            counts["from_lane"] += h in latest
            cand.append(pos[latest[h]] if h in latest else table[h])
            latest[h] = k
        counts["rounds"] += 1
        counts["probes"] += len(pos)
        m = None
        for k, (p, e) in enumerate(zip(pos, cand)):
            if not (low <= e < p and p - e <= 65535 and vals[e] == vals[p]):
                continue
            back, fwd = _warp_runs(data, p, e, min(p - anchor, e - low),
                                   matchlimit - p - 4, counts)
            mp, ml = p - back, 4 + back + fwd
            if ml >= min_match:
                m = k
                break
        serial = len(pos) if m is None else m + 1
        counts["serial_probes"] += serial
        for k in range(serial):
            table[hs[k]] = pos[k]
        if m is None:
            ip += _skip_sum(scnt, len(pos))
            scnt += len(pos)
            continue
        litlen = mp - anchor
        need = _seq_size(litlen, ml - 4) + _final_run_size(
            min(5, n_end - (mp + ml)))
        if len(out) + need > cap:
            break                   # capacity stop
        counts["sequences"] += 1
        _emit_seq(out, data, anchor, litlen, pos[m] - cand[m], ml - 4)
        ip = anchor = mp + ml
        table[hashes[ip - 2]] = ip - 2
        scnt = accel0
    lit = _max_final_literals(cap - len(out), n_end - anchor)
    if lit < 0:
        return bytearray(), 0
    _emit_final(out, data, anchor, anchor + lit)
    return out, anchor - start + lit


# ---------------------------------------------------------------------------
# kernel H: a batch of bounded blocks
# ---------------------------------------------------------------------------

def encode_dest_size_plain(row: bytes, wlen: int, slen: int, cap: int,
                            acceleration: int = 1, min_match: int = 4,
                            parse=_dest_size_block) -> Tuple[bytes, int]:
    """Plain version of kernel H for one row ``[prefix | source]``: the
    source ``row[wlen:wlen + slen]`` into at most ``cap`` bytes, matching
    into the ``wlen`` prefix bytes, which are seeded into a fresh table at
    every third position (LZ4_loadDict's stride).  ``parse`` runs the block
    (``dest_size_block_rounds_plain`` gives the card's rounds).  Returns
    (block, consumed)."""
    n = wlen + slen
    vals = hashes = None
    table: List[int] = []
    if slen >= 13:
        vals, hashes = _hash_table_inputs(np.frombuffer(row, np.uint8,
                                                        count=n))
        table = [-1] * HASH_SIZE
        for p in range(0, max((wlen - 4) // 3 + 1, 0) * 3, 3):
            table[hashes[p]] = p
    out, consumed = parse(
        row, vals, hashes, table, wlen, n, 0, wlen + (0 if wlen > 0 else 1),
        cap, acceleration, min_match)
    return bytes(out), consumed


def encode_blocks_dest_size(rows: torch.Tensor, src_lens: torch.Tensor,
                            capacities: torch.Tensor, acceleration: int = 1,
                            window_lens: Optional[torch.Tensor] = None,
                            min_match: int = 4):
    """destSize-compress a batch of blocks: kernel H on the card, its plain
    version on the CPU.

    Args:
      rows: [B, NS] uint8, ``[prefix | source]`` per row, zero padded; NS a
        multiple of 128, at most 256 KB.
      src_lens: [B] int32 source lengths.
      capacities: [B] int32 destination budgets in bytes (clamped to M).
      window_lens: optional [B] int32 prefix lengths: row i's source starts
        at byte ``window_lens[i]`` and may match into the bytes before it.
        Prefix and source are clamped to the row: window_lens to [0, NS],
        src_lens to [0, NS - window_lens].

    Returns (out [B, M] uint8, olen [B] int32, consumed [B] int32), M =
    128-aligned compress_bound(NS): row i is a complete LZ4 block of
    ``olen[i]`` bytes that decodes, with the prefix as its dictionary, to
    the first ``consumed[i]`` source bytes; 0/0 when not one literal fits.
    The capacity arithmetic is the JAX kernel's int32 arithmetic, so with
    65,295 literals or more in one run a block may pass its capacity as
    the JAX kernel's does; it never passes compress_bound of its source.
    """
    check(rows, "rows", torch.uint8, 2)
    B, NS = rows.shape
    if NS % 128:
        raise ValueError("NS must be a multiple of 128")
    if NS > MAX_BLOCK:
        raise ValueError(f"block too large for kernel ({NS} > {MAX_BLOCK})")
    if window_lens is None:
        window_lens = torch.zeros((B,), dtype=torch.int32,
                                  device=rows.device)
    for t, name in ((src_lens, "src_lens"), (capacities, "capacities"),
                    (window_lens, "window_lens")):
        check(t, name, torch.int32, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} must be [B]")
    M = out_width(NS)
    acceleration = max(1, int(acceleration))   # 0 would never advance
    min_match = int(min_match)
    if not use_kernel(rows, src_lens, capacities, window_lens):
        PLAIN_CALLS["encode_dest_size"] += 1
        out = torch.zeros((B, M), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        blocks, consumed = [], []
        for b, (slen, cap, wlen) in enumerate(zip(
                src_lens.tolist(), capacities.tolist(),
                window_lens.tolist())):
            wlen = min(max(wlen, 0), NS)
            block, cons = encode_dest_size_plain(
                rows[b].numpy().tobytes(), wlen,
                min(max(slen, 0), NS - wlen), min(cap, M), acceleration,
                min_match)
            blocks.append(bytearray(block))
            consumed.append(cons)
        _fill_rows(out, olen, blocks)
        return out, olen, torch.tensor(consumed, dtype=torch.int32)
    dev = rows.device
    out = torch.empty((B, M), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    consumed = torch.empty((B,), dtype=torch.int32, device=dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_encode_dest_size(
            rows.data_ptr(), NS, src_lens.data_ptr(), capacities.data_ptr(),
            window_lens.data_ptr(), acceleration, min_match, out.data_ptr(), M,
            olen.data_ptr(), consumed.data_ptr(), B,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("encode_dest_size", err)
    LAUNCHES["encode_dest_size"] += 1
    return out, olen, consumed


# ---------------------------------------------------------------------------
# kernel G: the scatter-gather chain
# ---------------------------------------------------------------------------

def sg_chain_statics(total: int, n_in: int, n_out: int) -> Tuple[int, int]:
    """(steps T, block width M) of one walk: T bounds the walk's length, M
    is compress_bound(64 KB) rounded up to 128, the most a step writes."""
    T = n_in + n_out + total // CHAIN_BLOCK + 4
    M = -(-spec.compress_bound(CHAIN_BLOCK) // 128) * 128
    return T, M


def sg_chain_input(in_bufs: Sequence[bytes], device) -> Tuple[torch.Tensor,
                                                               np.ndarray]:
    """The chain encoder's input for one list: ``concat(in_bufs)`` and TAIL
    zero bytes as one uint8 tensor on ``device``, and the cumulative input
    buffer ends (int32 [n_in + 1], ``in_ends[0] == 0``)."""
    in_ends = np.zeros(len(in_bufs) + 1, np.int64)
    np.cumsum([len(b) for b in in_bufs], out=in_ends[1:])
    flat = np.zeros(int(in_ends[-1]) + TAIL, np.uint8)
    flat[:int(in_ends[-1])] = np.frombuffer(b"".join(in_bufs), np.uint8)
    return to_device(flat, device), in_ends.astype(np.int32)


def sg_encode_chain_plain(data: bytes, in_ends: Sequence[int],
                          caps: Sequence[int], max_dest: int,
                          acceleration: int = 1, min_match: int = 4,
                          parse=_dest_size_block):
    """Plain version of kernel G: the JAX kernel's walk, step for step.

    ``data`` holds the content (``in_ends[-1]`` bytes) and at least TAIL
    more; ``parse`` runs each step's block (``dest_size_block_rounds_plain``
    gives the card's rounds).  Returns (blocks, boff, blen, consumed, isz,
    osz): ``blocks`` holds step t's block at ``boff[t]``, ``blen[t]`` bytes
    long; steps after the walk has ended report blen -1 and 0 in the other
    fields.
    """
    total = in_ends[-1]
    n_in, n_out = len(in_ends) - 1, len(caps)
    T, M = sg_chain_statics(total, n_in, n_out)
    vals, hashes = _hash_table_inputs(np.frombuffer(data, np.uint8))
    table = [-1] * HASH_SIZE
    blocks = bytearray()
    boff: List[int] = []
    blen: List[int] = []
    cons: List[int] = []
    isz: List[int] = []
    osz: List[int] = []
    ipos = ibuf = oidx = 0
    opos = ototal = SG_HEADER
    done = False
    for _ in range(T):
        boff.append(len(blocks))
        if done or ipos >= total or ototal + BH >= max_dest:
            done = True
            blen.append(-1)
            cons.append(0)
            isz.append(0)
            osz.append(0)
            continue
        # reserve the block header
        opos_h, ototal_h = opos + BH, ototal + BH
        i_size = min(in_ends[ibuf + 1] - ipos, total - ipos)
        i_take = min(i_size, CHAIN_BLOCK)
        o_size = min(caps[oidx] - opos_h, max_dest - ototal_h)
        cap = min(o_size, M)
        # matches reach back to the start of the previous input buffer
        low = max(ipos - 65535, in_ends[ibuf - 1] if ibuf > 0 else 0, 0)
        out, consumed = parse(
            data, vals, hashes, table, ipos, ipos + i_take, low,
            ipos + (1 if ipos == 0 else 0), cap, acceleration, min_match)
        o_written = len(out)
        blocks += out
        blen.append(o_written)
        cons.append(consumed)
        isz.append(i_size)
        osz.append(o_size)
        # walk state update (sg.sg_compress's input and output advance)
        no_progress = consumed == 0 or o_written == 0
        ipos += consumed
        in_done = consumed == i_size
        ibuf2 = ibuf + 1 if in_done else ibuf
        input_exhausted = in_done and ibuf2 >= n_in
        adv_out = o_written + 1 + BH >= o_size
        oidx2 = oidx + 1 if adv_out else oidx
        out_exhausted = adv_out and oidx2 >= n_out
        zero_pad = (adv_out and o_written != o_size
                    and ototal_h + o_written + BH < max_dest)
        if adv_out:
            opos = 1 + BH - (o_size - o_written) if zero_pad else 0
        else:
            opos = opos_h + o_written
        ototal = ototal_h + o_written + (1 + BH if zero_pad else 0)
        ibuf = min(ibuf2, n_in)
        oidx = min(oidx2, n_out - 1)
        done = no_progress or input_exhausted or out_exhausted
    return bytes(blocks), boff, blen, cons, isz, osz


def _ints(values, name: str) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    arr = np.asarray(values, dtype=np.int64).reshape(-1)
    if arr.size and (arr.min() < -(1 << 31) or arr.max() >= 1 << 31):
        raise ValueError(f"{name} must fit int32")
    return arr


def _chain_args(in_ends, out_caps, max_dest: int, width: int):
    """Validate a walk's arguments for content rows of ``width`` bytes:
    returns (in_ends, caps as int64 numpy, total, T, M, max_dest)."""
    in_ends = _ints(in_ends, "in_ends")
    caps = _ints(out_caps, "out_caps")
    if len(in_ends) < 2 or in_ends[0] != 0 or (np.diff(in_ends) < 0).any():
        raise ValueError("in_ends must start at 0 and not decrease")
    if not len(caps):
        raise ValueError("out_caps must not be empty")
    total = int(in_ends[-1])
    if not 0 < total <= MAX_TOTAL:
        raise ChainEnvelopeError(
            f"sg_encode_chain takes 1..{MAX_TOTAL} bytes, not {total}")
    if width < total + TAIL:
        raise ValueError(f"flat must hold the content and {TAIL} more bytes")
    T, M = sg_chain_statics(total, len(in_ends) - 1, len(caps))
    max_dest = int(max_dest)
    if not 0 <= max_dest < (1 << 31) - 2 * M:
        raise ValueError("max_dest must fit int32")
    return in_ends, caps, total, T, M, max_dest


def sg_encode_chain(flat: torch.Tensor, in_ends, out_caps, max_dest: int,
                    acceleration: int = 1, min_match: int = 4):
    """Run the SG compression walk: kernel G on the card, its plain version
    on the CPU.

    Args:
      flat: [L] uint8, ``concat(in_bufs)`` followed by at least TAIL bytes
        (``sg_chain_input`` builds it).
      in_ends: cumulative input buffer ends, [n_in + 1], in_ends[0] == 0.
      out_caps: [n_out] output buffer capacities.
      max_dest: the total output budget.

    Returns (blocks [>= max(boff + blen)] uint8, boff [T] int64, blen,
    consumed, isz, osz [T] int32), all on ``flat``'s device: step t's block
    is ``blocks[boff[t]:boff[t] + blen[t]]``; steps with blen < 0 come
    after the end of the walk.  Raises ChainEnvelopeError when the content
    is empty or longer than MAX_TOTAL bytes.
    """
    check(flat, "flat", torch.uint8, 1)
    in_ends, caps, total, T, M, max_dest = _chain_args(
        in_ends, out_caps, max_dest, flat.shape[0])
    acceleration, min_match = int(acceleration), int(min_match)
    if not use_kernel(flat):
        PLAIN_CALLS["sg_encode_chain"] += 1
        data = flat[:total + TAIL].numpy().tobytes()
        blocks, *recs = sg_encode_chain_plain(
            data, in_ends.tolist(), caps.tolist(), max_dest, acceleration,
            min_match)
        return (to_device(blocks, "cpu"),
                torch.tensor(recs[0], dtype=torch.int64),
                *(torch.tensor(r, dtype=torch.int32) for r in recs[1:]))
    dev = flat.device
    ends_d = torch.from_numpy(in_ends.astype(np.int32)).to(dev)
    caps_d = torch.from_numpy(caps.astype(np.int32)).to(dev)
    blocks = torch.empty((min(max_dest, T * M) + 2 * M,), dtype=torch.uint8,
                         device=dev)
    boff = torch.empty((T,), dtype=torch.int64, device=dev)
    recs = torch.empty((4, T), dtype=torch.int32, device=dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_sg_encode_chain(
            flat.data_ptr(), ends_d.data_ptr(), len(in_ends) - 1,
            caps_d.data_ptr(), len(caps), total, max_dest, T, M,
            acceleration, min_match, blocks.data_ptr(), boff.data_ptr(),
            recs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sg_encode_chain", err)
    LAUNCHES["sg_encode_chain"] += 1
    return (blocks, boff, *recs.unbind(0))


def sg_encode_chain_batch(flat_rows: torch.Tensor, in_ends, out_caps,
                          max_dest: int, acceleration: int = 1,
                          min_match: int = 4):
    """Run the SG compression walks of L lists of one layout at once: kernel
    G with a list axis on the card (one CTA per list), a loop of
    ``sg_encode_chain_plain`` on the CPU.

    Args:
      flat_rows: [L, W] uint8; row l is list l's ``concat(in_bufs)``
        followed by at least TAIL bytes.
      in_ends, out_caps, max_dest: the layout every list shares, as for
        ``sg_encode_chain``.

    Returns (blocks [L, BW] uint8, boff [L, T] int64, blen, consumed, isz,
    osz [L, T] int32), on ``flat_rows``' device: row l equals what
    ``sg_encode_chain`` returns for list l.
    """
    check(flat_rows, "flat_rows", torch.uint8, 2)
    L, width = flat_rows.shape
    in_ends, caps, total, T, M, max_dest = _chain_args(
        in_ends, out_caps, max_dest, width)
    acceleration, min_match = int(acceleration), int(min_match)
    BW = min(max_dest, T * M) + 2 * M
    if not use_kernel(flat_rows):
        PLAIN_CALLS["sg_encode_chain_batch"] += 1
        blocks = torch.zeros((L, BW), dtype=torch.uint8)
        boff = torch.zeros((L, T), dtype=torch.int64)
        recs = torch.zeros((4, L, T), dtype=torch.int32)
        for i in range(L):
            b, off, *rest = sg_encode_chain_plain(
                flat_rows[i, :total + TAIL].numpy().tobytes(),
                in_ends.tolist(), caps.tolist(), max_dest, acceleration,
                min_match)
            blocks[i, :len(b)] = torch.from_numpy(
                np.frombuffer(b, np.uint8).copy())
            boff[i] = torch.tensor(off, dtype=torch.int64)
            recs[:, i] = torch.tensor(rest, dtype=torch.int32)
        return (blocks, boff, *recs.unbind(0))
    dev = flat_rows.device
    ends_d = torch.from_numpy(in_ends.astype(np.int32)).to(dev)
    caps_d = torch.from_numpy(caps.astype(np.int32)).to(dev)
    blocks = torch.empty((L, BW), dtype=torch.uint8, device=dev)
    boff = torch.empty((L, T), dtype=torch.int64, device=dev)
    recs = torch.empty((L, 4, T), dtype=torch.int32, device=dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_sg_encode_chain_batch(
            flat_rows.data_ptr(), width, L, ends_d.data_ptr(),
            len(in_ends) - 1, caps_d.data_ptr(), len(caps), total, max_dest,
            T, M, acceleration, min_match, blocks.data_ptr(), BW,
            boff.data_ptr(), recs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sg_encode_chain_batch", err)
    LAUNCHES["sg_encode_chain_batch"] += 1
    return (blocks, boff, *recs.unbind(1))
