"""The scatter-gather chain encoder: kernel G.

Counterpart of ``lz4_tpu/kernels/destsize_kernel.py`` ``sg_encode_chain``
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
bytes, lengths and consumed counts are bit-identical to ``lz4_tpu``'s.  The
capacity arithmetic is its int32 arithmetic, wrap-around included.

``sg_encode_chain`` launches ``csrc/sg_chain.cu`` for tensors on the card
and runs ``sg_encode_chain_plain`` for tensors on the CPU.  Unlike the TPU
kernel, which wrote every step into its own ``[T, M]`` row, both write the
steps' blocks one after another into one flat buffer at ``boff``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import spec
from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, to_device, use_kernel

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


def _i32(x: int) -> int:
    """x wrapped to a signed 32-bit integer (the TPU kernel's int32)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _div255(y: int) -> int:
    """The JAX kernel's y // 255 by a magic multiply, in int32: exact for
    0 <= y < 65280, where y * 32897 still fits."""
    q0 = _i32(y * 32897) >> 23
    r = y - q0 * 255
    return q0 - (1 if r < 0 else 0)


def _ext_bytes(x: int) -> int:
    """Length-extension byte count for a nibble value x (0 when < 15)."""
    return 0 if x < 15 else 1 + _div255(x - 15)


def _seq_size(litlen: int, mlc: int) -> int:
    """Encoded size of one sequence."""
    return 1 + litlen + 2 + _ext_bytes(litlen) + _ext_bytes(mlc)


def _final_run_size(litlen: int) -> int:
    return 1 + litlen + _ext_bytes(litlen)


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


# ---------------------------------------------------------------------------
# plain version (CPU tensors)
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


def _emit_ext(out: bytearray, extra: int) -> None:
    while extra >= 255:
        out.append(255)
        extra -= 255
    out.append(extra)


def _common_run(data: bytes, a: int, b: int, room: int) -> int:
    """Length of the common prefix of data[a:] and data[b:], at most
    ``room``."""
    k = 0
    for step in (256, 16):
        while k + step <= room and data[a + k:a + k + step] == \
                data[b + k:b + k + step]:
            k += step
    while k < room and data[a + k] == data[b + k]:
        k += 1
    return k


def sg_encode_chain_plain(data: bytes, in_ends: Sequence[int],
                          caps: Sequence[int], max_dest: int,
                          acceleration: int = 1, min_match: int = 4):
    """Plain version of kernel G: the JAX kernel's walk, step for step.

    ``data`` holds the content (``in_ends[-1]`` bytes) and at least TAIL
    more.  Returns (blocks, boff, blen, consumed, isz, osz): ``blocks``
    holds step t's block at ``boff[t]``, ``blen[t]`` bytes long; steps after
    the walk has ended report blen -1 and 0 in the other fields.

    The forward extension compares byte runs instead of the kernel's
    4-byte words and XOR tail; both give min(common run, matchlimit - mp).
    """
    total = in_ends[-1]
    n_in, n_out = len(in_ends) - 1, len(caps)
    T, M = sg_chain_statics(total, n_in, n_out)
    vals, hashes = _hash_table_inputs(np.frombuffer(data, np.uint8))
    table = [-1] * HASH_SIZE
    accel0 = acceleration << SKIP_TRIGGER
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
        start, n_end = ipos, ipos + i_take
        mflimit, matchlimit = n_end - 12, n_end - 5
        # matches reach back to the start of the previous input buffer
        low = max(ipos - 65535, in_ends[ibuf - 1] if ibuf > 0 else 0, 0)
        out = bytearray()
        ip = start + (1 if start == 0 else 0)
        anchor, scnt = start, accel0
        while i_take >= 13 and ip <= mflimit:
            h = hashes[ip]
            e = table[h]
            table[h] = ip
            # a capacity-stopped step may have left entries at or past ip
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
            mlc = ml - 4
            out.append((min(litlen, 15) << 4) | min(mlc, 15))
            if litlen >= 15:
                _emit_ext(out, litlen - 15)
            out += data[anchor:mp]
            offset = ip - e
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if mlc >= 15:
                _emit_ext(out, mlc - 15)
            ip = anchor = mp + ml
            table[hashes[ip - 2]] = ip - 2
            scnt = accel0
        lit = _max_final_literals(cap - len(out), n_end - anchor)
        if lit >= 0:
            out.append(min(lit, 15) << 4)
            if lit >= 15:
                _emit_ext(out, lit - 15)
            out += data[anchor:anchor + lit]
            o_written, consumed = len(out), anchor - start + lit
            blocks += out
        else:
            o_written = consumed = 0
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


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _ints(values, name: str) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    arr = np.asarray(values, dtype=np.int64).reshape(-1)
    if arr.size and (arr.min() < -(1 << 31) or arr.max() >= 1 << 31):
        raise ValueError(f"{name} must fit int32")
    return arr


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
    if flat.shape[0] < total + TAIL:
        raise ValueError(f"flat must hold the content and {TAIL} more bytes")
    T, M = sg_chain_statics(total, len(in_ends) - 1, len(caps))
    max_dest = int(max_dest)
    if not 0 <= max_dest < (1 << 31) - 2 * M:
        raise ValueError("max_dest must fit int32")
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
    err = build.kernels_lib().lz4tt_sg_encode_chain(
        flat.data_ptr(), ends_d.data_ptr(), len(in_ends) - 1,
        caps_d.data_ptr(), len(caps), total, max_dest, T, M, acceleration,
        min_match, blocks.data_ptr(), boff.data_ptr(), recs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("sg_encode_chain", err)
    LAUNCHES["sg_encode_chain"] += 1
    return (blocks, boff, *recs.unbind(0))
