"""Safe LZ4 block decoders: kernel D, in two modes, the stream decoder
(kernel E) and the scatter-gather chain decoder (kernel F).

Counterpart of ``lz4_tpu/kernels/decode_kernel.py`` (``_make_decode_kernel``
in modes ``linked``, ``batch`` and ``sg``, with dictionary rows and the
``resumable`` variant of batch mode, and ``_make_stream_decode_kernel``).
The block semantics are those of the JAX kernels' general path:

* a sequence's literal run must lie inside the block (``clen``); a run that
  ends exactly at ``clen`` ends the block;
* otherwise the match offset must be in ``(0, opos + plen]``, where ``plen``
  is the window length, and the output must fit ``min(cap, N)``;
* anything else, or input that ends after a match, gives length -1.

``decode_blocks_linked`` decodes one chain with the serial semantics:
block b's window is block b-1's output when that block decoded to exactly
``block_size`` bytes, and empty otherwise; block 0 may take an initial
window.  The kernels decode every block of a linked chain at once and
work the statuses out from per-block summaries; ``parse_block_plain``,
``linked_statuses_plain`` and ``stream_statuses_plain`` model those steps
for the tests, while the wrappers' plain versions stay the serial walks.
Likewise ``decode_stream_spans_plain`` models kernel E's independent mode
on the card (a parallel parse of every block, spans decoded into cells)
and ``decode_blocks_sg_cells_plain`` kernel F's (every block at once into
cells), and ``decode_rows_spans_plain`` kernel D's batch and resumable
modes (a token walk per row, spans of sequences into cells).
``decode_blocks`` decodes independent rows, each with an optional
dictionary; ``decode_blocks_dest_size`` is its resumable (destSize) variant:
a row that runs out of room stops at a token boundary and reports the bytes
produced and the source bytes consumed.  ``decode_stream_raw`` (and
``decode_stream`` over a list of payloads) decodes one frame's chain of any
block size into one flat output (see ``decode_stream_plain``).
``decode_blocks_sg_raw`` (and ``decode_blocks_sg`` over [B, M] rows) decodes
an SG frame's blocks into one continuous output at fixed offsets (see
``decode_blocks_sg_plain``).

Each wrapper launches ``csrc/decode.cu`` (D), ``csrc/stream.cu`` (E) or
``csrc/sg_decode.cu`` (F) for tensors on the card and runs the plain Python
decoder below for tensors on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .common import (LAUNCHES, PLAIN_CALLS, check, ints_to_device,
                     on_device, to_device, use_kernel)

ERR_MALFORMED = -1
MAX_OFFSET = 65535                # the largest LZ4 match offset
STREAM_UNIT = 65536               # stream block sizes are multiples of this
STREAM_BLOCK_CAP = 1 << 23        # no stream block decodes past 8 MB
# csrc/stream.cu holds byte offsets and lengths into the input as int32
# (output offsets are int64), so the input is at most this long
STREAM_MAX_INPUT = (1 << 31) - 1
# flags of the pointer-jumping rounds that follow a linked decode into
# cells (MAX_JUMP_ROUNDS in csrc/decode.cuh)
JUMP_ROUND_FLAGS = 32
# The most output bytes a decode into int32 cells on the card (linked D and
# E, independent E, F) holds at once: a longer chain is decoded in windows
# of blocks, one after another.  This bounds the cells' scratch to 1 GiB
# and every reference in them to this plus two blocks, far inside int32.
CELL_WINDOW = 1 << 28
# Kernel E's independent mode parses a block's payload in parallel
# (csrc/stream.cu): 17 bytes of scratch per payload byte, for the payloads
# of at most this many bytes at once (or one block), about 1.1 GiB.
PARSE_WINDOW = 1 << 26
# Its spans: one warp decodes 2^SPAN_LOG sequences of a block, and the
# walk that places the spans takes one step per span.
SPAN_LOG = 8
# Kernel D's batch rows are decoded in spans of 2^ROW_SPAN_LOG sequences
# (csrc/decode.cu): on the H100, 64 rows of 64 KB took 0.83 ms at 7
# against 0.89-0.97 at 8 and 0.78-0.79 at 6, 1,024 rows 2.30 against
# 2.32-2.37 and 2.42-2.49 (more references for the rounds at 6; PERF.md).
ROW_SPAN_LOG = 7
# next(p) of the parallel parse: p's sequence ends the block, or fails
SEQ_END, SEQ_FAIL = -1, -2


class StreamEnvelopeError(ValueError):
    """The input is too long for kernel E's int32 byte offsets."""


def _read_ext(src: bytes, ip: int, n: int):
    """Length-extension bytes at ``ip``: (sum, next ip, ok)."""
    extra = 0
    while True:
        if ip >= n:
            return extra, ip, False
        b = src[ip]
        ip += 1
        extra += b
        if b != 255:
            return extra, ip, True


def _decode_sequences(src: bytes, n: int, olim: int, window: bytes):
    """The sequence loop of the plain decoders.  Returns (status, ip, out,
    need): status as in the JAX kernel (0 the source ran out at a token
    boundary, 1 ended with a literal run, 2 malformed, 3 no room), ``ip``
    the offset of the token where the loop stopped, ``out`` the bytes
    produced, ``need`` how far the matches started reached before the
    output's start (0 if none).  Every sequence is parsed and validated
    whole before it is held against the room, and one that fails either
    check is not started."""
    out = bytearray()
    plen = len(window)
    ip, status, need = 0, 0, 0
    while status == 0 and ip < n:
        ip0 = ip
        token = src[ip]
        litlen, ok_lit, ip = token >> 4, True, ip + 1
        if litlen == 15:
            ext, ip, ok_lit = _read_ext(src, ip, n)
            litlen += ext
        opos = len(out)
        ip_after = ip + litlen
        v_lit = ok_lit and ip_after <= n
        ended = v_lit and ip_after == n
        r_lit = opos + litlen <= olim
        ok_m0 = v_lit and ip_after + 2 <= n
        v_m, mlen, offset, ip_m = False, 0, 0, ip_after + 2
        if ok_m0:
            offset = src[ip_after] | (src[ip_after + 1] << 8)
            mlen = (token & 15) + 4
            ok_ext = True
            if token & 15 == 15:
                ext, ip_m, ok_ext = _read_ext(src, ip_m, n)
                mlen += ext
            v_m = ok_ext and 0 < offset <= opos + litlen + plen
        valid = v_lit and (ended or v_m)
        room = r_lit and (ended or opos + litlen + mlen <= olim)
        if not (valid and room):
            return (3 if valid else 2), ip0, out, need
        out += src[ip:ip_after]
        if ended:
            return 1, ip0, out, need
        start = len(out) - offset
        need = max(need, -start)
        if start >= 0 and offset >= mlen:
            out += out[start:start + mlen]
        else:
            for i in range(mlen):
                p = start + i
                out.append(window[plen + p] if p < 0 else out[p])
        ip = ip_m
    return 0, ip, out, need


def decode_block_plain(src: bytes, n: int, olim: int, window: bytes = b""):
    """Decode one block of ``n`` bytes into at most ``olim`` bytes, with
    ``window`` (the bytes right before the output) as match history.
    Returns (olen, output bytes); olen is -1 for a malformed block, and for
    one that does not fit or does not end with a literal run."""
    status, _, out, _ = _decode_sequences(src, n, olim, window)
    return (len(out) if status == 1 else ERR_MALFORMED), bytes(out)


def decode_block_resumable_plain(src: bytes, n: int, olim: int,
                                 window: bytes = b""):
    """The destSize decode of one block: (olen, cons, output bytes).  A
    sequence that does not fit ``olim`` stops the block at its token: olen
    is what was produced and cons the token's offset.  A block that ends,
    with its terminal literal run or exactly after a match, reports
    cons == n; a malformed one olen = cons = -1."""
    status, ip, out, _ = _decode_sequences(src, n, olim, window)
    if status == 2:
        return ERR_MALFORMED, ERR_MALFORMED, bytes(out)
    return len(out), (n if status == 1 else ip), bytes(out)


def parse_block_plain(src: bytes, n: int, cap: int, plen: int = MAX_OFFSET):
    """The summary the linked kernels make of one block decoded with a
    window of ``plen`` bytes assumed present: (length or -1, need, reach).
    ``need`` is how far its matches reach before its start (0 if none, and
    0 for a block that does not decode), ``reach`` whether any does.  With
    the default ``plen`` no offset check fails but offset 0: kernel E's
    parse (its step A); with ``plen = N`` it is kernel D's cell decode.
    Used by the tests."""
    status, _, out, need = _decode_sequences(src, n, cap, bytes(plen))
    if status != 1:
        return ERR_MALFORMED, 0, False
    return len(out), need, need > 0


def linked_statuses_plain(parsed: Sequence[Tuple[int, int, bool]],
                          block_size: int) -> List[int]:
    """Kernel D's linked statuses (its step 3) from each block's summary
    with its window assumed present (``parse_block_plain`` with ``plen =
    block_size``; block 0 with its own window): block b > 0 fails where it
    reaches back and block b-1's final length is not ``block_size``.
    Equals ``decode_blocks_linked``'s olen.  Used by the tests."""
    olen: List[int] = []
    for b, (r, _, reach) in enumerate(parsed):
        olen.append(ERR_MALFORMED if b and reach and
                    olen[b - 1] != block_size else r)
    return olen


def stream_statuses_plain(parsed: Sequence[Tuple[int, int, bool]]
                          ) -> Tuple[List[int], List[int]]:
    """Kernel E's linked statuses and positions (its step B) from each
    block's ``parse_block_plain`` summary (a stored block: (n or -1, 0,
    False)): block b starts at base_b and fails where it needs more than
    min(base_b, 65535) bytes before it.  Returns (olen, bases); olen equals
    ``decode_stream_raw``'s in linked mode.  Used by the tests."""
    olen: List[int] = []
    bases: List[int] = []
    base = 0
    for r, need, _ in parsed:
        r = r if r >= 0 and need <= min(base, MAX_OFFSET) else ERR_MALFORMED
        olen.append(r)
        bases.append(base)
        base += max(r, 0)
    return olen, bases


def _ptr(t: Optional[torch.Tensor]):
    """The device address of an optional tensor argument (None: null)."""
    return None if t is None else t.data_ptr()


def _check_comp(comp: torch.Tensor, comp_lens: torch.Tensor) -> None:
    check(comp, "comp", torch.uint8, 2)
    check(comp_lens, "comp_lens", torch.int32, 1)
    if comp_lens.shape[0] != comp.shape[0]:
        raise ValueError("comp_lens must be [B]")


def decode_blocks_linked(comp: torch.Tensor, comp_lens: torch.Tensor,
                         block_size: int,
                         init_window: Optional[torch.Tensor] = None,
                         init_window_len: int = 0):
    """Decode a chain of linked LZ4 blocks (one stream, in order).

    Args:
      comp: [B, M] uint8 block payloads in stream order, zero padded.
      comp_lens: [B] int32 payload lengths (clamped to [0, M]).
      block_size: the frame's block size; every block but the last must
        decode to exactly this many bytes for its successor to see a window.
      init_window: optional [block_size] uint8 window of block 0, content
        right-aligned (e.g. the previous group's last block, on the device).
      init_window_len: its byte length (<= block_size).

    Returns (out [B, block_size] uint8, olen [B] int32; -1 = malformed).
    Bytes of a -1 row and past ``olen`` are not part of the result.  On the
    card the blocks decode at once into int32 cells, in windows of
    ``CELL_WINDOW // block_size`` blocks, so the call takes ``4 *
    min(B * block_size, CELL_WINDOW)`` bytes of scratch (16 MB for 64
    blocks of 64 KB).  ``block_size`` is at most 8 MB, as in kernel E.
    """
    _check_comp(comp, comp_lens)
    B, M = comp.shape
    N = int(block_size)
    if not 0 < N <= STREAM_BLOCK_CAP:
        raise ValueError("block_size must be in (0, 8 MB]")
    dev = comp.device
    if init_window is None or not init_window_len:
        init_window = torch.zeros((N,), dtype=torch.uint8, device=dev)
        init_window_len = 0
    init_window = init_window.reshape(-1)
    check(init_window, "init_window", torch.uint8, 1)
    if init_window.shape[0] != N or not 0 <= init_window_len <= N:
        raise ValueError("init_window must be [block_size] with "
                         "0 <= init_window_len <= block_size")
    if not use_kernel(comp, comp_lens, init_window):
        PLAIN_CALLS["decode_linked"] += 1
        out = torch.zeros((B, N), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        window = init_window.numpy().tobytes()[N - init_window_len:]
        prev = None
        for b, n in enumerate(comp_lens.tolist()):
            if b > 0:
                window = prev if olen[b - 1] == N else b""
            olen[b], prev = decode_block_plain(
                comp[b].numpy().tobytes(), min(max(n, 0), M), N, window)
            if prev:
                out[b, :len(prev)] = torch.frombuffer(bytearray(prev),
                                                      dtype=torch.uint8)
        return out, olen
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    W = min(B, max(CELL_WINDOW // N, 1))
    cells = torch.empty((W, N), dtype=torch.int32, device=dev)
    far = torch.empty((B + JUMP_ROUND_FLAGS,), dtype=torch.int32,
                      device=dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_decode_linked(
            comp.data_ptr(), M, comp_lens.data_ptr(), init_window.data_ptr(),
            int(init_window_len), out.data_ptr(), N, olen.data_ptr(), B,
            cells.data_ptr(), W, far.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_linked", err)
    LAUNCHES["decode_linked"] += 1
    return out, olen


def _dict_args(B: int, dict_rows, dict_lens):
    """Validate optional dictionary rows: ([B, P] uint8 or None, [B] int32
    or None, P)."""
    if dict_rows is None:
        if dict_lens is not None:
            raise ValueError("dict_lens without dict_rows")
        return None, None, 0
    if dict_lens is None:
        raise ValueError("dict_rows need dict_lens")
    check(dict_rows, "dict_rows", torch.uint8, 2)
    check(dict_lens, "dict_lens", torch.int32, 1)
    if dict_rows.shape[0] != B or dict_lens.shape[0] != B:
        raise ValueError("dict_rows must be [B, P] and dict_lens [B]")
    return dict_rows, dict_lens, dict_rows.shape[1]


def _decode_batch(name: str, comp, comp_lens, N: int, out_caps, dict_rows,
                  dict_lens, resumable: bool):
    """Kernel D in batch mode (``csrc/decode.cu``) or its plain version:
    (out [B, N], olen [B], cons [B] or None).  On the card each row's
    token walk sets its status and places spans of 2^ROW_SPAN_LOG
    sequences, which decode into int32 cells, W = CELL_WINDOW // N rows
    at a time (4 * min(B * N, CELL_WINDOW) bytes of scratch: 256 MiB for
    1,024 rows of 64 KB); ``decode_rows_spans_plain`` models it."""
    _check_comp(comp, comp_lens)
    B, M = comp.shape
    check(out_caps, "out_caps", torch.int32, 1)
    if out_caps.shape[0] != B:
        raise ValueError("out_caps must be [B]")
    dict_rows, dict_lens, P = _dict_args(B, dict_rows, dict_lens)
    dicts = () if dict_rows is None else (dict_rows, dict_lens)
    if not use_kernel(comp, comp_lens, out_caps, *dicts):
        PLAIN_CALLS[name] += 1
        out = torch.zeros((B, N), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        cons = torch.zeros((B,), dtype=torch.int32) if resumable else None
        plens = dict_lens.tolist() if dicts else [0] * B
        for b, (n, cap) in enumerate(zip(comp_lens.tolist(),
                                         out_caps.tolist())):
            plen = min(max(plens[b], 0), P)
            window = dict_rows[b, P - plen:].numpy().tobytes() if plen \
                else b""
            args = (comp[b].numpy().tobytes(), min(max(n, 0), M),
                    min(cap, N), window)
            if resumable:
                olen[b], cons[b], dec = decode_block_resumable_plain(*args)
            else:
                olen[b], dec = decode_block_plain(*args)
            if dec:
                out[b, :len(dec)] = torch.frombuffer(bytearray(dec),
                                                     dtype=torch.uint8)
        return out, olen, cons
    dev = comp.device
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    cons = torch.empty((B,), dtype=torch.int32, device=dev) if resumable \
        else None
    stride = span_slots(M, ROW_SPAN_LOG)
    W = min(B, max(CELL_WINDOW // max(N, 1), 1))
    slots = torch.empty((2 * B * stride,), dtype=torch.int32, device=dev)
    nspans = torch.empty((B,), dtype=torch.int32, device=dev)
    cells = torch.empty((max(W * N, 1),), dtype=torch.int32, device=dev)
    more = torch.zeros((-(-B // max(W, 1)) * JUMP_ROUND_FLAGS,),
                       dtype=torch.int32, device=dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_decode_batch(
            comp.data_ptr(), M, comp_lens.data_ptr(), out_caps.data_ptr(),
            _ptr(dict_rows), P, _ptr(dict_lens), out.data_ptr(), N,
            olen.data_ptr(), _ptr(cons), B, ROW_SPAN_LOG, stride,
            slots.data_ptr(), nspans.data_ptr(), cells.data_ptr(), W,
            more.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(name, err)
    LAUNCHES[name] += 1
    return out, olen, cons


def decode_blocks(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int,
                  out_caps: Optional[torch.Tensor] = None,
                  dict_rows: Optional[torch.Tensor] = None,
                  dict_lens: Optional[torch.Tensor] = None):
    """Decode a batch of independent (or dictionary-prefixed) LZ4 blocks.

    Args:
      comp: [B, M] uint8 payloads, zero padded.
      comp_lens: [B] int32 lengths (clamped to [0, M]).
      out_cap: decoded capacity of every row.
      out_caps: optional [B] int32 exact capacity per row (<= out_cap);
        decoding past it reports -1, like LZ4_decompress_safe.
      dict_rows: optional [B, P] uint8 dictionaries, right-aligned: row i's
        lies in lanes [P - dict_lens[i], P) and is the history right before
        row i's output.
      dict_lens: [B] int32 dictionary lengths (clamped to [0, P]).

    Returns (out [B, out_cap] uint8, olen [B] int32; -1 = malformed).
    """
    N = int(out_cap)
    if out_caps is None:
        out_caps = torch.full((comp.shape[0],), N, dtype=torch.int32,
                              device=comp.device)
    out, olen, _ = _decode_batch("decode_batch", comp, comp_lens, N,
                                 out_caps, dict_rows, dict_lens, False)
    return out, olen


def decode_blocks_dest_size(comp: torch.Tensor, comp_lens: torch.Tensor,
                            out_caps: torch.Tensor, out_cap_max: int,
                            dict_rows: Optional[torch.Tensor] = None,
                            dict_lens: Optional[torch.Tensor] = None):
    """Resumable destSize decode of a batch: row i fills at most
    ``min(out_caps[i], out_cap_max)`` bytes and stops at a token boundary.

    Arguments as for ``decode_blocks``.  Returns (out [B, out_cap_max]
    uint8, olen [B] int32, cons [B] int32):

    * olen >= 0, cons == comp_lens[i]: the source was consumed to its end
      at a token boundary.  Usually the block is decoded in full; a block
      that ends exactly after a match (no terminal literal run) lands here
      too, so a caller checks olen against the size it expects.
    * olen >= 0, cons < comp_lens[i]: a clean stop for want of room.  Resume
      by feeding ``comp[i, cons:]`` with the bytes produced so far (their
      last 64 KB) as the dictionary row.
    * olen == cons == -1: corrupt input.  A source that ends in the middle
      of a sequence counts as corrupt.

    Unlike the JAX function, which rounds ``out_cap_max`` up to a multiple
    of 128 before clamping the caps, a row never produces more than
    ``out_cap_max`` bytes here.
    """
    return _decode_batch("decode_dest_size", comp, comp_lens,
                         int(out_cap_max), out_caps, dict_rows, dict_lens,
                         True)


# ---------------------------------------------------------------------------
# kernel E: the stream decoder
# ---------------------------------------------------------------------------

def decode_stream_plain(flat: bytes, bstart: Sequence[int],
                        clen: Sequence[int], stored: Sequence[int],
                        caps: Sequence[int], linked: bool
                        ) -> Tuple[bytes, List[int]]:
    """Plain version of kernel E, with the semantics of the TPU kernel
    ``_make_stream_decode_kernel``: blocks decode in order into one flat
    output; block b (``clen[b]`` bytes at ``flat[bstart[b]:]``) starts where
    the previous good block ended and may decode to at most ``caps[b]``
    bytes; in linked mode its window is everything decoded so far, in
    independent mode it has none; a stored block is a straight copy when it
    fits its cap; a failed block reports -1 and does not move the position.
    Returns (the good blocks' bytes, olen per block)."""
    out = bytearray()
    olen = []
    for s, n, st, cap in zip(bstart, clen, stored, caps):
        src = flat[s:s + n]
        if st:
            r, dec = (n, src) if n <= cap else (ERR_MALFORMED, b"")
        else:
            window = bytes(out[-MAX_OFFSET:]) if linked else b""
            r, dec = decode_block_plain(src, n, cap, window)
        olen.append(r)
        if r > 0:
            out += dec
    return bytes(out), olen


def cell_windows(caps: np.ndarray, limit: int, first: int = 1
                 ) -> np.ndarray:
    """The windows in which kernel E decodes a linked chain into cells:
    block indices ``w`` (int32, ``w[0] = 0``, ``w[-1] = B``) such that
    blocks ``[w[i], w[i + 1])`` other than block 0 have caps summing to at
    most ``limit``, or are one block.  Block 0 decodes straight into the
    output and takes no cells.  With ``first = 0`` block 0 takes cells
    too: kernel F's windows."""
    return _greedy_windows([np.asarray(caps, np.int64)], [limit], first)


def _greedy_windows(sizes, limits, first: int = 0) -> np.ndarray:
    """Bounds of the windows that take blocks in order while each of
    ``sizes`` (per-block arrays) sums to at most its limit over the window's
    blocks from ``first`` on, and at least one such block each: one
    ``searchsorted`` per window."""
    B = len(sizes[0])
    cums = [np.concatenate([[0], np.cumsum(v)]) for v in sizes]
    bounds = [0]
    b0 = 0
    while b0 < B:
        a = max(b0, first)
        if a >= B:
            break
        b1 = min(int(np.searchsorted(c, c[a] + lim, side="right")) - 1
                 for c, lim in zip(cums, limits))
        b0 = max(b1, a + 1)
        bounds.append(b0)
    if bounds[-1] != B or B == 0:
        bounds.append(B)
    return np.array(bounds, np.int32)


def _host_ints(values, name: str, B: Optional[int] = None) -> np.ndarray:
    """A sequence or tensor of per-block integers as int64 numpy [B]."""
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    arr = np.asarray(values, dtype=np.int64).reshape(-1)
    if B is not None and len(arr) != B:
        raise ValueError(f"{name} must have one entry per block ({B})")
    return arr


def decode_stream_raw(flat: torch.Tensor, bstart, clen, stored,
                      block_size: int, content_cap: int, linked: bool = True,
                      out_caps=None):
    """Decode one frame's chain of blocks of any size (64 KB steps, up to
    8 MB) as one output stream: kernel E on the card, the plain version on
    the CPU.

    Args:
      flat: [L] uint8 buffer holding every payload (e.g. a raw frame or
        legacy file, uploaded as it is).
      bstart, clen: per-block byte offset into ``flat`` and payload length,
        at any alignment (sequences or tensors); every block must lie
        inside ``flat``.
      stored: per-block flags; a nonzero flag marks an uncompressed block,
        copied in the kernel.
      block_size: the frame's block size, a multiple of 64 KB.
      content_cap: unused; it exists only for parity with the reference's
        signature (the output holds the sum of the caps).
      linked: the frame's block mode (the window crosses blocks when set).
      out_caps: per-block decoded capacities (e.g. exact stored lengths);
        ``block_size`` each by default, so that a short flushed mid-stream
        block does not starve its successors.  Each is clamped to 8 MB.

    Returns (out [sum of caps] uint8, olen [B] int32; -1 = malformed), both
    on ``flat``'s device.  ``out[:sum(olen[olen > 0])]`` holds the good
    blocks' bytes in order; the rest is not part of the result.  Raises
    ``StreamEnvelopeError`` when ``flat`` is longer than STREAM_MAX_INPUT.
    On the card a linked chain decodes its blocks at once, all but the
    first into int32 cells, in windows whose caps sum to at most
    ``CELL_WINDOW`` (``cell_windows``): the call takes 4 bytes of scratch
    per byte of the largest window's caps (256 MB for a 64 MiB frame of
    256 KB blocks, at most 1 GiB).  Independent mode parses every block in
    parallel and decodes it in spans of 2^SPAN_LOG sequences into cells
    (``span_layout``), in windows of at most CELL_WINDOW bytes of caps and
    PARSE_WINDOW of payload: 4 bytes of scratch per byte of a window's
    caps and 17 per byte of its payloads (about 0.7 GB for a 64 MiB -B7
    frame, at most about 2.2 GB).
    """
    check(flat, "flat", torch.uint8, 1)
    if block_size <= 0 or block_size % STREAM_UNIT:
        raise ValueError("block_size must be a multiple of 64KB")
    L = flat.shape[0]
    if L > STREAM_MAX_INPUT:
        raise StreamEnvelopeError(
            f"decode_stream input of {L} bytes exceeds the kernel's int32 "
            "byte offsets")
    bstart = _host_ints(bstart, "bstart")
    B = len(bstart)
    clen = _host_ints(clen, "clen", B)
    stored = _host_ints(stored, "stored", B) != 0
    caps = (np.full((B,), block_size, np.int64) if out_caps is None
            else _host_ints(out_caps, "out_caps", B))
    if (bstart < 0).any() or (clen < 0).any() or (bstart + clen > L).any():
        raise ValueError("every block must lie inside flat")
    if (caps < 0).any():
        raise ValueError("out_caps must not be negative")
    caps = np.minimum(caps, STREAM_BLOCK_CAP)
    cap_total = int(caps.sum())
    if not use_kernel(flat):
        PLAIN_CALLS["decode_stream"] += 1
        data, olen = decode_stream_plain(
            flat.numpy().tobytes(), bstart.tolist(), clen.tolist(),
            stored.tolist(), caps.tolist(), linked)
        out = torch.zeros((cap_total,), dtype=torch.uint8)
        if data:
            out[:len(data)] = torch.frombuffer(bytearray(data),
                                               dtype=torch.uint8)
        return out, torch.tensor(olen, dtype=torch.int32)
    dev = flat.device
    out = torch.empty((cap_total,), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, olen
    meta = ints_to_device(np.stack([bstart, clen, caps, stored]), dev)
    dst = torch.empty((B,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.kernels_lib()
    if linked:
        win = cell_windows(caps, CELL_WINDOW)
        held = max(int(caps[max(b0, 1):b1].sum())
                   for b0, b1 in zip(win[:-1], win[1:]))
        cells = torch.empty((held,), dtype=torch.int32, device=dev)
        need = torch.empty((B + (len(win) - 1) * JUMP_ROUND_FLAGS,),
                           dtype=torch.int32, device=dev)
        with on_device(dev):
            err = lib.lz4tt_decode_stream(
                flat.data_ptr(), meta.data_ptr(), B, win.ctypes.data,
                len(win) - 1, cells.data_ptr(), need.data_ptr(),
                dst.data_ptr(), out.data_ptr(), olen.data_ptr(), stream)
    else:
        lay = span_layout(clen, caps, stored, SPAN_LOG)
        wins = lay["windows"]
        pmax = max(int(wins[:, 2].max()), 1)
        smax = max(int(wins[:, 3].max()), 1)

        def i32(n):
            return torch.empty((n,), dtype=torch.int32, device=dev)

        spans = ints_to_device(lay["spans"], dev, torch.int64)
        pbuf = torch.empty((pmax,), dtype=torch.uint8, device=dev)
        parse, slots = i32(4 * pmax), i32(2 * smax)
        tiles = i32(2 * -(-pmax // SPAN_TILE))
        nspans, cells = i32(B), i32(max(lay["cells"], 1))
        more = torch.zeros((len(wins) * JUMP_ROUND_FLAGS,), dtype=torch.int32,
                           device=dev)
        with on_device(dev):
            err = lib.lz4tt_decode_stream_spans(
                flat.data_ptr(), meta.data_ptr(), B, spans.data_ptr(),
                wins.ctypes.data, len(wins), SPAN_LOG, pmax, smax,
                pbuf.data_ptr(), parse.data_ptr(), tiles.data_ptr(),
                slots.data_ptr(), nspans.data_ptr(), cells.data_ptr(),
                more.data_ptr(), dst.data_ptr(), out.data_ptr(),
                olen.data_ptr(), stream)
    build.check_launch("decode_stream", err)
    LAUNCHES["decode_stream"] += 1
    return out, olen


SPAN_TILE = 4096         # bytes per CTA of the run-end pass (csrc/stream.cu)


def parse_limit(cap):
    """The longest payload a block of ``cap`` decoded bytes can have: its
    literals cost at most 16/15 of their bytes with their token and
    extension, a match at most its length; a longer one is malformed and
    kernel E does not parse it."""
    return cap + cap // 8 + 64


def span_slots(plen, span_log: int):
    """The spans a parsed payload of ``plen`` bytes can take: every span
    but the last covers 2^span_log sequences of at least 3 bytes."""
    return plen // (3 << span_log) + 1


def jump_rounds(links: int) -> int:
    """Rounds of pointer jumping that resolve a chain of up to ``links``
    blocks or spans (csrc/decode.cuh)."""
    k = 1
    while (1 << k) < links:
        k += 1
    return k


def span_layout(clen, caps, stored, span_log: int) -> dict:
    """How kernel E decodes independent blocks on the card, in windows:
    ``parsed`` (a block's payload length if it is parsed, else 0: stored,
    empty, or longer than ``parse_limit``); ``spans`` int64 [4, B], per
    block and window-relative: its base in the parse space, its parsed
    length, its cells' base and its first span slot; ``windows`` int64
    [nwin, 6]: first block, end block, parse-space length, span slots,
    jump rounds and the jump kernel's CTAs per block; ``cells``: the most
    cells a window holds.  A window holds blocks whose parsed caps sum to
    at most CELL_WINDOW and parsed payloads to at most PARSE_WINDOW, or one
    block."""
    clen = np.asarray(clen, np.int64)
    caps = np.asarray(caps, np.int64)
    stored = np.asarray(stored) != 0
    B = len(clen)
    parsed = np.where(~stored & (clen > 0) & (clen <= parse_limit(caps)),
                      clen, 0)
    held_caps = np.where(parsed > 0, caps, 0)
    slots = np.where(parsed > 0, span_slots(parsed, span_log), 0)
    out_caps = np.where(stored | (parsed > 0), caps, 0)
    bounds = _greedy_windows([held_caps, parsed],
                             [CELL_WINDOW, PARSE_WINDOW])
    spans = np.zeros((4, B), np.int64)
    rows = []
    for b0, b1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        sl = slice(b0, b1)
        for row, v in ((0, parsed), (2, held_caps), (3, slots)):
            spans[row, sl] = np.cumsum(v[sl]) - v[sl]
        rows.append([b0, b1, int(parsed[sl].sum()), int(slots[sl].sum()),
                     min(jump_rounds(int(slots[sl].max(initial=0)) + 1),
                         JUMP_ROUND_FLAGS),
                     min(max(-(-int(out_caps[sl].max(initial=0))
                               // SPAN_TILE), 1), 65535)])
    spans[1] = parsed
    return {"parsed": parsed, "spans": spans,
            "windows": np.array(rows, np.int64).reshape(-1, 6),
            "cells": max((int(held_caps[r[0]:r[1]].sum()) for r in rows),
                         default=0)}


# -- CPU models of kernel E's independent schedule (tests only) --------------

def run_ends_plain(src: np.ndarray) -> np.ndarray:
    """Kernel E's step 2: for every byte of ``src``, the first position at
    or after it whose byte is not 255 (``len(src)`` if none)."""
    n = len(src)
    idx = np.where(src != 255, np.arange(n), n)
    return np.minimum.accumulate(idx[::-1])[::-1]


def next_plain(src: np.ndarray, cap: int, stats: Optional[dict] = None):
    """Kernel E's step 3 over one payload: (J, S) int64 [n], J[p] the token
    after a token at p (SEQ_END: p's literal-only sequence ends the block;
    SEQ_FAIL: its literals or an extension run past n, its offset is 0, it
    ends the block with a match, or it writes more than ``cap``), S[p] the
    bytes its sequence writes.  ``stats['reads']`` counts the loads of
    steps 2 and 3: O(n) whatever the bytes."""
    n = len(src)
    v = src.astype(np.int64)
    run = run_ends_plain(src)
    pos = np.arange(n, dtype=np.int64)
    reads = 2 * n                               # step 2, then every token

    def ext(at, want):
        """(sum, next position, ok) of extensions at ``at`` where ``want``."""
        ok = want & (at < n)
        a = np.where(ok, at, 0)
        r = run[a]
        ok &= r < n
        rr = np.where(ok, r, 0)
        return 255 * (rr - a) + v[rr], rr + 1, ok

    lit = v >> 4
    has = lit == 15
    e, nip, eok = ext(pos + 1, has)
    reads += 2 * int(has.sum())
    ok = ~has | eok
    lit = np.where(has, lit + e, lit)
    ip = np.where(has, nip, pos + 1)
    ia = ip + lit
    ok &= (ia <= n) & (lit <= cap)
    end = ok & (ia == n)
    mid = ok & ~end & (ia + 2 <= n)
    a = np.where(mid, ia, 0)
    off = v[a] | (v[np.minimum(a + 1, n - 1)] << 8)
    reads += 2 * int(mid.sum())
    mid &= off != 0
    mh = mid & ((v & 15) == 15)
    e, nim, eok = ext(ia + 2, mh)
    reads += 2 * int(mh.sum())
    mid &= ~mh | eok
    ml = (v & 15) + 4 + np.where(mh, e, 0)
    im = np.where(mh, nim, ia + 2)
    mid &= (im != n) & (lit + ml <= cap)
    J = np.full(n, SEQ_FAIL, np.int64)
    S = np.zeros(n, np.int64)
    J[end], S[end] = SEQ_END, lit[end]
    J[mid], S[mid] = im[mid], (lit + ml)[mid]
    if stats is not None:
        stats["reads"] = stats.get("reads", 0) + reads
    return J, S


def double_plain(J: np.ndarray, S: np.ndarray, rounds: int,
                 stats: Optional[dict] = None):
    """Kernel E's step 4: ``rounds`` rounds of pointer doubling, (J, S) to
    2^rounds sequences on, END and FAIL absorbing, sums saturating past
    the 8 MB cap."""
    for _ in range(rounds):
        go = J >= 0
        j = np.where(go, J, 0)
        S = np.where(go, np.minimum(S + S[j], STREAM_BLOCK_CAP + 1), S)
        J = np.where(go, J[j], J)
        if stats is not None:
            stats["reads"] = stats.get("reads", 0) + 2 * len(J) \
                + 2 * int(go.sum())
    return J, S


def checkpoints_plain(J: np.ndarray, S: np.ndarray, cap: int,
                      stats: Optional[dict] = None):
    """Kernel E's step 5, one block's walk by the doubled (J, S): (spans,
    olen), spans a list of (start token, output base); ([], -1) when the
    chain fails or outgrows ``cap``."""
    p, base, spans = 0, 0, []
    while True:
        spans.append((p, base))
        if stats is not None:
            stats["walk_steps"] = stats.get("walk_steps", 0) + 1
        j = int(J[p])
        if j == SEQ_FAIL:
            return [], ERR_MALFORMED
        base += int(S[p])
        if base > cap:
            return [], ERR_MALFORMED
        if j == SEQ_END:
            return spans, base
        p = j


def decode_cells_plain(src: bytes, n: int, olim: int, plen: int,
                       ip: int = 0, stop: Optional[int] = None,
                       window: bytes = b"", refs: Optional[int] = None):
    """``decode_block_t<false, Out::kCells>`` of csrc/decode.cuh: the
    sequences of ``src[:n]`` from the token at ``ip`` decoded into int32
    cells, a byte or a reference -d to the cell d back, for every byte a
    match copies from before the output's start.  ``plen`` bounds the
    offsets as the window length does.  With ``refs`` only the ``refs``
    positions right before the output are references; before them lie the
    final bytes of ``window`` (kernel D's dictionary rows).  With ``stop``
    (a token boundary, n included) the span ends there.  Returns (length
    or -1, the cells written, the bytes of every sequence before a failing
    one included)."""
    end = n if stop is None else stop
    buf = np.zeros(256, np.int64)
    opos = 0

    def room(k):
        nonlocal buf
        if k > len(buf):
            buf = np.concatenate([buf, np.zeros(max(k, 2 * len(buf))
                                                - len(buf), np.int64)])

    while ip < end:
        token = src[ip]
        ip += 1
        litlen = token >> 4
        if litlen == 15:
            ext, ip, ok = _read_ext(src, ip, n)
            if not ok:
                return ERR_MALFORMED, buf[:opos]
            litlen += ext
        ip_after = ip + litlen
        if ip_after > n or opos + litlen > olim:
            return ERR_MALFORMED, buf[:opos]
        ended = ip_after == n
        if not ended:
            if ip_after + 2 > n:
                return ERR_MALFORMED, buf[:opos]
            offset = src[ip_after] | (src[ip_after + 1] << 8)
            ip_m = ip_after + 2
            mlen = (token & 15) + 4
            if token & 15 == 15:
                ext, ip_m, ok = _read_ext(src, ip_m, n)
                if not ok:
                    return ERR_MALFORMED, buf[:opos]
                mlen += ext
            if offset == 0 or offset > opos + litlen + plen or \
                    opos + litlen + mlen > olim:
                return ERR_MALFORMED, buf[:opos]
        room(opos + litlen)
        buf[opos:opos + litlen] = np.frombuffer(src[ip:ip_after], np.uint8)
        opos += litlen
        if ended:
            return opos, buf[:opos]
        # element i of the match copies position opos - offset + i: before
        # the output a reference -offset, else the cell there (a reference
        # keeps naming its cell); a copy that overlaps itself repeats its
        # first `offset` elements, a reference moving offset farther back
        # on each repeat
        room(opos + mlen)
        first = np.arange(min(offset, mlen)) + opos - offset
        head = np.where(first < 0, -offset, buf[np.maximum(first, 0)])
        head = np.where((first >= 0) & (head < 0), head - offset, head)
        if refs is not None:
            old = first < -refs
            at = np.where(old, first + refs + len(window), 0)
            head = np.where(old, np.frombuffer(window, np.uint8)[at]
                            if window else 0, head)
        q, r = np.divmod(np.arange(mlen), offset)
        val = head[r]
        buf[opos:opos + mlen] = np.where(val < 0, val - q * offset, val)
        opos += mlen
        ip = ip_m
    if stop is not None:
        return opos, buf[:opos]
    return ERR_MALFORMED, buf[:opos]


def jump_cells_plain(cells: np.ndarray, rounds: int,
                     below: Optional[np.ndarray] = None,
                     stats: Optional[dict] = None) -> np.ndarray:
    """``rounds`` synchronous rounds of pointer jumping over ``cells``
    (a reference -d names the cell d back; one link a round, every cell
    reading the values of the round before: the slowest schedule the
    card's rounds can take); a reference below position 0 reads
    ``below``, the final bytes before the cells.  Raises when a reference
    is left, so that a test sees the bound on the rounds fail.  Returns
    the bytes; ``stats['jump_rounds']`` keeps the most rounds that found a
    reference."""
    v = cells.astype(np.int64).copy()
    for k in range(rounds):
        ref = np.flatnonzero(v < 0)
        if not len(ref):
            break
        if stats is not None:
            stats["jump_rounds"] = max(stats.get("jump_rounds", 0), k + 1)
        tgt = ref + v[ref]
        tv = v[np.maximum(tgt, 0)]
        if below is not None and (tgt < 0).any():
            tv = np.where(tgt < 0,
                          below[np.minimum(tgt, -1) + len(below)], tv)
        v[ref] = np.where(tv >= 0, tv, tgt + tv - ref)
    if (v < 0).any():
        raise AssertionError(f"{int((v < 0).sum())} references left after "
                             f"{rounds} rounds")
    return v.astype(np.uint8)


def decode_stream_spans_plain(flat: bytes, bstart: Sequence[int],
                              clen: Sequence[int], stored: Sequence[int],
                              caps: Sequence[int],
                              span_log: Optional[int] = None,
                              stats: Optional[dict] = None
                              ) -> Tuple[bytes, List[int]]:
    """CPU model of kernel E's independent mode on the card
    (csrc/stream.cu steps 1-7): per block the run ends, next and len of
    every byte, ``span_log`` rounds of doubling, the walk that places the
    spans, each span decoded into cells at its base, the rounds that
    resolve them, the good blocks joined.  Equals ``decode_stream_plain``
    with ``linked=False``.  ``stats`` gathers the loads of steps 2-4
    (``reads``), the walk's steps and the spans.  Used by the tests."""
    span_log = SPAN_LOG if span_log is None else span_log
    out, olen = bytearray(), []
    for s, n, st, cap in zip(bstart, clen, stored, caps):
        src = flat[s:s + n]
        if st or not 0 < n <= parse_limit(cap):
            r = n if st and n <= cap else ERR_MALFORMED
            olen.append(r)
            if r > 0:
                out += src
            continue
        J, S = double_plain(*next_plain(np.frombuffer(src, np.uint8), cap,
                                        stats), span_log, stats)
        spans, r = checkpoints_plain(J, S, cap, stats)
        cells = np.zeros(max(r, 0), np.int64)
        for k, (ip, base) in enumerate(spans):
            stop = spans[k + 1][0] if k + 1 < len(spans) else None
            got, c = decode_cells_plain(src, n, cap - base, base, ip, stop)
            if got < 0:
                r = ERR_MALFORMED
                break
            if stop is None and base + got != r:
                raise AssertionError("the walk and the spans disagree")
            cells[base:base + got] = c
        if stats is not None:
            stats["spans"] = stats.get("spans", 0) + len(spans)
        olen.append(r)
        if r > 0:
            out += jump_cells_plain(
                cells, min(jump_rounds(span_slots(n, span_log) + 1),
                           JUMP_ROUND_FLAGS)).tobytes()
    return bytes(out), olen


# -- CPU model of kernel D's batch and resumable schedule (tests only) -------

def walk_row_plain(src: bytes, n: int, olim: int, plen: int,
                   resumable: bool, span_log: int):
    """Kernel D's batch step 1, ``decode_block_t<RESUMABLE, Out::kParse>``
    with its checkpoints: one row's token walk, every check of the serial
    decoder in its order and no byte moved.  Returns (olen, cons, spans,
    sequences): olen and cons as the serial decoder's (cons is n in batch
    mode), spans the (token offset, output base) of every 2^span_log-th
    committed sequence (none for a failed row), sequences the committed
    sequences."""
    ip = opos = seq = 0
    spans: List[Tuple[int, int]] = []
    bad = (ERR_MALFORMED, ERR_MALFORMED, [], seq)
    while ip < n:
        at = ip
        token = src[ip]
        ip += 1
        litlen = token >> 4
        if litlen == 15:
            ext, ip, ok = _read_ext(src, ip, n)
            if not ok:
                return bad
            litlen += ext
        ip_after = ip + litlen
        if ip_after > n or (not resumable and opos + litlen > olim):
            return bad
        ended = ip_after == n
        mlen = 0
        if not ended:
            if ip_after + 2 > n:
                return bad
            offset = src[ip_after] | (src[ip_after + 1] << 8)
            ip = ip_after + 2
            mlen = (token & 15) + 4
            if token & 15 == 15:
                ext, ip, ok = _read_ext(src, ip, n)
                if not ok:
                    return bad
                mlen += ext
            if offset == 0 or offset > opos + litlen + plen or (
                    not resumable and opos + litlen + mlen > olim):
                return bad
        if resumable and opos + litlen + mlen > olim:
            return opos, at, spans, seq          # stop at the token
        if seq % (1 << span_log) == 0:
            spans.append((at, opos))
        seq += 1
        opos += litlen + mlen
        if ended:
            return opos, n, spans, seq
    if not resumable:
        return bad
    return opos, ip, spans, seq


def decode_rows_spans_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                            out_cap: int, out_caps: torch.Tensor,
                            dict_rows: Optional[torch.Tensor] = None,
                            dict_lens: Optional[torch.Tensor] = None,
                            resumable: bool = False,
                            span_log: Optional[int] = None,
                            stats: Optional[dict] = None):
    """CPU model of kernel D's batch and resumable modes on the card
    (csrc/decode.cu, batch steps 1-3): per row the walk with its
    checkpoints (``walk_row_plain``), each span of a good row decoded into
    cells at its base (the last one stopping at cons; a copy from before
    the row reads the dictionary), the rounds that resolve them.  Same
    arguments and returns as ``decode_blocks`` (``resumable=False``) or
    ``decode_blocks_dest_size``; equals them.  ``stats`` gathers per row
    the committed sequences (``row_sequences``) and spans
    (``row_spans``), and the most jump rounds a row needed.  Used by the
    tests."""
    span_log = ROW_SPAN_LOG if span_log is None else span_log
    B, M = comp.shape
    N = int(out_cap)
    P = 0 if dict_rows is None else dict_rows.shape[1]
    stride = span_slots(M, span_log)
    rounds = min(jump_rounds(stride + 1), JUMP_ROUND_FLAGS)
    out = torch.zeros((B, N), dtype=torch.uint8)
    olen = torch.zeros((B,), dtype=torch.int32)
    cons = torch.zeros((B,), dtype=torch.int32) if resumable else None
    plens = dict_lens.tolist() if dict_rows is not None else [0] * B
    for b, (n, cap) in enumerate(zip(comp_lens.tolist(), out_caps.tolist())):
        n, cap = min(max(n, 0), M), min(cap, N)
        plen = min(max(plens[b], 0), P)
        window = dict_rows[b, P - plen:].numpy().tobytes() if plen else b""
        src = comp[b].numpy().tobytes()
        r, c, spans, seqs = walk_row_plain(src, n, cap, plen, resumable,
                                           span_log)
        if len(spans) > stride:
            raise AssertionError("more spans than the row's slots")
        olen[b] = r
        if resumable:
            cons[b] = c
        if stats is not None:
            stats.setdefault("row_sequences", []).append(seqs)
            stats.setdefault("row_spans", []).append(len(spans))
        if r <= 0:
            continue
        cells = np.zeros(r, np.int64)
        for k, (ip, base) in enumerate(spans):
            last = k + 1 == len(spans)
            stop = c if resumable and last else None if last \
                else spans[k + 1][0]
            got, cl = decode_cells_plain(src, n, cap - base, base + plen, ip,
                                         stop, window, refs=base)
            if base + got != (r if last else spans[k + 1][1]):
                raise AssertionError("the walk and the spans disagree")
            cells[base:base + got] = cl
        out[b, :r] = torch.from_numpy(jump_cells_plain(cells, rounds,
                                                       stats=stats))
    return out, olen, cons


def decode_stream(payloads: Sequence[bytes], block_size: int,
                  content_cap: int, linked: bool = True, out_caps=None,
                  device="cuda"):
    """``decode_stream_raw`` over a list of compressed payloads in stream
    order (stored blocks wrapped as literal-only blocks by the caller),
    joined into one buffer on ``device``.  Same returns."""
    flat, bstart, clen = join_payloads(payloads, device)
    return decode_stream_raw(flat, bstart, clen, np.zeros_like(clen),
                             block_size, content_cap, linked,
                             out_caps=out_caps)


def join_payloads(payloads: Sequence[bytes], device):
    """Payloads joined into one uint8 tensor on ``device``, with each one's
    offset and length (int64 numpy [B])."""
    payloads = [bytes(p) for p in payloads]
    clen = np.array([len(p) for p in payloads], np.int64)
    bstart = np.concatenate([[0], np.cumsum(clen)[:-1]]) if len(clen) \
        else clen
    return to_device(b"".join(payloads), device), bstart, clen


# ---------------------------------------------------------------------------
# kernel F: the scatter-gather chain decoder
# ---------------------------------------------------------------------------

SG_BLOCK_CAP = 65536       # no SG chain block decodes past 64 KB here


def decode_blocks_sg_plain(flat: bytes, bstart: Sequence[int],
                           clen: Sequence[int], sizes: Sequence[int]
                           ) -> Tuple[bytes, List[int]]:
    """Plain version of kernel F, with the semantics of the TPU kernel in
    mode ``sg``: block k (``clen[k]`` bytes at ``flat[bstart[k]:]``) decodes
    into one continuous output at ``cum[k] = sum(sizes[:k])``, into at most
    ``sizes[k]`` bytes, with the 64 KB of that output just before ``cum[k]``
    as its window (across block boundaries).  A failed block reports -1 and
    keeps the bytes it wrote before the failing sequence; it moves no later
    block.  Returns (the output, sum(sizes) bytes, zero where nothing was
    written; olen per block)."""
    out = bytearray(sum(sizes))
    olen = []
    cum = 0
    for s, n, cap in zip(bstart, clen, sizes):
        window = bytes(out[max(cum - MAX_OFFSET, 0):cum])
        r, dec = decode_block_plain(flat[s:s + n], n, cap, window)
        out[cum:cum + len(dec)] = dec
        olen.append(r)
        cum += cap
    return bytes(out), olen


def decode_blocks_sg_cells_plain(flat: bytes, bstart: Sequence[int],
                                 clen: Sequence[int], sizes: Sequence[int],
                                 limit: Optional[int] = None
                                 ) -> Tuple[bytes, List[int]]:
    """CPU model of kernel F on the card (csrc/sg_decode.cu): in windows of
    at most ``limit`` (CELL_WINDOW) bytes of output (``cell_windows`` with
    ``first=0``), zeroed cells, every block decoded into them at once at
    cum[k] with plen = min(cum[k], 65535) (a failed block keeps its
    sequences before the failing one; what no block writes stays the byte
    0), then the rounds that resolve the references, those below the
    window reading the final bytes before it.  Equals
    ``decode_blocks_sg_plain``.  Used by the tests."""
    limit = CELL_WINDOW if limit is None else limit
    sizes = np.asarray(sizes, np.int64)
    cum = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    out = np.zeros(int(cum[-1]), np.uint8)
    olen: List[int] = []
    win = cell_windows(sizes, limit, first=0)
    for k0, k1 in zip(win[:-1], win[1:]):
        origin = int(cum[k0])
        cells = np.zeros(int(cum[k1]) - origin, np.int64)
        for k in range(k0, k1):
            n = int(clen[k])
            src = flat[int(bstart[k]):int(bstart[k]) + n]
            r, c = decode_cells_plain(src, n, int(sizes[k]),
                                      min(int(cum[k]), MAX_OFFSET))
            olen.append(r)
            at = int(cum[k]) - origin
            cells[at:at + len(c)] = c
        out[origin:int(cum[k1])] = jump_cells_plain(
            cells, jump_rounds(k1 - k0 + 1), below=out[:origin])
    return out.tobytes(), olen


def decode_blocks_sg_raw(flat: torch.Tensor, bstart, clen, out_sizes):
    """Decode an SG chain: kernel F on the card, the plain version on the
    CPU.

    Args:
      flat: [L] uint8 buffer holding every payload.
      bstart, clen: per-block byte offset into ``flat`` and payload length
        (sequences or tensors); every block must lie inside ``flat``.
      out_sizes: per-block decoded sizes, each at most 64 KB: block k's
        output starts at ``sum(out_sizes[:k])`` and may not pass its size.

    Returns (out [sum(out_sizes)] uint8: the continuous content from byte
    0, olen [B] int32; -1 = malformed), on ``flat``'s device.  Bytes of a
    block that failed are not part of the result.
    """
    check(flat, "flat", torch.uint8, 1)
    bstart = _host_ints(bstart, "bstart")
    B = len(bstart)
    clen = _host_ints(clen, "clen", B)
    sizes = _host_ints(out_sizes, "out_sizes", B)
    L = flat.shape[0]
    if (bstart < 0).any() or (clen < 0).any() or (bstart + clen > L).any():
        raise ValueError("every block must lie inside flat")
    if (sizes < 0).any() or (sizes > SG_BLOCK_CAP).any():
        raise ValueError("sg kernel blocks are limited to 64KB outputs")
    total = int(sizes.sum())
    N = -(-max(int(sizes.max(initial=1)), 1) // 128) * 128
    if total + 65536 + N + 256 >= 2 ** 31 or L >= 2 ** 31:
        # the JAX kernel's int32 addressing limit, kept as the envelope
        raise ValueError("decode_blocks_sg output space exceeds the "
                         "kernel's int32 addressing limit")
    if not use_kernel(flat):
        PLAIN_CALLS["decode_sg"] += 1
        data, olen = decode_blocks_sg_plain(
            flat.numpy().tobytes(), bstart.tolist(), clen.tolist(),
            sizes.tolist())
        return to_device(data, "cpu"), torch.tensor(olen, dtype=torch.int32)
    dev = flat.device
    # every byte is written: the cells start zeroed, as the plain version's
    # output does
    out = torch.empty((total,), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, olen
    cum = np.concatenate([[0], np.cumsum(sizes)])
    win = cell_windows(sizes, CELL_WINDOW, first=0)
    wcum = np.ascontiguousarray(cum[win], dtype=np.int64)
    cells = torch.empty((max(int(np.diff(wcum).max()), 1),),
                        dtype=torch.int32, device=dev)
    more = torch.zeros(((len(win) - 1) * JUMP_ROUND_FLAGS,),
                       dtype=torch.int32, device=dev)
    offs = torch.from_numpy(np.stack([bstart, cum[:-1]])).to(dev)
    meta = torch.from_numpy(np.stack([clen, sizes]).astype(np.int32)).to(dev)
    with on_device(dev):
        err = build.kernels_lib().lz4tt_decode_sg(
            flat.data_ptr(), offs[0].data_ptr(), meta[0].data_ptr(),
            meta[1].data_ptr(), offs[1].data_ptr(), B, win.ctypes.data,
            wcum.ctypes.data, len(win) - 1, cells.data_ptr(), more.data_ptr(),
            out.data_ptr(), olen.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_sg", err)
    LAUNCHES["decode_sg"] += 1
    return out, olen


def decode_blocks_sg(comp: torch.Tensor, comp_lens: torch.Tensor,
                     out_sizes):
    """``decode_blocks_sg_raw`` over [B, M] uint8 payload rows and [B] int32
    lengths (clamped to [0, M]), in the JAX function's argument order.
    Returns (out [sum(out_sizes)] uint8, olen [B] int32); the JAX function's
    output holds the same content from byte 65536 of its space."""
    _check_comp(comp, comp_lens)
    B, M = comp.shape
    clen = comp_lens.cpu().numpy().astype(np.int64).clip(0, M)
    return decode_blocks_sg_raw(comp.reshape(-1), np.arange(B) * M, clen,
                                out_sizes)
