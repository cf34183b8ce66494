"""Safe LZ4 block decoder: kernel D, in two modes.

Counterpart of ``lz4_tpu/kernels/decode_kernel.py`` (``_make_decode_kernel``
in modes ``linked`` and ``batch``, without dictionary rows and not
resumable).  The semantics are those of the JAX kernel's general path:

* a sequence's literal run must lie inside the block (``clen``); a run that
  ends exactly at ``clen`` ends the block;
* otherwise the match offset must be in ``(0, opos + plen]``, where ``plen``
  is the window length, and the output must fit ``min(cap, N)``;
* anything else, or input that ends after a match, gives length -1.

``decode_blocks_linked`` decodes one chain in order: block b's window is
block b-1's output when that block decoded to exactly ``block_size`` bytes,
and empty otherwise; block 0 may take an initial window.
``decode_blocks`` decodes independent rows.

Each wrapper launches ``csrc/decode.cu`` for tensors on the card and runs
the plain Python decoder below for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .common import LAUNCHES, PLAIN_CALLS, check, use_kernel

ERR_MALFORMED = -1


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


def decode_block_plain(src: bytes, n: int, olim: int, window: bytes = b""):
    """Decode one block of ``n`` bytes into at most ``olim`` bytes, with
    ``window`` (the bytes right before the output) as match history.
    Returns (olen, output bytes); olen is -1 for a malformed block."""
    out = bytearray()
    plen = len(window)
    ip, status = 0, 0
    while status == 0 and ip < n:
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
            break                           # status 0: malformed
        out += src[ip:ip_after]
        if ended:
            status = 1
            break
        start = len(out) - offset
        if start >= 0 and offset >= mlen:
            out += out[start:start + mlen]
        else:
            for i in range(mlen):
                p = start + i
                out.append(window[plen + p] if p < 0 else out[p])
        ip = ip_m
    return (len(out) if status == 1 else ERR_MALFORMED), bytes(out)


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
    """
    _check_comp(comp, comp_lens)
    B, M = comp.shape
    N = int(block_size)
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
    err = build.kernels_lib().lz4tt_decode_linked(
        comp.data_ptr(), M, comp_lens.data_ptr(), init_window.data_ptr(),
        int(init_window_len), out.data_ptr(), N, olen.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_linked", err)
    LAUNCHES["decode_linked"] += 1
    return out, olen


def decode_blocks(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int,
                  out_caps: Optional[torch.Tensor] = None):
    """Decode a batch of independent LZ4 blocks.

    Args:
      comp: [B, M] uint8 payloads, zero padded.
      comp_lens: [B] int32 lengths (clamped to [0, M]).
      out_cap: decoded capacity of every row.
      out_caps: optional [B] int32 exact capacity per row (<= out_cap);
        decoding past it reports -1, like LZ4_decompress_safe.

    Returns (out [B, out_cap] uint8, olen [B] int32; -1 = malformed).
    """
    _check_comp(comp, comp_lens)
    B, M = comp.shape
    N = int(out_cap)
    dev = comp.device
    if out_caps is None:
        out_caps = torch.full((B,), N, dtype=torch.int32, device=dev)
    check(out_caps, "out_caps", torch.int32, 1)
    if out_caps.shape[0] != B:
        raise ValueError("out_caps must be [B]")
    if not use_kernel(comp, comp_lens, out_caps):
        PLAIN_CALLS["decode_batch"] += 1
        out = torch.zeros((B, N), dtype=torch.uint8)
        olen = torch.zeros((B,), dtype=torch.int32)
        for b, (n, cap) in enumerate(zip(comp_lens.tolist(),
                                         out_caps.tolist())):
            olen[b], dec = decode_block_plain(comp[b].numpy().tobytes(),
                                              min(max(n, 0), M), min(cap, N))
            if dec:
                out[b, :len(dec)] = torch.frombuffer(bytearray(dec),
                                                     dtype=torch.uint8)
        return out, olen
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    err = build.kernels_lib().lz4tt_decode_batch(
        comp.data_ptr(), M, comp_lens.data_ptr(), out_caps.data_ptr(),
        out.data_ptr(), N, olen.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_batch", err)
    LAUNCHES["decode_batch"] += 1
    return out, olen
