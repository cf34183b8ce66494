"""Safe LZ4 block decoders: kernel D, in two modes, the stream decoder
(kernel E) and the scatter-gather chain decoder (kernel F).

Counterpart of ``lz4_tpu/kernels/decode_kernel.py`` (``_make_decode_kernel``
in modes ``linked``, ``batch`` and ``sg``, without dictionary rows and not
resumable, and ``_make_stream_decode_kernel``).  The block semantics are
those of the JAX kernels' general path:

* a sequence's literal run must lie inside the block (``clen``); a run that
  ends exactly at ``clen`` ends the block;
* otherwise the match offset must be in ``(0, opos + plen]``, where ``plen``
  is the window length, and the output must fit ``min(cap, N)``;
* anything else, or input that ends after a match, gives length -1.

``decode_blocks_linked`` decodes one chain in order: block b's window is
block b-1's output when that block decoded to exactly ``block_size`` bytes,
and empty otherwise; block 0 may take an initial window.
``decode_blocks`` decodes independent rows.  ``decode_stream_raw`` (and
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
from .common import LAUNCHES, PLAIN_CALLS, check, to_device, use_kernel

ERR_MALFORMED = -1
MAX_OFFSET = 65535                # the largest LZ4 match offset
STREAM_UNIT = 65536               # stream block sizes are multiples of this
STREAM_BLOCK_CAP = 1 << 23        # no stream block decodes past 8 MB
# csrc/stream.cu holds byte offsets and lengths into the input as int32
# (output offsets are int64), so the input is at most this long
STREAM_MAX_INPUT = (1 << 31) - 1


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
    meta = torch.from_numpy(np.stack([bstart, clen, caps, stored])
                            .astype(np.int32)).to(dev)
    if linked:
        cap_off = scratch = dst = None
    else:
        offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
        cap_off = torch.from_numpy(offs).to(dev)
        scratch = torch.empty((cap_total,), dtype=torch.uint8, device=dev)
        dst = torch.empty((B,), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = build.kernels_lib().lz4tt_decode_stream(
        flat.data_ptr(), meta.data_ptr(), B, int(linked), ptr(cap_off),
        ptr(scratch), ptr(dst), out.data_ptr(), olen.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_stream", err)
    LAUNCHES["decode_stream"] += 1
    return out, olen


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
    # zeroed, like the plain version: a failed block's unwritten bytes (and
    # the windows that reach them) read zeros in both
    out = torch.zeros((total,), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, olen
    cum = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    offs = torch.from_numpy(np.stack([bstart, cum])).to(dev)
    meta = torch.from_numpy(np.stack([clen, sizes]).astype(np.int32)).to(dev)
    err = build.kernels_lib().lz4tt_decode_sg(
        flat.data_ptr(), offs[0].data_ptr(), meta[0].data_ptr(),
        meta[1].data_ptr(), offs[1].data_ptr(), B, out.data_ptr(),
        olen.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
