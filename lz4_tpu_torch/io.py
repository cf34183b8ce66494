"""File I/O: ``.lz4`` files and streams through the device codec.

Counterpart of ``lz4_tpu/io.py`` (parity with the reference I/O layer,
``programs/lz4io.c``), routed as ``lz4_tpu`` routes it when it has a device.

* Compress: HC levels (3 and up) read the whole input and go through
  ``compress_frame_device_hc`` (kernel I); ``-BD`` goes through
  ``DeviceFrameCompressor`` (kernels A and C) in 4 MB reads; everything
  else reads 4 MB at a time and compresses its 64 KB blocks through
  ``encode_batch`` (kernel B), with block records and checksums written on
  the host.  Legacy compress (``-l``) reads the whole input and goes
  through ``compress_legacy_device`` (kernel A, or kernel I at HC levels).
* Decompress: concatenated LZ4F frames, legacy frames, skippable frames,
  pass-through of non-LZ4 input, sparse writing that seeks over zero runs.
  Every frame is decoded by ``lz4_tpu_torch.device`` (kernels D and E), at
  any size; there is no host codec, so the one layout outside the kernels'
  envelope (linked blocks under 64 KB, which no block size id gives)
  raises ``DeviceLayoutUnsupported``.

Every function takes a ``device``; the default ``"cuda"`` raises on a
machine without a card, and ``"cpu"`` runs the kernels' plain versions.
Nothing here reads the environment.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import sys
import time
from typing import BinaryIO, Optional, Tuple

from . import spec
from .device import (BLOCK, DeviceFrameCompressor, compress_frame_device_hc,
                     compress_legacy_device, decompress_frame_device,
                     decompress_legacy_device, encode_batch)
from .frame import FramePreferences, Lz4FrameError, encode_frame_header
from .kernels.common import resolve_device
from .ops.xxhash import XXH32State, xxh32

LZ4_EXTENSION = ".lz4"
CHUNK = 4 * 1024 * 1024  # read granularity (lz4io.c uses 4 MB reads)


@dataclasses.dataclass
class IoPrefs:
    """The g_* knobs of lz4io.c:134-140, as a struct."""

    level: int = 1                  # 0-2 fast, >= 3 HC
    block_size_id: int = 7          # -B4..7
    block_linked: bool = False      # -BD sets linked; the reference's
                                    # default is independent (lz4io.c:138)
    block_checksum: bool = False    # -BX
    content_checksum: bool = True   # --no-frame-crc clears
    content_size: bool = False      # --content-size
    sparse: bool = True             # --no-sparse clears (auto off for stdout)
    overwrite: bool = False         # -f
    test_mode: bool = False         # -t
    legacy: bool = False            # -l (8 MB legacy blocks)
    pass_through: bool = False      # -d -f on non-lz4 input
    remove_src: bool = False        # --rm
    min_match: int = 4              # --min-match
    verbosity: int = 2


def _prefs_to_frame(p: IoPrefs, content_size: Optional[int]) \
        -> FramePreferences:
    return FramePreferences(
        block_size_id=p.block_size_id,
        block_independent=not p.block_linked,
        content_checksum=p.content_checksum,
        block_checksum=p.block_checksum,
        content_size=content_size,
        level=p.level if p.level >= 3 else 0,
    )


class ProgressMeter:
    """150 ms-throttled stderr progress display (parity: DISPLAYUPDATE,
    lz4io.c:123-128): shown at default verbosity (>=2) once more than
    16 MB has been processed, refreshed at most every 150 ms, erased by
    ``done()``.  Streams of unknown size show MB processed; known sizes
    add the share done, and the ratio so far when output is counted."""

    INTERVAL = 0.150
    MIN_BYTES = 16 * 1024 * 1024

    def __init__(self, prefs: IoPrefs, verb: str,
                 total: Optional[int] = None):
        self.enabled = prefs.verbosity >= 2
        self.verb = verb
        self.total = total
        self.next_at = time.monotonic() + self.INTERVAL
        self.shown = False

    def update(self, processed: int, produced: int) -> None:
        if not self.enabled or processed < self.MIN_BYTES:
            return
        now = time.monotonic()
        if now < self.next_at:
            return
        self.next_at = now + self.INTERVAL
        msg = f"\r{self.verb} : {processed >> 20} MB"
        if self.total:
            msg += f" ({100.0 * processed / self.total:.1f}%)"
        if produced and processed:
            msg += f"  ==> {100.0 * produced / processed:.2f}%"
        sys.stderr.write(msg + "   ")
        sys.stderr.flush()
        self.shown = True

    def done(self) -> None:
        if self.shown:
            sys.stderr.write("\r" + " " * 60 + "\r")
            sys.stderr.flush()
            self.shown = False


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _independent_records(chunk: bytes, fp: FramePreferences, prefs: IoPrefs,
                         dev) -> bytes:
    """The block records of one read: 64 KB blocks through kernel B (the
    device path turns -B5..7 into 64 KB blocks, as lz4_tpu's does), a
    stored block where the payload is not smaller, block checksums."""
    blocks = [chunk[i:i + BLOCK] for i in range(0, len(chunk), BLOCK)]
    comp_rows, comp_lens = encode_batch(blocks, BLOCK, 1, prefs.min_match,
                                        device=dev)
    parts = []
    for i, blk in enumerate(blocks):
        clen = int(comp_lens[i])
        if clen >= len(blk):
            payload, size = blk, len(blk) | spec.UNCOMPRESSED_BIT
        else:
            payload, size = comp_rows[i, :clen].tobytes(), clen
        parts += [struct.pack("<I", size), payload]
        if fp.block_checksum:
            parts.append(struct.pack("<I", xxh32(payload, 0)))
    return b"".join(parts)


def compress_stream(src: BinaryIO, dst: BinaryIO, prefs: IoPrefs,
                    src_size: Optional[int] = None,
                    device="cuda") -> Tuple[int, int]:
    """Compress a stream to one .lz4 frame; returns (read, written).

    Every HC level goes to kernel I: unlike lz4_tpu, no input is sent to a
    host HC codec for being small (the port has none).  ``prefs.legacy``
    writes a legacy frame, as lz4_tpu does with its host codec, here with
    the block work on the device."""
    dev = resolve_device(device)
    if prefs.legacy:
        data = src.read()
        out = compress_legacy_device(data, level=prefs.level,
                                     min_match=prefs.min_match, device=dev)
        dst.write(out)
        return len(data), len(out)
    if prefs.level >= 3:
        data = src.read()
        fp = _prefs_to_frame(prefs, len(data) if prefs.content_size else None)
        frame = compress_frame_device_hc(data, fp, level=prefs.level,
                                         device=dev)
        dst.write(frame)
        return len(data), len(frame)
    fp = _prefs_to_frame(prefs, src_size if prefs.content_size else None)
    if prefs.block_linked:
        # one linked frame in 4 MB reads, the 64 KB window carried across
        # reads; the block size is the chain unit, 64 KB (lz4_tpu io.py:177)
        fp.block_size_id = 4
        comp = DeviceFrameCompressor(fp, min_match=prefs.min_match,
                                     device=dev)
        header, encode, end = comp.begin(), comp.update, comp.end
    else:
        header = encode_frame_header(fp)
        xxh = XXH32State(0)

        def encode(chunk: bytes) -> bytes:
            if fp.content_checksum:
                xxh.update(chunk)
            return _independent_records(chunk, fp, prefs, dev)

        def end() -> bytes:
            tail = struct.pack("<I", 0)
            if fp.content_checksum:
                tail += struct.pack("<I", xxh.digest())
            return tail

    dst.write(header)
    total_in, total_out = 0, len(header)
    meter = ProgressMeter(prefs, "Read", src_size)
    while True:
        chunk = src.read(CHUNK)
        if not chunk:
            break
        total_in += len(chunk)
        out = encode(chunk)
        total_out += len(out)
        dst.write(out)
        meter.update(total_in, total_out)
    tail = end()
    dst.write(tail)
    meter.done()
    return total_in, total_out + len(tail)


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

class SparseWriter:
    """Zero-run skipping writer (parity: LZ4IO_fwriteSparse,
    lz4io.c:641-726).  Seeks over long zero runs; the caller truncates the
    file to ``written`` after ``close()``."""

    GRAIN = 4096

    def __init__(self, f: BinaryIO, enabled: bool):
        self.f = f
        self.enabled = enabled and f.seekable()
        self.pending_zeros = 0
        self.written = 0

    def write(self, data: bytes) -> None:
        self.written += len(data)
        if not self.enabled:
            self.f.write(data)
            return
        view = memoryview(data)
        zeros = bytes(self.GRAIN)
        while view:
            take = min(len(view), self.GRAIN)
            piece = view[:take]
            if piece == zeros[:take]:
                self.pending_zeros += take
            else:
                if self.pending_zeros:
                    self.f.seek(self.pending_zeros, io.SEEK_CUR)
                    self.pending_zeros = 0
                self.f.write(piece)
            view = view[take:]

    def close(self) -> None:
        if self.pending_zeros and self.enabled:
            # materialize the final hole (lz4io writes a last byte)
            self.f.seek(self.pending_zeros - 1, io.SEEK_CUR)
            self.f.write(b"\x00")
            self.pending_zeros = 0


def decompress_stream(src: BinaryIO, dst, prefs: IoPrefs,
                      device="cuda") -> Tuple[int, int]:
    """Decode all concatenated frames from ``src`` into ``dst``; returns
    (read, written).

    Magic dispatch as lz4io.c:904-956: LZ4F frames, legacy frames and
    skippable frames (skipped); unknown input is passed through when
    ``prefs.pass_through`` is set and it is the first stream, an error when
    it is the first stream otherwise, and the end of the input after a
    valid stream (trailing garbage stops without error)."""
    total_out = 0
    buf = src.read()
    pos = 0
    first = True
    meter = ProgressMeter(prefs, "Decoded", None)
    while pos < len(buf):
        if len(buf) - pos < 4:
            if first and prefs.pass_through:
                dst.write(buf[pos:])
                total_out += len(buf) - pos
                pos = len(buf)
                break
            if first:
                raise Lz4FrameError("input too short")
            # trailing garbage after a valid stream: stop without error
            # (lz4io.c:948-952 "Stream followed by unrecognized data")
            break
        magic = struct.unpack_from("<I", buf, pos)[0]
        if magic == spec.FRAME_MAGIC:
            # lz4_tpu's _decode_one_frame hands DeviceLayoutUnsupported to
            # its host codec; the port has none, so the error propagates
            # (only linked blocks under 64 KB raise it)
            content, used = decompress_frame_device(buf[pos:], device=device)
            dst.write(content)
            total_out += len(content)
            pos += used
        elif magic == spec.LEGACY_MAGIC:
            content, used = decompress_legacy_device(buf[pos:], device=device)
            dst.write(content)
            total_out += len(content)
            pos += used
        elif (magic & spec.SKIPPABLE_MAGIC_MASK) == spec.SKIPPABLE_MAGIC_MIN:
            if len(buf) - pos < 8:
                raise Lz4FrameError("truncated skippable frame")
            size = struct.unpack_from("<I", buf, pos + 4)[0]
            pos += 8 + size
        else:
            # unknown magic: pass the whole input through when forced on
            # the FIRST stream (lz4io.c:946-952 pass-through contract);
            # after a valid stream, stop without error
            if first and prefs.pass_through:
                dst.write(buf[pos:])
                total_out += len(buf) - pos
                pos = len(buf)
            elif first:
                raise Lz4FrameError(f"unrecognized header {magic:#010x}")
            else:
                break
        first = False
        meter.update(total_out, 0)
    meter.done()
    return pos, total_out


def _open_dst(path: str, prefs: IoPrefs) -> BinaryIO:
    if path == "-":
        return sys.stdout.buffer
    if os.path.exists(path) and not prefs.overwrite:
        raise FileExistsError(f"{path} already exists; use -f to overwrite")
    return open(path, "wb")


def compress_filename(src_path: str, dst_path: str, prefs: IoPrefs,
                      device="cuda") -> Tuple[int, int]:
    """Compress ``src_path`` ("-" = stdin) to ``dst_path`` ("-" = stdout);
    returns (read, written)."""
    src = sys.stdin.buffer if src_path == "-" else open(src_path, "rb")
    try:
        size = None if src_path == "-" else os.path.getsize(src_path)
        dst = _open_dst(dst_path, prefs)
        try:
            r, w = compress_stream(src, dst, prefs, size, device)
        finally:
            if dst is not sys.stdout.buffer:
                dst.close()
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    if prefs.remove_src and src_path != "-":
        os.unlink(src_path)
    return r, w


def compress_multiple(paths, prefs: IoPrefs, device="cuda") -> int:
    """-m: each ``file`` -> ``file.lz4``; returns the number of files that
    failed (each reported on stderr)."""
    errors = 0
    for p in paths:
        try:
            compress_filename(p, p + LZ4_EXTENSION, prefs, device)
        except Exception as e:  # one bad file must not stop the others
            print(f"lz4: {p}: {e}", file=sys.stderr)
            errors += 1
    return errors


def decompress_filename(src_path: str, dst_path: str, prefs: IoPrefs,
                        device="cuda") -> Tuple[int, int]:
    """Decode ``src_path`` ("-" = stdin) to ``dst_path`` ("-" = stdout);
    returns (read, written).  Test mode (-t) decodes without writing."""
    src = sys.stdin.buffer if src_path == "-" else open(src_path, "rb")
    try:
        if prefs.test_mode:
            return decompress_stream(src, io.BytesIO(), prefs, device)
        dst = _open_dst(dst_path, prefs)
        sparse = SparseWriter(dst, prefs.sparse
                              and dst is not sys.stdout.buffer)
        try:
            r, w = decompress_stream(src, sparse, prefs, device)
            sparse.close()
            if sparse.enabled:
                dst.truncate(sparse.written)
        finally:
            if dst is not sys.stdout.buffer:
                dst.close()
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    if prefs.remove_src and src_path != "-":
        os.unlink(src_path)
    return r, w


def decompress_multiple(paths, prefs: IoPrefs, device="cuda") -> int:
    """-m -d: each ``file.lz4`` -> ``file``; returns the number of files
    that failed (each reported on stderr)."""
    errors = 0
    for p in paths:
        if not p.endswith(LZ4_EXTENSION):
            print(f"lz4: {p}: unknown suffix, skipping", file=sys.stderr)
            errors += 1
            continue
        try:
            decompress_filename(p, p[:-len(LZ4_EXTENSION)], prefs, device)
        except Exception as e:  # one bad file must not stop the others
            print(f"lz4: {p}: {e}", file=sys.stderr)
            errors += 1
    return errors
