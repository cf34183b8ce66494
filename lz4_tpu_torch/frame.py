"""LZ4F frames (spec v1.5.1) for the PyTorch/CUDA port: the header codec
and the streaming API.

Counterpart of ``lz4_tpu/frame.py``.  The host parses and writes the frame
container; every block is coded on the device:

* ``FrameCompressor`` (``begin``/``update``/``flush``/``end``) and
  ``compress_frame`` keep ``lz4_tpu``'s layout: the same header, block
  boundaries, flushes, stored blocks and checksums.  The blocks an
  ``update`` completes are coded together: independent blocks up to
  256 KB by kernel B, packed by kernel C; linked blocks, and blocks over
  256 KB, by kernel A (each block one chain behind the 64 KB before it,
  joined; ``device.chain_records``, the route ``compress_frame_device``
  takes for independent blocks over 256 KB); at level 3 and up by kernel I's
  64 KB pieces, each behind the 64 KB before it, joined per block
  (``hc.hc_payloads``; a linked block's first piece behind the window of
  the blocks before it, as ``lz4_tpu``'s host HC links them).  The
  payloads are the kernels' parse, not the host codec's, so they differ
  from ``lz4_tpu``'s.
* ``FrameDecompressor`` is ``lz4_tpu``'s resumable state machine
  (``LZ4F_decompress``): ``feed`` never reads past what it needs, stages
  partial units, and returns what it consumed and the bytes it decoded.
  The blocks a ``feed`` completes are decoded together at its end, in one
  launch: 64 KB blocks by kernel D (batch mode; linked mode behind the
  last 64 KB decoded so far, which a short block before the feed's last
  sends to kernel E instead), larger blocks by kernel E
  (``device.decode_stream_runs``; linked behind that window).  Checks and
  errors are ``lz4_tpu``'s,
  raised in the same call: a pending block is decoded before any later
  error is raised, and a rejected block's message comes from the host's
  walk over its lengths (``block.walk_safe``).
* ``compress_legacy``/``decompress_legacy`` wrap
  ``device.compress_legacy_device``/``decompress_legacy_device``.

``device.compress_frame_device``/``decompress_frame_device`` stay the
one-shot routes.  Every entry point takes ``device`` (default ``"cuda"``,
which raises without a card; ``"cpu"`` runs the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import spec
from .kernels.common import resolve_device
from .kernels.encode_kernel import MAX_BLOCK
from .ops.xxhash import XXH32State, xxh32


class Lz4FrameError(ValueError):
    pass


@dataclasses.dataclass
class FramePreferences:
    """The fields of ``LZ4F_preferences_t``, as ``lz4_tpu.frame`` has them."""

    block_size_id: int = 0          # 0 = default (4MB); else 4..7
    block_independent: bool = False
    content_checksum: bool = False
    block_checksum: bool = False
    content_size: Optional[int] = None  # embed content size when not None
    level: int = 0
    auto_flush: bool = False
    acceleration: int = 1

    @classmethod
    def from_fields(cls, **fields) -> "FramePreferences":
        """Build from the fields of another package's preferences, e.g.
        ``FramePreferences.from_fields(**dataclasses.asdict(jax_prefs))``."""
        return cls(**fields)

    def resolved_bsid(self) -> int:
        if self.block_size_id == 0:
            return spec.DEFAULT_BLOCK_SIZE_ID
        if self.block_size_id not in spec.BLOCK_SIZES:
            raise Lz4FrameError(f"invalid blockSizeID {self.block_size_id}")
        return self.block_size_id


@dataclasses.dataclass
class FrameInfo:
    """The fields of ``LZ4F_frameInfo_t`` plus the parsed header size."""

    block_size_id: int = 7
    block_independent: bool = False
    content_checksum: bool = False
    block_checksum: bool = False
    content_size: Optional[int] = None
    header_size: int = 0

    @property
    def block_size(self) -> int:
        return spec.BLOCK_SIZES[self.block_size_id]


def encode_frame_header(prefs: FramePreferences) -> bytes:
    """Magic + FLG/BD(/content size) + header checksum byte."""
    flg = spec.FLG_VERSION << 6
    if prefs.block_independent:
        flg |= 1 << 5
    if prefs.block_checksum:
        flg |= 1 << 4
    if prefs.content_size is not None:
        flg |= 1 << 3
    if prefs.content_checksum:
        flg |= 1 << 2
    desc = bytes([flg, prefs.resolved_bsid() << 4])
    if prefs.content_size is not None:
        desc += struct.pack("<Q", prefs.content_size)
    hc = (xxh32(desc, 0) >> 8) & 0xFF
    return struct.pack("<I", spec.FRAME_MAGIC) + desc + bytes([hc])


def decode_frame_header(data: bytes) -> FrameInfo:
    """Parse and validate a frame header; ``data`` holds the whole header."""
    if len(data) < spec.MIN_FRAME_HEADER_SIZE:
        raise Lz4FrameError("frame header too small")
    magic = struct.unpack_from("<I", data)[0]
    if magic != spec.FRAME_MAGIC:
        raise Lz4FrameError(f"bad magic {magic:#x}")
    flg, bd = data[4], data[5]
    if (flg >> 6) != spec.FLG_VERSION:
        raise Lz4FrameError("unsupported frame version")
    if flg & 0b11:
        raise Lz4FrameError("reserved FLG bits set")
    if bd & 0b10001111:
        raise Lz4FrameError("reserved BD bits set")
    info = FrameInfo(
        block_size_id=(bd >> 4) & 0b111,
        block_independent=bool(flg & (1 << 5)),
        block_checksum=bool(flg & (1 << 4)),
        content_checksum=bool(flg & (1 << 2)),
    )
    if info.block_size_id not in spec.BLOCK_SIZES:
        raise Lz4FrameError(f"invalid block size id {info.block_size_id}")
    pos = 6
    if flg & (1 << 3):
        if len(data) < pos + 9:
            raise Lz4FrameError("frame header too small for content size")
        info.content_size = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
    hc = (xxh32(data[4:pos], 0) >> 8) & 0xFF
    if data[pos] != hc:
        raise Lz4FrameError("header checksum mismatch")
    info.header_size = pos + 1
    return info


def header_size_hint(prefix: bytes) -> int:
    """How many bytes the whole header takes, from at least 6 of its first
    bytes (else the minimum).  Parity: LZ4F_headerSize."""
    if len(prefix) < 6:
        return spec.MIN_FRAME_HEADER_SIZE
    return spec.MIN_FRAME_HEADER_SIZE + (8 if prefix[4] & (1 << 3) else 0)


def get_frame_info(prefix: bytes) -> FrameInfo:
    """Parity: LZ4F_getFrameInfo."""
    return decode_frame_header(prefix)


# FrameDecompressor: blocks up to this size decode through kernel D (batch
# mode, or linked mode behind a window on the device), larger ones through
# kernel E, whose parse spreads a block over the card (smoke step 15 times
# both routes)
D_MAX_BLOCK = 1 << 16


def _device():
    """The device module, imported on first use (it imports this one)."""
    from . import device
    return device


def _hc():
    """The HC module, imported on first use (it imports the device
    module)."""
    from . import hc
    return hc


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

class FrameCompressor:
    """Incremental frame compression with the block work on the device.

    Parity with ``LZ4F_compressBegin/Update/flush/End`` as ``lz4_tpu`` has
    them: partial blocks are buffered, whole blocks emitted, ``auto_flush``
    emits the remainder at every ``update``, incompressible blocks are
    stored, and an embedded content size is checked at ``end()``.  No state
    moves until a call's blocks are coded and fetched: a call that raises
    leaves the compressor as it was."""

    def __init__(self, prefs: Optional[FramePreferences] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.prefs = dataclasses.replace(prefs) if prefs \
            else FramePreferences()
        self._block_size = spec.BLOCK_SIZES[self.prefs.resolved_bsid()]
        self._buf = b""          # pending (unemitted) plaintext
        self._window = None      # last <= 64 KB emitted, on the device
        self._xxh = XXH32State(0)
        self._total_in = 0
        self._begun = False
        self._ended = False

    def begin(self) -> bytes:
        if self._begun:
            raise Lz4FrameError("begin() called twice")
        self._begun = True
        return encode_frame_header(self.prefs)

    def _encode(self, data: bytes):
        """The records of ``data`` cut into blocks (all whole but the
        last), and the window after them; changes no state."""
        dev, p, bs = _device(), self.prefs, self._block_size
        linked = not p.block_independent
        if p.level >= 3:
            groups, window = _hc().hc_payloads(data, bs, self._window, linked,
                                               p.level, self.device)
            records = dev.joined_records(data, bs, groups, p.block_checksum)
        elif not linked and bs <= MAX_BLOCK:
            rows, lens = dev.byte_rows(dev._split_blocks(data, bs), bs,
                                       self.device)
            out, olen = dev.encode_blocks(rows, lens, p.acceleration)
            flat, total, _ = dev.pack_frame_payloads(out, olen, rows, lens)
            return dev._fetch_body(flat, total, p.block_checksum), None
        else:
            records, window = dev.chain_records(
                data, bs, self._window, linked, p.acceleration,
                block_checksum=p.block_checksum, device=self.device)
        return records, (window if linked else None)

    def _emit(self, data: bytes, rest: bytes, taken: bytes) -> bytes:
        """Code ``data``, then account ``taken`` as input and keep
        ``rest`` buffered."""
        out, window = self._encode(data) if data else (b"", self._window)
        self._buf = rest
        self._window = window
        self._total_in += len(taken)
        if self.prefs.content_checksum and taken:
            self._xxh.update(taken)
        return out

    def update(self, data: bytes) -> bytes:
        if not self._begun or self._ended:
            raise Lz4FrameError("update() outside begin/end")
        data = bytes(data)
        buf = self._buf + data
        whole = len(buf) // self._block_size * self._block_size
        if self.prefs.auto_flush:
            whole = len(buf)
        return self._emit(buf[:whole], buf[whole:], data)

    def flush(self) -> bytes:
        """Emit any buffered partial block.  Parity: LZ4F_flush."""
        if not self._buf:
            return b""
        return self._emit(self._buf, b"", b"")

    def end(self) -> bytes:
        """Flush, endmark, and the content checksum when asked.  Parity:
        LZ4F_compressEnd."""
        if self._ended:
            raise Lz4FrameError("end() called twice")
        out = [self.flush(), struct.pack("<I", 0)]
        if self.prefs.content_checksum:
            out.append(struct.pack("<I", self._xxh.digest()))
        self._ended = True
        if (self.prefs.content_size is not None
                and self.prefs.content_size != self._total_in):
            raise Lz4FrameError("content size mismatch at end()"
                                f" ({self._total_in} != "
                                f"{self.prefs.content_size})")
        return b"".join(out)


def compress_frame(data: bytes, prefs: Optional[FramePreferences] = None,
                   device="cuda") -> bytes:
    """One-shot frame compression through ``FrameCompressor`` (parity:
    LZ4F_compressFrame; a frame that fits one block is made
    block-independent, as ``lz4_tpu`` does)."""
    prefs = dataclasses.replace(prefs) if prefs else FramePreferences()
    if prefs.content_size is not None and prefs.content_size != len(data):
        raise Lz4FrameError("content_size does not match data")
    if len(data) <= spec.BLOCK_SIZES[prefs.resolved_bsid()]:
        prefs.block_independent = True
    c = FrameCompressor(prefs, device)
    return c.begin() + c.update(data) + c.end()


def compress_frame_bound(src_size: int,
                         prefs: Optional[FramePreferences] = None) -> int:
    """Worst-case frame size.  Parity: LZ4F_compressFrameBound."""
    prefs = prefs or FramePreferences()
    bsize = spec.BLOCK_SIZES[prefs.resolved_bsid()]
    nblocks = max(1, -(-src_size // bsize))
    per_block = spec.BLOCK_HEADER_SIZE + (4 if prefs.block_checksum else 0)
    return (spec.MAX_FRAME_HEADER_SIZE + src_size + nblocks * per_block
            + bsize + spec.ENDMARK_SIZE + 4)


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

class FrameDecompressor:
    """Resumable frame decoder: feed any slices of input, collect output.

    Parity with ``lz4_tpu.frame.FrameDecompressor`` (the LZ4F_decompress
    state machine): ``feed`` never reads past what it needs and returns
    the bytes it consumed with the bytes it decoded; ``src_hint`` says how
    many bytes it wants next; ``finished`` flips once the whole frame
    (suffix included) is consumed; skippable frames are skipped when
    ``skip_skippable``.  The blocks one ``feed`` completes are decoded
    together, on the device, before it returns."""

    def __init__(self, skip_skippable: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self._skip_skippable = skip_skippable
        self.reset()

    def reset(self) -> None:
        self._stage = "magic"
        self._need = 4
        self._acc = bytearray()      # staging for the current unit
        self._window = b""           # last <= 64 KB decoded (linked)
        self._xxh = XXH32State(0)
        self.info: Optional[FrameInfo] = None
        self.finished = False
        self._block_len = 0
        self._block_stored = False
        self._skip_left = 0
        self._total_out = 0
        self._pending: List[Tuple[bytes, bool]] = []  # blocks to decode

    @property
    def src_hint(self) -> int:
        """How many more input bytes are wanted (0 when finished)."""
        if self.finished:
            return 0
        if self._stage == "skip_body":
            return self._skip_left
        return max(1, self._need - len(self._acc))

    def feed(self, chunk: bytes) -> Tuple[int, bytes]:
        """Consume from ``chunk``; return (bytes consumed, output bytes)."""
        if self.finished:
            return 0, b""
        chunk = bytes(chunk)
        pos = 0
        out: List[bytes] = []
        try:
            while pos < len(chunk) and not self.finished:
                if self._stage == "skip_body":
                    take = min(self._skip_left, len(chunk) - pos)
                    pos += take
                    self._skip_left -= take
                    if self._skip_left == 0:
                        self._stage, self._need = "magic", 4
                        self._acc.clear()
                    continue
                take = min(self._need - len(self._acc), len(chunk) - pos)
                if not self._acc and take == self._need:
                    unit = chunk[pos:pos + take]
                else:
                    self._acc += chunk[pos:pos + take]
                    if len(self._acc) < self._need:
                        pos += take
                        break
                    unit = bytes(self._acc)
                    self._acc.clear()
                pos += take
                self._advance(unit, out)
        except Lz4FrameError:
            self._decode_pending(out)   # an earlier block's error first
            raise
        self._decode_pending(out)
        return pos, b"".join(out)

    # -- the pending blocks ----------------------------------------------------
    def _decode_pending(self, out: List[bytes]) -> None:
        """Decode the blocks queued since the last call, in one launch, and
        append their bytes to ``out``."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        info = self.info
        small = info.block_size <= D_MAX_BLOCK
        if info.block_independent:
            parts = self._batch(pending) if small else self._stream(pending)
        else:
            parts = (small and self._linked(pending)) or self._stream(pending)
            keep, n = [], 0
            for piece in reversed(parts):
                keep.append(piece)
                n += len(piece)
                if n >= spec.WINDOW_SIZE:
                    break
            self._window = (self._window + b"".join(reversed(keep)))[
                -spec.WINDOW_SIZE:]
        for piece in parts:
            if info.content_checksum:
                self._xxh.update(piece)
            self._total_out += len(piece)
            out.append(piece)

    def _batch(self, pending) -> List[bytes]:
        """Independent blocks: the compressed ones through kernel D's batch
        mode, one row each; stored blocks as they are."""
        dev = _device()
        todo = [i for i, (_, st) in enumerate(pending) if not st]
        decoded = {}
        if todo:
            rows, lens = dev.byte_rows(
                [pending[i][0] for i in todo],
                max(len(pending[i][0]) for i in todo), self.device)
            res, olen = dev.decode_blocks(rows, lens, self.info.block_size)
            olen = dev.to_host(olen)
            bad = np.nonzero(olen < 0)[0]
            if len(bad):
                self._fail(pending[todo[bad[0]]][0], 0)
            res = dev.to_host(res[:, :int(olen.max(initial=0))])
            decoded = {i: res[k, :olen[k]].tobytes()
                       for k, i in enumerate(todo)}
        return [decoded[i] if i in decoded else p
                for i, (p, _) in enumerate(pending)]

    def _linked(self, pending) -> Optional[List[bytes]]:
        """Linked blocks through kernel D's linked mode, the window as block
        0's (stored blocks as literal-only blocks); None when a block fails
        or a block before the last decodes short, since the blocks after it
        then need a window that spans several blocks."""
        dev, bs = _device(), self.info.block_size
        payloads = [dev._literal_block(p) if st else p for p, st in pending]
        rows, lens = dev.byte_rows(payloads, max(map(len, payloads)),
                                   self.device)
        window = torch.zeros((bs,), dtype=torch.uint8, device=self.device)
        if self._window:
            window[bs - len(self._window):] = dev.to_device(self._window,
                                                            self.device)
        res, olen = dev.decode_blocks_linked(
            rows, lens, bs, init_window=window,
            init_window_len=len(self._window))
        olen = dev.to_host(olen)
        if (olen < 0).any() or (olen[:-1] != bs).any():
            return None
        res = dev.to_host(res)
        return [res[k, :n].tobytes() for k, n in enumerate(olen.tolist())]

    def _stream(self, pending) -> List[bytes]:
        """The blocks through kernel E (``device.decode_stream_runs``), in
        linked mode behind the window for a linked frame."""
        dev, bs = _device(), self.info.block_size
        linked = not self.info.block_independent
        window = self._window if linked else b""
        payloads = [p for p, _ in pending]
        sizes = [len(p) for p in payloads]
        content, olen = dev.decode_stream_runs(
            b"".join(payloads), np.cumsum([0] + sizes)[:-1].tolist(), sizes,
            [st for _, st in pending],
            [len(p) if st else bs for p, st in pending], bs, linked,
            self.device, window=window)
        bad = np.nonzero(olen < 0)[0]
        if len(bad):
            # an independent block has no history before it
            self._fail(payloads[bad[0]], min(
                spec.WINDOW_SIZE, len(window) + int(olen[:bad[0]].sum()))
                if linked else 0)
        parts, at = [], 0
        for n in olen.tolist():
            parts.append(content[at:at + n])
            at += n
        return parts

    def _fail(self, payload: bytes, nd: int) -> None:
        """Raise lz4_tpu's error for a block the kernel rejected: the walk
        over its lengths gives the message."""
        block = _block_module()
        try:
            block.walk_safe(payload, self.info.block_size, nd)
        except block.Lz4BlockError as e:
            raise Lz4FrameError(f"block decode failed: {e}") from e
        raise Lz4FrameError("block decode failed: the device decoder "
                            "rejected the block")

    # -- state transitions -----------------------------------------------------
    def _advance(self, unit: bytes, out: List[bytes]) -> None:
        stage = self._stage
        if stage == "magic":
            magic = struct.unpack("<I", unit)[0]
            if magic == spec.FRAME_MAGIC:
                self._stage, self._need = "flg", 2
                self._hdr = unit
            elif ((magic & spec.SKIPPABLE_MAGIC_MASK)
                  == spec.SKIPPABLE_MAGIC_MIN and self._skip_skippable):
                self._stage, self._need = "skip_size", 4
            else:
                raise Lz4FrameError(f"bad magic {magic:#x}")
        elif stage == "skip_size":
            self._skip_left = struct.unpack("<I", unit)[0]
            if self._skip_left == 0:
                self._stage, self._need = "magic", 4
            else:
                self._stage = "skip_body"
        elif stage == "flg":
            self._hdr += unit
            self._stage = "hdr_rest"
            self._need = header_size_hint(self._hdr) - len(self._hdr)
        elif stage == "hdr_rest":
            self._hdr += unit
            self.info = decode_frame_header(self._hdr)
            self._window = b""
            self._xxh = XXH32State(0)
            self._stage, self._need = "block_header", 4
        elif stage == "block_header":
            raw = struct.unpack("<I", unit)[0]
            if raw == 0:  # endmark
                if self.info.content_checksum:
                    self._stage, self._need = "content_checksum", 4
                else:
                    self._finish_frame(out)
                return
            self._block_stored = bool(raw & spec.UNCOMPRESSED_BIT)
            self._block_len = raw & ~spec.UNCOMPRESSED_BIT
            if (self._block_len > self.info.block_size
                    and not self._block_stored):
                raise Lz4FrameError("block larger than block maximum size")
            self._stage = "block_body"
            self._need = self._block_len + (4 if self.info.block_checksum
                                            else 0)
        elif stage == "block_body":
            payload = unit[:self._block_len]
            if self.info.block_checksum:
                want = struct.unpack("<I", unit[self._block_len:])[0]
                if xxh32(payload, 0) != want:
                    raise Lz4FrameError("block checksum mismatch")
            self._pending.append((payload, self._block_stored))
            self._stage, self._need = "block_header", 4
        elif stage == "content_checksum":
            self._decode_pending(out)
            if self._xxh.digest() != struct.unpack("<I", unit)[0]:
                raise Lz4FrameError("content checksum mismatch")
            self._finish_frame(out)
        else:
            raise AssertionError(f"bad stage {stage}")

    def _finish_frame(self, out: List[bytes]) -> None:
        self._decode_pending(out)
        if (self.info.content_size is not None
                and self.info.content_size != self._total_out):
            raise Lz4FrameError("frame content size mismatch")
        self.finished = True


def _block_module():
    from . import block
    return block


def decompress_frame(data: bytes, device="cuda") -> Tuple[bytes, int]:
    """Decode one frame from ``data`` through ``FrameDecompressor``;
    returns (content, bytes consumed)."""
    d = FrameDecompressor(device=device)
    consumed, out = d.feed(data)
    if not d.finished:
        raise Lz4FrameError("truncated frame")
    return out, consumed


def decompress_concatenated(data: bytes, device="cuda") -> bytes:
    """Decode a sequence of concatenated frames (skippable ones skipped)."""
    out = []
    pos = 0
    while pos < len(data):
        content, used = decompress_frame(data[pos:], device)
        out.append(content)
        pos += used
    return b"".join(out)


def make_skippable_frame(user_data: bytes, sub_id: int = 0) -> bytes:
    if not 0 <= sub_id <= 15:
        raise Lz4FrameError("skippable sub id out of range")
    return (struct.pack("<I", spec.SKIPPABLE_MAGIC_MIN + sub_id)
            + struct.pack("<I", len(user_data)) + user_data)


def compress_legacy(data: bytes, acceleration: int = 1, level: int = 0,
                    device="cuda") -> bytes:
    """Legacy frame (magic 0x184C2102, 8 MB independent always-compressed
    blocks): ``device.compress_legacy_device``."""
    return _device().compress_legacy_device(
        bytes(data), level=level, acceleration=acceleration, device=device)


def decompress_legacy(data: bytes, device="cuda") -> Tuple[bytes, int]:
    """Decode a legacy frame up to the end of the input or the next magic;
    returns (content, bytes consumed): ``device.decompress_legacy_device``."""
    return _device().decompress_legacy_device(bytes(data), device=device)
