"""LZ4F frame header codec (spec v1.5.1) for the PyTorch/CUDA port.

Counterpart of the header half of ``lz4_tpu/frame.py``.  Only the header
encode/decode lives here; the block walk of a frame is in
``lz4_tpu_torch.device``, where every block is coded on the device.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

from . import spec
from .ops.xxhash import xxh32


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
