"""LZ4 wire-format constants used by the PyTorch/CUDA port.

Counterpart of ``lz4_tpu/spec.py``: only format facts (the public LZ4 block
and frame specifications), no algorithm state.
"""


def compress_bound(n: int) -> int:
    """Largest compressed size of an ``n``-byte block (0 if n is too large)."""
    if n > 0x7E000000:
        return 0
    return n + n // 255 + 16


# Frame format (lz4_Frame_format.md, spec v1.5.1)
FRAME_MAGIC = 0x184D2204
LEGACY_MAGIC = 0x184C2102
SKIPPABLE_MAGIC_MIN = 0x184D2A50   # 0x184D2A50 .. 0x184D2A5F all valid
SKIPPABLE_MAGIC_MASK = 0xFFFFFFF0
FLG_VERSION = 0b01           # 2-bit version field, must be 01
MIN_FRAME_HEADER_SIZE = 7    # magic + FLG + BD + HC
UNCOMPRESSED_BIT = 0x80000000  # high bit of a block size: stored, not compressed

# BD byte block-max-size IDs -> byte sizes
BLOCK_SIZES = {4: 64 * 1024, 5: 256 * 1024, 6: 1024 * 1024, 7: 4 * 1024 * 1024}
DEFAULT_BLOCK_SIZE_ID = 7
LEGACY_BLOCK_SIZE = 8 * 1024 * 1024   # legacy frames: fixed 8MB blocks

# LZ4 streaming window
WINDOW_SIZE = 64 * 1024


def optimal_block_size_id(block_size_hint: int) -> int:
    """Smallest standard block-size ID whose size >= hint (min 64KB)."""
    for bsid in (4, 5, 6, 7):
        if block_size_hint <= BLOCK_SIZES[bsid]:
            return bsid
    return 7
