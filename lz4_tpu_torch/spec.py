"""LZ4 wire-format constants used by the PyTorch/CUDA port.

Counterpart of ``lz4_tpu/spec.py``: only format facts (the public LZ4 block
and frame specifications), no algorithm state.
"""

# Block format (lz4_Block_format.md)
MINMATCH = 4                 # shortest match a token encodes (low nibble 0)
ML_BITS = 4                  # match-length bits of a token
ML_MASK = (1 << ML_BITS) - 1  # 15
RUN_BITS = 8 - ML_BITS       # literal-length bits of a token
RUN_MASK = (1 << RUN_BITS) - 1  # 15
MAX_DISTANCE = 65535         # largest match offset (2 bytes LE; 0 is invalid)
# parsing restrictions: a block ends with at least 5 literals, and its last
# match starts at least 12 bytes before its end
LASTLITERALS = 5
MFLIMIT = 12
LZ4_MINLENGTH = MFLIMIT + 1  # blocks shorter than 13 bytes are all literals


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
MAX_FRAME_HEADER_SIZE = 15   # + 8-byte content size
BLOCK_HEADER_SIZE = 4        # LE32 block size
ENDMARK_SIZE = 4             # LE32 zero
UNCOMPRESSED_BIT = 0x80000000  # high bit of a block size: stored, not compressed

# BD byte block-max-size IDs -> byte sizes
BLOCK_SIZES = {4: 64 * 1024, 5: 256 * 1024, 6: 1024 * 1024, 7: 4 * 1024 * 1024}
DEFAULT_BLOCK_SIZE_ID = 7
LEGACY_BLOCK_SIZE = 8 * 1024 * 1024   # legacy frames: fixed 8MB blocks

# LZ4 streaming window
WINDOW_SIZE = 64 * 1024

# Scatter-gather conventions (the LZ4_SG fork, lib/lz4sg.c and lz4sg.h)
SG_FRAME_HEADER_SIZE = 15    # magic + FLG + BD + 8-byte content size + HC
SG_MAX_BLOCK_SIZE = 4 * 1024 * 1024   # every SG block is at most 4 MB
SG_MIN_OUT_BUF = 10          # every output buffer holds at least 10 bytes
# the first output buffer holds the header, a block header and 2 bytes
SG_MIN_FIRST_OUT = SG_FRAME_HEADER_SIZE + BLOCK_HEADER_SIZE + 2

# Error codes of the scatter-gather layer (negative ints, the fork's
# convention)
SG_OK = 0
SG_ERR_PARAM = -1
SG_ERR_OUT_SPACE = -2
SG_ERR_MAGIC = -3
SG_ERR_CONTENT_CHECKSUM = -4
SG_ERR_BLOCK_CHECKSUM = -5
SG_ERR_NO_CONTENT_SIZE = -6
SG_ERR_BLOCK_INDEP = -7


def optimal_block_size_id(block_size_hint: int) -> int:
    """Smallest standard block-size ID whose size >= hint (min 64KB)."""
    for bsid in (4, 5, 6, 7):
        if block_size_hint <= BLOCK_SIZES[bsid]:
            return bsid
    return 7
