"""A plain LZ4 frame parser and block decoder in NumPy.

Written from the LZ4 Frame format description (v1.6.x) and the LZ4 Block
format description, and from nothing of the codec under test.

``check_frame(frame, expect, content)`` reads one frame and returns a
``FrameCheck``: whether its header states what the configuration asks for
(``expect``: the block size id, block independence, block and content
checksums, content size) and carries the right header checksum byte; how
many blocks break the block format (lengths, sequences, offsets before the
window or the block, the end-of-block rules); whether the end mark is there
with nothing after the frame; the content checksum it stores; and by how
many bytes its blocks fail to decode to ``content``.

The blocks are parsed side by side: one pass of NumPy operations reads the
next sequence of every block at once, so the number of passes is the
largest number of sequences in one block, not in the frame.  A 64 MiB frame
takes a few seconds.  The caller compares the stored checksum with the
XXH32 of ``content`` (``xxh32.xxh32``, seconds per 64 MiB in Python), so
that the two can run in separate processes.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

from .xxh32 import xxh32

FRAME_MAGIC = 0x184D2204
BLOCK_MAX = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
MIN_MATCH = 4
LAST_LITERALS = 5     # the last 5 bytes of a block are literals
MF_LIMIT = 12         # the last match starts 12 bytes or more before the end


@dataclasses.dataclass
class FrameCheck:
    header_bad: int = 0          # 1: the header breaks the format or expect
    blocks_bad: int = 0          # blocks that break the block format
    tail_bad: int = 0            # 1: no end mark or checksum, or bytes after
    bytes_wrong: int = 0         # bytes that do not decode to the content
    checksum: Optional[int] = None         # the stored content checksum
    notes: List[str] = dataclasses.field(default_factory=list)

    def note(self, text: str) -> None:
        if len(self.notes) < 8:
            self.notes.append(text)


def check_frame(frame, expect: dict, content) -> FrameCheck:
    """Parse one LZ4 frame that should fill ``frame`` exactly and hold
    ``content`` (a buffer).

    ``expect`` holds ``block_size_id``, ``block_independent``,
    ``block_checksum``, ``content_checksum`` and ``content_size`` (a bool:
    whether the header carries the content size)."""
    buf = np.frombuffer(frame, dtype=np.uint8)
    target = np.frombuffer(content, dtype=np.uint8)
    out = FrameCheck(bytes_wrong=len(target))
    n = len(buf)
    if n < 7 or struct.unpack_from("<I", frame, 0)[0] != FRAME_MAGIC:
        out.header_bad = 1
        out.note("no frame magic")
        return out
    flg, bd = int(buf[4]), int(buf[5])
    version, indep = flg >> 6, bool(flg & 0x20)
    bsum, csize, csum, dictid = (bool(flg & 0x10), bool(flg & 0x08),
                                 bool(flg & 0x04), bool(flg & 0x01))
    bsid = (bd >> 4) & 7
    pos = 6 + 8 * csize + 4 * dictid
    if pos + 1 > n:
        out.header_bad = 1
        out.note("truncated header")
        return out
    if version != 1 or flg & 0x02 or bd & 0x8F or bsid not in BLOCK_MAX:
        out.header_bad = 1
        out.note(f"reserved bits or version: FLG {flg:#x} BD {bd:#x}")
        return out
    if (xxh32(frame[4:pos]) >> 8) & 0xFF != buf[pos]:
        out.header_bad = 1
        out.note("header checksum byte")
    stated = dict(block_size_id=bsid, block_independent=indep,
                  block_checksum=bsum, content_checksum=csum,
                  content_size=csize)
    for key, want in expect.items():
        if stated[key] != want:
            out.header_bad = 1
            out.note(f"header {key}={stated[key]}, expected {want}")
    if dictid:
        out.header_bad = 1
        out.note("dictionary id set")
    pos += 1

    block_max = BLOCK_MAX[bsid]
    starts, sizes, stored = [], [], []
    ended = False
    while pos + 4 <= n:
        word = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if word == 0:
            ended = True
            break
        size = word & 0x7FFFFFFF
        if size > block_max or pos + size + 4 * bsum > n:
            out.blocks_bad += 1
            out.note(f"block {len(starts)}: length {size}")
            break
        starts.append(pos)
        sizes.append(size)
        stored.append(bool(word >> 31))
        pos += size
        if bsum:
            if xxh32(frame[pos - size:pos]) != \
                    struct.unpack_from("<I", frame, pos)[0]:
                out.blocks_bad += 1
                out.note(f"block {len(starts) - 1}: block checksum")
            pos += 4
    if not ended:
        out.tail_bad = 1
        out.note("no end mark")
    bad, out.bytes_wrong = derive_blocks(buf, starts, sizes, stored,
                                         block_max, indep, target)
    out.blocks_bad += bad
    if bad:
        out.note(f"{bad} blocks break the block format")
    elif out.bytes_wrong:
        out.note(f"{out.bytes_wrong} bytes do not decode to the content")
    if csum:
        if pos + 4 > n:
            out.tail_bad = 1
            out.note("no content checksum")
        else:
            out.checksum = struct.unpack_from("<I", frame, pos)[0]
            pos += 4
    if csize and struct.unpack_from("<Q", frame, 6)[0] != len(target):
        out.header_bad = 1
        out.note("content size")
    if ended and pos != n:
        out.tail_bad = 1
        out.note(f"{n - pos} bytes after the frame")
    return out


def _read_length(buf, p, ends, length, more):
    """Add LZ4's extension bytes (a run of 255s and one byte below 255)
    to ``length`` where ``more``; returns (p, length, overrun)."""
    over = np.zeros(len(p), dtype=bool)
    more = more.copy()
    while more.any():
        i = np.nonzero(more)[0]
        run_over = p[i] >= ends[i]
        over[i[run_over]] = True
        more[i[run_over]] = False
        i = i[~run_over]
        b = buf[p[i]].astype(np.int64)
        length[i] += b
        p[i] += 1
        more[i] = b == 255
    return p, length, over


def _parse(buf, starts, ends):
    """Every block's sequences, all blocks a pass at a time.  Returns
    (block, literal start, literal length, offset, match length) per
    sequence in block order, and a bad flag per block.  The last sequence
    of a block has no match (offset and match length 0)."""
    nb = len(starts)
    ip = starts.copy()
    bad = np.zeros(nb, dtype=bool)
    active = np.arange(nb)
    cols = [[], [], [], [], []]
    while len(active):
        p, e = ip[active], ends[active]
        empty = p >= e                  # a block that ends after a match
        bad[active[empty]] = True
        keep = ~empty
        active, p, e = active[keep], p[keep], e[keep]
        if not len(active):
            break
        tok = buf[p].astype(np.int64)
        p += 1
        lit_len = tok >> 4
        p, lit_len, over = _read_length(buf, p, e, lit_len, lit_len == 15)
        lit = p.copy()
        p += lit_len
        over |= p > e
        last = (p == e) & ~over
        need = ~last & ~over
        over |= need & (p + 2 > e)
        need &= ~over
        off = np.zeros(len(p), dtype=np.int64)
        q = np.minimum(p, len(buf) - 2)
        off[need] = (buf[q[need]].astype(np.int64)
                     | buf[q[need] + 1].astype(np.int64) << 8)
        p[need] += 2
        mlen = np.where(need, tok & 15, 0)
        p, mlen, mover = _read_length(buf, p, e, mlen, need & (mlen == 15))
        over |= mover
        mlen = np.where(need & ~mover, mlen + MIN_MATCH, 0)
        bad[active[over]] = True
        good = ~over
        for col, val in zip(cols, (active, lit, lit_len, off, mlen)):
            col.append(val[good])
        ip[active] = p
        active = active[good & ~last]
    blk, lit, lit_len, off, mlen = (np.concatenate(c) if c else
                                    np.zeros(0, np.int64) for c in cols)
    order = np.argsort(blk, kind="stable")
    return (blk[order], lit[order], lit_len[order], off[order],
            mlen[order], bad)


def _ranges(starts, lengths):
    """The concatenation of range(s, s + n) for each (s, n)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lengths)
    return (np.arange(total, dtype=np.int64)
            + np.repeat(starts - (ends - lengths), lengths))


def derive_blocks(buf, starts, sizes, stored, block_max: int,
                  independent: bool, content: np.ndarray):
    """Check that a frame's blocks (``buf`` the frame as uint8) decode to
    ``content``.  Returns (bad blocks, bytes wrong).

    Each output byte is derived from the frame: a literal from its byte in
    the frame, a match byte from the output byte ``offset`` before it.  A
    byte is counted wrong where its derivation, taken over ``content``,
    disagrees with ``content``: a decoder writes the first wrong byte
    exactly where the first such derivation lies, so the blocks decode to
    ``content`` if and only if no byte is wrong and the lengths agree (a
    length apart counts its difference).  One pass over the bytes, where a
    decoder would need one per link of a chain of copies."""
    if not starts:
        return 0, len(content)
    starts = np.asarray(starts, np.int64)
    sizes = np.asarray(sizes, np.int64)
    stored = np.asarray(stored, bool)
    nb = len(starts)
    comp = np.nonzero(~stored)[0]
    blk, lit, lit_len, off, mlen, bad_c = _parse(
        buf, starts[comp], starts[comp] + sizes[comp])
    bad = np.zeros(nb, dtype=bool)
    bad[comp] = bad_c
    # a stored block is one literal run
    sblk = np.nonzero(stored)[0]
    blk = np.concatenate([comp[blk], sblk])
    lit = np.concatenate([lit, starts[sblk]])
    lit_len = np.concatenate([lit_len, sizes[sblk]])
    off = np.concatenate([off, np.zeros(len(sblk), np.int64)])
    mlen = np.concatenate([mlen, np.zeros(len(sblk), np.int64)])
    order = np.argsort(blk, kind="stable")
    blk, lit, lit_len, off, mlen = (a[order] for a in
                                    (blk, lit, lit_len, off, mlen))

    seq_len = lit_len + mlen
    block_len = np.bincount(blk, weights=seq_len, minlength=nb
                            ).astype(np.int64)
    bad |= block_len > block_max
    block_start = np.cumsum(block_len) - block_len
    seq_start = np.cumsum(seq_len) - seq_len          # global output offset
    match_at = seq_start + lit_len                    # global match start
    in_block = match_at - block_start[blk]
    lo = block_start[blk] if independent else np.zeros_like(blk)
    has = mlen > 0
    wrong = has & ((off < 1) | (match_at - off < lo)
                   | (in_block + MF_LIMIT > block_len[blk])
                   | (in_block + mlen + LAST_LITERALS > block_len[blk]))
    bad[blk[wrong]] = True
    if bad.any():
        return int(bad.sum()), len(content)

    n = len(content)
    total = int(block_len.sum())
    dest = _ranges(seq_start, lit_len)
    src = _ranges(lit, lit_len)
    keep = dest < n
    wrong = int(np.count_nonzero(content[dest[keep]] != buf[src[keep]]))
    del dest, src, keep
    dest = _ranges(match_at, mlen)
    dest = dest[dest < n]
    wrong += int(np.count_nonzero(
        content[dest] != content[dest - np.repeat(off, mlen)[:len(dest)]]))
    return 0, wrong + abs(total - n)
