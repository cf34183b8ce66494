#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lz4_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --encode-times ROOT   # kernels A and B of ROOT only
    python3 chip_smoke.py --destsize-times ROOT # kernels G and H of ROOT only
    python3 chip_smoke.py --decode-times ROOT   # kernels E, F, D of ROOT
    python3 chip_smoke.py --hc-times ROOT       # kernels I and C of ROOT
                                                # (I behind prefixes too)
    python3 chip_smoke.py --xxh-times ROOT      # kernels J and K of ROOT
    python3 chip_smoke.py --parallel-only       # steps 13 and 14 alone
    python3 chip_smoke.py --landing-only        # step 20 alone

1. Checks for a card and prints its name and power limit.
2. Builds the kernels from lz4_tpu_torch/csrc (nvcc, sm_90a).
3. Holds every kernel against its plain PyTorch/Python version on the same
   inputs, byte for byte (tolerance 0: a codec's outputs are integers), at
   the main path's shapes, and times both.  Kernel A is also held and timed
   on 4 MB chunks of zeros, of one 7-byte period, of random bytes and of
   the stdlib's charmap codec tables, and
   kernel B on 256 KB rows (the -B5 split of the corpus, a short row,
   zeros, one 7-byte period, noise), both also in groups of a few rows
   (their scratch cut small), and
   the profiler splits A's, B's and C's time per kernel launch (A and B run
   three: probe, walk, emit; C two: its bookkeeping, then the copy).  Kernel
   C is held on kernel A's 64-block chunk, a stored block with a padding
   row and HC's 1,024-row group; its wrapper must make no host sync (under
   torch.cuda.set_sync_debug_mode("error")), and a length past its row must
   raise ValueError when the total is read and write nothing.  Kernel D's linked mode is held
   against its plain version on kernel A's 64-block chunk with and without
   its window, on a 64-block chain of one 7-byte period (every block refers
   into the one before it), on the chunk with a short block at index 20,
   on mixed chains, corrupted streams and noise.  Kernel E (the stream
   decoder) is held against its plain version at every launch step 6 makes
   (the whole -B7, -B5 linked, legacy and flushed files) and on small
   inputs (a 4 MB block, stored blocks, flushed chains with short
   mid-stream blocks, one flushed every 5,000 bytes so that references
   cross up to 13 blocks, a -B5 chain whose first block reaches before the
   stream, D's two chains above, corrupted payloads, noise) in both modes,
   and timed on a 4 MB block in three alternating rounds of the two modes,
   on the 64 MiB -B7 frame and on the whole -B5 linked and flushed chains.
   Kernels G (the SG chain encoder) and F (the SG chain decoder) are held
   against their plain versions on small lists (4 KB, 64 KB and ragged
   iovecs, min_match 8, acceleration 2, small caps that force capacity
   stops and zero-pads, mixed bytes, 5-grams that share one hash slot,
   noise with long skips, min_match 12 with acceleration 7; corrupted
   payloads and noise as SG chains) and at every launch step 7 makes, and
   timed on the '4k' walk and its chain in three rounds each.  Kernel I (the HC encoder) is held
   against its plain version on small rows (text, zeros, noise, periods 2
   and 3, 13-, 12- and 0-byte rows, far repeats) at levels 1, 2, 9, 12 and
   16, on two mixed 64 KB rows at levels 9 and 16, and on sampled rows of
   the corpus batch (1,024 rows of 64 KB) at level 9, each against both
   its plain version (the CPU model of its rounds) and the serial walk over
   the d48 chain table, and on the small text rows at storage offsets 1, 2
   and 3; its tables (perm and slot: one stable sort per row) built on the
   card must equal the CPU's; it is timed on the whole batch in
   three rounds, with the tables' time and peak memory beside it.  Kernel H
   (the destSize encoder) is held against its plain version on small rows
   (text, zeros, noise, mixed bytes, rows of 0, 12 and 13 bytes) at caps 1,
   2, 5, 6, 10, 17, n/2 and compress_bound(n), behind prefixes of 1 to
   65,536 bytes, at min_match 8 and acceleration 2, on a 256 KB row, on
   66,000 bytes of noise (literal runs past the int32 range of the
   reference's size arithmetic; every block within its cap), on rows of
   5-grams that share one hash slot and 64 KB of noise (long skips), also
   at min_match 12 and acceleration 7, and on sampled
   rows of the two corpus batches of step 9;
   every such block is also decoded by kernel D in batch mode with the
   prefix as its dictionary row, against the plain decoder.  Kernel D's
   resumable mode is held against its plain version on kernel B's 64 rows at
   caps 0 to 65,536, on their resumed rounds (dictionary rows), on an
   offset-0 corruption, a block cut after a match, the corrupted streams,
   noise, and sampled rows of step 9's first round.  Kernel D's batch mode
   is also held on kernel B's payloads of the corpus as 1,024 rows of 64
   KB (every row must be its corpus row, sampled rows the plain version's;
   the shape of a 64 MiB -B4 frame) and timed there.  Kernel D's plain
   versions are the serial decoders.  Kernels J and K are held against
   their plain versions on every length from 0 to 70 (aligned and
   unaligned rows), on ragged rows up to 100,001 bytes at four seeds, on
   rows at storage offsets 1, 2, 3 and 15 (widths 72, 77 and 65,536), at
   lengths one byte either side of one and two tiles of their staging,
   on batches of 1, 7 and 4,097 rows, on one row of 1 MiB beside 63 rows
   of 4 KB, J also against the host XXH32, and on every row of step 9's
   batches (and of 16 MiB of it as rows of 77 bytes).  H, D resumable, J
   and K are timed on step 9's batches, median of three; J and K also on
   256 of its rows resident in the card's L2 (the kernel alone, launched
   through its C entry point: about the per-row chain).  Kernels A and I
   with their ``tails`` on (legacy compress's join) are held against their
   plain versions (payloads and tails) and against themselves with tails
   off, A on two 9-block chains, the main-path chunk and 4 MB of noise, I
   on the small rows at levels 1 and 9 and (tails on against off) on the
   1,024 corpus rows; both are timed with tails on.  Kernel I behind
   prefixes (rows [prefix | source], step 3l) is held against its plain
   version (payloads, olen, tails) and the serial walk at levels 1, 3, 9
   and 16 on ``hc_prefix_cases`` (prefixes of 1 byte, 4 KB, 65,535 bytes
   and of zeros, a repeat at distance 65,535 and one at 65,536, sources of
   0, 12 and 13 bytes, noise; 16- and 32-bit tables; rows at storage
   offsets 1 and 3), on sampled rows of the corpus as 1,024 rows [64 KB |
   64 KB] at levels 3, 9 and 16, and timed on that batch at level 9 (median
   of three) beside the independent rows, with its tables' time and peak.
4. Runs the main path at full size: a 64 MiB real-text corpus (the Python
   stdlib sources, built the way bench.py builds its corpus) through
   compress_frame_device and decompress_frame_device, at min_match=8 /
   reject_step=1 (the bench point), at the default min_match=4, and at
   mm=8 with a content checksum (the lz4 CLI's default frame).  The launch
   counters are reset just before and read just after: kernels A, C and
   linked D must have launched and no plain version may have run.
5. Resets the counters again and runs the smaller entry points: a 4 MB
   one-shot linked frame, a 60 KB input (kernel B), independent frames
   with and without block and content checksums, and the corpus as a -B4
   frame written by io.compress_stream at -1 -B4 (``b4_frame``), decoded
   through decompress_frame_device (1,024 rows in one launch of batch D).
   Kernels A to D, B and batch D included, must launch here, and no plain
   version may run.
6. The stream path, with its own counter reset and read: the corpus as a
   -B7 frame with a content checksum (what ``lz4 file`` writes), a -B5
   linked frame, a legacy file (8 MB blocks), a linked 64 KB-block frame
   with flush() after every third 4 MB update (kernel D finds its short
   blocks and hands the chain to kernel E), the three fixture files, and
   io.decompress_filename on the -B7 file in a temporary directory under
   build/.  Kernels E and linked D must launch, and no plain version run.
   The -B7 and legacy files merge kernel B's 256 KB payloads into 4 MB and
   8 MB blocks (``merge_payloads``): nothing on the card host writes
   larger blocks.
7. The scatter-gather path, with its own counter reset and read: the first
   16 MiB of the corpus as 4 KB iovecs into 4 KB iovecs ('4k'), as ragged
   iovecs ('ragged'), and the first 4 MiB as 256 KB iovecs into one buffer
   ('large', written over kernel B, decoded by kernel E), each through
   lz4_tpu_torch.sg.sg_compress and sg_decompress on the card, byte-exact;
   the '4k' and 'ragged' frames also through decompress_frame_device (every
   SG frame is an LZ4F frame).  Kernels G, F and E must launch, and no
   plain version run.
8. The HC and file-compress path, with its own counter reset and read: the
   corpus written as a file and compressed by io.compress_filename at -9
   (kernel I, then C), -1 (kernel B) and -1 -BD (kernels A and C), each
   decoded by io.decompress_filename (kernels E and linked D) byte-exact,
   with ratio, MB/s, the compress kernel's CUDA-event ms and peak device
   memory; the first 4 MiB through compress_frame_device_hc at levels 3, 9
   and 16 (decoded by batch D); one round trip through
   ``python -m lz4_tpu_torch.cli -9`` and ``-d``.  Kernels I, A, B, C, E and
   both modes of D must launch, and no plain version run.
9. The destSize and checksum path, with its own counter reset and read, on
   the corpus as 1,024 rows of 64 KB: kernel H at cap = max(n // 2, 64),
   every block decoded by kernel D (batch mode, out_caps = consumed) to
   exactly row[:consumed]; H behind a prefix (rows [block i-1 | block i],
   cap = n // 2), decoded with block i-1 as the dictionary row, consuming no
   less than without the prefix; kernel B's payloads of the rows decoded by
   kernel D's resumable mode at out_caps = 32,768 and resumed, round after
   round, with comp[cons:] and the bytes produced as dictionary rows, until
   the joined pieces are the corpus; XXH32 and XXH64 of the 1,024 rows and
   of the first 16 MiB as 4,096 rows of 4 KB, J equal to the host XXH32 and
   K to its plain version on every row; the first 4 MiB as 128 KB iovecs
   into 32 KB buffers through sg.sg_compress with kernel H as its destSize
   compressor, and back through sg.sg_decompress (kernel E); and
   examples/torch_port/dest_size_resume_torch.py.  Kernels H, B, D in both
   batch variants, J, K and E must launch, and no plain version run.
10. Legacy compress, with its own counter reset and read: the corpus
   through io.compress_stream at -l -1 (kernel A, 8 MB slices as linked
   chains, payloads joined from their tails) and -l -9 (kernel I), each
   decoded by decompress_legacy_device (kernel E) byte-exact, with ratio
   and walls.  Kernels A, I and E must launch, and no plain version run.
11. The single-card envelope, with its own counter reset and read: a -B7
   independent frame and a -B7 linked frame of just over 2 GiB of raw
   bytes (500 stored 4 MB noise blocks, the corpus's 4 MB blocks four
   times, 20 more noise blocks; the linked frame's text blocks from the
   main path's chain, so that the block after kernel E's cut reaches into
   the block before it) through decompress_frame_device, against the
   content rebuilt on the host; an SG walk of a partial source (3 MiB of
   4 MiB) over kernel H, round-tripped; the 4 MiB walk with MAX_TOTAL
   patched to 1 MiB (over H), equal to the explicit H callback's frame;
   the '4k' chain decoded with MAX_DEVICE_CONTENT and STREAM_MAX_INPUT
   patched down (kernel E in runs), equal to kernel F's answer.  Kernels
   E, H, G and F must launch, and no plain version run.
12. Decodes a 1 MB frame written by the kernels with the plain versions.
13. The mesh (lz4_tpu_torch.parallel.mesh), with its own counter reset and
   read, over the default mesh (every visible card) and over four
   positions on card 0: compress_frame_mesh of the corpus at min_match 4
   (kernels A and C per 4 MB chunk), decoded by decompress_frame_device,
   the two meshes' frames byte-identical; the corpus as 1,024 rows of 64
   KB through encode_blocks_sharded and decode_blocks_sharded (B, batch
   D; every row back, the payloads one unsharded encode_blocks call's) and
   roundtrip_step; 64 SG lists of 256 KB (4 KB iovecs into 4 KB buffers)
   and six ragged lists of three layouts through sg_compress_mesh (kernel
   G with its list axis, one launch per bucket and card) and
   sg_decompress_mesh (kernel F), byte-exact, equal on both meshes.  Step
   3k holds sg_encode_chain_batch on the 64 lists against its plain
   version and against one sg_encode_chain launch per list, and times it.
   Kernels A, C, B, batch D, F and G's list axis must launch, and no plain
   version run.
14. Multihost (lz4_tpu_torch.parallel.multihost): one worker process per
   visible card (this script with --multihost-worker), NCCL through a
   file:// store under build/, each with a time limit; each compresses
   its slice of the corpus's 1,024 rows with the lengths all-gathered (B)
   and decodes it (batch D); rank 0 splices the segments into one
   block-independent frame, which decompress_frame_device must decode to
   the corpus.  B and batch D must launch in the workers, and no plain
   version run.  --parallel-only runs steps 1, 2, 13 and 14 alone (the
   check on four cards).
15. The library API (lz4_tpu_torch.block, .stream, .frame), with its own
   counter reset and read: the one-shot calls on 4 KB, 64 KB, 256 KB and
   1 MB of the corpus (kernel B, or A's chain past 256 KB; H; batch and
   resumable D behind the host's walk over the lengths) and the decoders
   on adversarial blocks; two stream sessions of 64 chunks of 4-96 KB
   (a double buffer and a ring buffer; the window on the card; every
   eighth chunk through the destSize forms, decoded in two resumed
   pieces); FrameDecompressor fed step 6's flushed linked file and its -B7
   file (64 MiB each) in random slices of 1 KB-1 MiB, the content also
   against decompress_frame_device; the FrameCompressor matrix on 16 MiB
   (ids 4-7, independent and linked, checksums, auto_flush, flush; HC
   level 9 on 256 KB).  Kernels A, B, C, H, I, E and both batch variants
   of D must launch, and no plain version run.  Then the same calls run
   through the plain route on this host's CPU, and every result must be
   the card's (tolerance 0).  Each call is then timed at 4 KB and 64 KB
   (wall, and its kernels' device time from the profiler), and the two
   routes FrameDecompressor could take for a feed's blocks (linked 64 KB
   blocks: E behind a window from the host, or D linked behind one on the
   card; independent 4 MB blocks: D batch or E) side by side.
16. The HC API (lz4_tpu_torch.hc) and linked HC frames, with its own
   counter reset and read: compress_hc_block and compress_hc_dest_size on
   4 KB, 64 KB and 1 MB of the corpus, with and without a 64 KB dict_ (the
   destSize blocks within their capacity); two HcCompressStream sessions of
   64 chunks of 4-96 KB (double buffer, ring buffer; every eighth chunk
   first refused at capacity 1, which keeps the window); FrameCompressor
   at level 9 on the 64 MiB corpus as linked -B4 (streamed) and -B7
   frames.  Every result is decoded on the card (kernels D and E; the
   frames also through decompress_frame_device) to its input.  Kernel I,
   batch and linked D and E must launch, and no plain version run.  Then
   the one-shot calls on 4 KB and 64 KB and the first three blocks of the
   double-buffer session run through the plain route on this host's CPU,
   equal to the card's; each call is timed at 4 KB and 64 KB.
17. Kernel A's adaptive mode (a min_match per block, ``mm_rows``): on the
   main path's chunk (64 linked blocks behind their window) with mm_rows
   cycling (4, 6, 8, 12), the per-block tables built on the card must equal
   the CPU's (also at all 8 and all 4), the card's bytes and lengths its
   plain version's, and uniform mm_rows of 4 and of 8 the static kernel A's
   bytes at min_match 4 and 8; the scan is timed at static mm=8, mm_rows
   all 8 and the mixed cycle (alternating rounds), the tables apart, and
   ``cand_frac8_rows`` on the corpus's 1,024 rows (8 of them against the
   CPU's, exactly).  Then, with its own counter reset and read, the whole
   corpus goes through ``encode_blocks_linked(..., mm_rows=)`` in 16 chunks
   and back through ``decode_blocks_linked`` byte-exact.  Kernels A and
   linked D must launch, and no plain version run.
18. ``fullbench_torch.py --mb 16`` on the card, with its own counter reset
   and read: one MB/s line per cell, every round trip checked.  Every
   kernel but G's list axis must launch, and no plain version run.
19. The example twins of ``tpu_batch.py``, ``mesh_frame.py``,
   ``scatter_gather.py`` and ``print_version.py``, each once without
   ``--device`` (on the card).
20. The decompress landing, with its own counter reset and read: the
   corpus as an hc9 frame (kernel D batch), a 64 MiB object of 1 MiB
   segments, half of them noise, as a linked -BD frame (kernel D linked,
   stored blocks), and the corpus at ``lz4 -1``'s defaults, independent
   4 MB blocks (kernel E), each decoded 3 times through
   decompress_frame_device, every output ``bytes`` equal to its input and
   ``pinned_d2h_bytes`` equal to its length; no pinned memory allocated
   after a frame's first call (where PyTorch's host allocator reports its
   count); then the frames decoded at once in three threads, twice each,
   byte-exact.  Batch and linked D and E must launch, and no plain
   version run.  --landing-only runs steps 1, 2 and 20 alone.

Prints a JSON line of the kernels (each with the launch count of the phase
that drives it, every phase's counts, its time on the card, its plain
version's, and its bound: the bytes the timed call must read and write at
3.35 TB/s; the legacy and envelope phases' ratios and walls beside), then,
as its last line, {"ok": true, "device": {...}}.  Exits non-zero on any failure, and when no
card is present.  Writes nothing outside build/ (the kernel library and
the temporary directories of steps 6 and 8).
"""

import functools
import inspect
import json
import os
import random
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
W = 65536
CORPUS_BYTES = 64 << 20
# (min_match, reject_step, content checksum)
MAIN_POINTS = ((8, 1, False), (4, 1, False), (8, 1, True))

# name -> (route, source, the Pallas launch it replaces, the phase whose
# launch count it reports: "main" = step 4, "entry" = step 5, "stream" =
# step 6, "sg" = step 7, "hc" = step 8, "destsize" = step 9, "mesh" = step
# 13; every phase's counts, step 15's "api" and step 16's "hc_api" too,
# are in launches_by_phase)
KERNELS = {
    "encode_linked": ("cuda", "lz4_tpu_torch/csrc/encode.cu",
                      "lz4_tpu/kernels/encode_kernel.py:744", "main"),
    "encode": ("cuda", "lz4_tpu_torch/csrc/encode.cu",
               "lz4_tpu/kernels/encode_kernel.py:398", "entry"),
    "pack": ("cuda", "lz4_tpu_torch/csrc/pack.cu",
             "lz4_tpu/kernels/pack_kernel.py:161", "main"),
    "decode_linked": ("cuda", "lz4_tpu_torch/csrc/decode.cu",
                      "lz4_tpu/kernels/decode_kernel.py:834", "main"),
    "decode_batch": ("cuda", "lz4_tpu_torch/csrc/decode.cu",
                     "lz4_tpu/kernels/decode_kernel.py:834", "entry"),
    "decode_stream": ("cuda", "lz4_tpu_torch/csrc/stream.cu",
                      "lz4_tpu/kernels/decode_kernel.py:1636", "stream"),
    "decode_sg": ("cuda", "lz4_tpu_torch/csrc/sg_decode.cu",
                  "lz4_tpu/kernels/decode_kernel.py:889", "sg"),
    "sg_encode_chain": ("cuda", "lz4_tpu_torch/csrc/sg_chain.cu",
                        "lz4_tpu/kernels/destsize_kernel.py:594", "sg"),
    "encode_hc": ("cuda", "lz4_tpu_torch/csrc/hc.cu",
                  "lz4_tpu/kernels/hc_kernel.py:329", "hc"),
    "encode_dest_size": ("cuda", "lz4_tpu_torch/csrc/destsize.cu",
                         "lz4_tpu/kernels/destsize_kernel.py:273",
                         "destsize"),
    "decode_dest_size": ("cuda", "lz4_tpu_torch/csrc/decode.cu",
                         "lz4_tpu/kernels/decode_kernel.py:834", "destsize"),
    "xxh32": ("cuda", "lz4_tpu_torch/csrc/xxh.cu",
              "lz4_tpu/kernels/xxh32_kernel.py:85", "destsize"),
    "xxh64": ("cuda", "lz4_tpu_torch/csrc/xxh.cu",
              "lz4_tpu/kernels/xxh64_kernel.py:129", "destsize"),
    "sg_encode_chain_batch": ("cuda", "lz4_tpu_torch/csrc/sg_chain.cu",
                              "lz4_tpu/kernels/destsize_kernel.py:594",
                              "mesh"),
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def real_text_corpus(nbytes: int) -> bytes:
    """The Python stdlib sources concatenated in sorted order (repeated if
    the stdlib is smaller), as bench.py builds its corpus."""
    parts, size = [], 0
    for p in sorted(Path(sysconfig.get_paths()["stdlib"]).rglob("*.py")):
        try:
            b = p.read_bytes()
        except OSError:
            continue
        parts.append(b)
        size += len(b)
        if size >= nbytes:
            break
    data = b"".join(parts)[:nbytes]
    if len(data) < nbytes:
        data = (data * (nbytes // max(len(data), 1) + 1))[:nbytes]
    return data


def mixed_bytes(n: int, text: bytes, seed: int) -> bytes:
    """Inputs unlike text, from a seed: zero runs, noise, short periods,
    text slices and far repeats of earlier output."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rint(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=g))

    def noise(k):
        return torch.randint(0, 256, (k,), generator=g,
                             dtype=torch.uint8).numpy().tobytes()

    out = bytearray()
    while len(out) < n:
        kind, size = rint(0, 5), rint(1, 20_000)
        if kind == 0:
            out += bytes(size)
        elif kind == 1:
            out += noise(size)
        elif kind == 2:
            period = rint(1, 40)
            out += (noise(period) * (size // period + 1))[:size]
        elif kind == 3:
            start = rint(0, len(text) - size)
            out += text[start:start + size]
        elif out:
            start = rint(0, len(out))
            out += out[start:start + size]
    return bytes(out[:n])


def noise_bytes(n: int, seed: int) -> bytes:
    """``n`` random bytes from ``numpy.random.default_rng(seed)``."""
    import numpy as np
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def slot_collisions(n: int, seed: int) -> bytes:
    """``n`` bytes of 24 distinct 5-grams that all hash to one slot of the
    destSize table (HASH_LOG 14), in a random order, each followed by 0-2
    random bytes: many lanes of one probe round of kernels G and H share a
    slot, and the candidate a lower lane leaves mostly fails the word test
    (it holds where a gram repeats)."""
    import numpy as np
    prime, hash_log = 2654435761, 14
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, (200_000, 5), dtype=np.uint8).astype(np.uint64)
    w = g[:, 0] | g[:, 1] << 8 | g[:, 2] << 16 | g[:, 3] << 24
    x = (w ^ (g[:, 4] * prime & 0xFFFFFFFF)) * prime & 0xFFFFFFFF
    h = (x >> (32 - hash_log)).astype(np.int64)
    grams = np.unique(g[h == np.bincount(h).argmax()], axis=0)[:24]
    grams = grams.astype(np.uint8)
    out = bytearray()
    while len(out) < n:
        out += grams[rng.integers(len(grams))].tobytes()
        out += rng.integers(0, 256, rng.integers(3), dtype=np.uint8).tobytes()
    return bytes(out[:n])


# -- building 4 MB and 8 MB blocks from independent 256 KB payloads ----------
# Kernel B encodes rows of at most 256 KB, and the card host has no LZ4
# compressor that writes larger blocks of independent payloads:
# lz4_tpu_torch.legacy.merged_blocks joins consecutive payloads into one
# block (each terminal literal run folded into the next payload's first
# sequence).  It is imported where it is called, so that the --*-times
# modes load the package of the tree they time.


def frame_payloads(frame: bytes, pos: int):
    """(payload, stored) of each block record of an LZ4F frame without
    block checksums, from the first record at ``pos`` to the endmark."""
    out = []
    while True:
        raw = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
        if raw == 0:
            return out
        size = raw & 0x7FFFFFFF
        out.append((frame[pos:pos + size], bool(raw >> 31)))
        pos += size


def lz4_seq(lits: bytes, offset: int = 0, mlen: int = 0) -> bytes:
    """One LZ4 sequence: ``lits``, then a match of ``mlen`` bytes at
    ``offset`` (none when ``mlen`` is 0: a block's last sequence)."""
    from lz4_tpu_torch.legacy import literal_head
    out = literal_head(len(lits), min(max(mlen - 4, 0), 15)) + lits
    if mlen:
        out += offset.to_bytes(2, "little")
        if mlen - 4 >= 15:
            rest = mlen - 19
            out += b"\xff" * (rest // 255) + bytes([rest % 255])
    return out


def long_match(n: int, head: bytes) -> bytes:
    """A block decoding to ``n`` bytes of ``head`` repeated: ``head`` as
    literals, one match at offset len(head), five literals."""
    tail = (head * (n // len(head) + 1))[n - 5:n]
    return lz4_seq(head, len(head), n - len(head) - 5) + lz4_seq(tail)


# a literal run whose extension sums past the int32 range in one 8 MB block
INT32_RUN = b"\xf0" + b"\xff" * ((1 << 31) // 255 + 1) + b"\x00"


def stream_adversarial(n: int, text: bytes):
    """Kernel E's hard cases for its parallel parse, blocks of about ``n``
    bytes: (what, payload, cap).  Every one but the last three decodes
    to -1."""
    ext = b"".join(lz4_seq(text[i:i + 300], 7, 600)
                   for i in range(0, n // 900 * 300, 300))
    return [
        ("a payload of 255s", b"\xff" * n, n),
        ("a match ending exactly at n", long_match(n, text[:7])[:-6], n),
        ("an offset before the block", lz4_seq(b"a", 2, n - 10)
         + lz4_seq(b"z"), n),
        ("a block over its cap", long_match(n, text[:7]), n - 1),
        ("zeros: offset 1, one long match", long_match(n, b"\0"), n),
        ("a 7-byte period", long_match(n, text[:7]), n),
        ("long extensions at every span bound", ext + lz4_seq(b"end"),
         n // 900 * 900 + 3),
    ]


def sg_adversarial(P: int, text: bytes):
    """Kernel F's hard cases, chains of blocks of ``P`` <= 32,767 bytes:
    (what, payloads, sizes)."""
    head = lz4_seq(text[:P])
    copy = lz4_seq(b"", P, P) + lz4_seq(b"")
    return [
        ("references crossing 16 blocks", [head] + [copy] * 16, [P] * 17),
        ("a failed middle block's bytes and zero tail, copied on",
         [head, lz4_seq(b"", P, P // 2) + lz4_seq(b"x", 0, 4), copy,
          lz4_seq(b"", 2 * P, P) + lz4_seq(b"")], [P] * 4),
        ("a short block, copied on",
         [head, lz4_seq(text[:P // 2]), copy,
          lz4_seq(b"", 2 * P, P) + lz4_seq(b"")], [P] * 4),
    ]


def block_records(payloads) -> bytes:
    """LE32 size + payload for each compressed block (no checksums)."""
    return b"".join(len(p).to_bytes(4, "little") + p for p in payloads)


# -- the stream path (kernel E): inputs, kernel cases and the phase ----------
# DeviceFrameCompressor update size of the flushed frame: not a multiple of
# 64 KB, so every flush() writes a short non-final block
FLUSH_CHUNK = 4_000_000
PER_4MB, PER_8MB = 16, 32          # 256 KB payloads per -B7 / legacy block
MB4 = 4 << 20


def stream_files(corpus: bytes, dev) -> dict:
    """The stream phase's files, all written on ``dev`` by the port:
    'b5_linked' (256 KB blocks from kernels B and C; a linked header over
    independent content), 'b7' (16 of those payloads merged per 4 MB
    block, independent, with a content checksum: what ``lz4 file`` writes),
    'legacy' (32 per 8 MB block) and 'flushed' (a linked 64 KB-block frame
    from DeviceFrameCompressor, flush() after every third update, so the
    chain has short non-final blocks and real cross-block matches)."""
    import torch

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import spec
    from lz4_tpu_torch.frame import FramePreferences, encode_frame_header
    from lz4_tpu_torch.legacy import merged_blocks
    from lz4_tpu_torch.ops.xxhash import xxh32

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b5 = D.compress_frame_device(
        corpus, FramePreferences(block_size_id=5, block_independent=True),
        block_size=256 << 10, device=dev)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[memory] compress_frame_device of {len(corpus)} bytes as "
        f"independent 256 KB blocks (kernel B): peak device memory "
        f"{peak / 2**20:.1f} MiB ({peak / max(len(corpus), 1):.2f} bytes "
        f"per input byte)")
    recs = frame_payloads(b5, 7)
    files = {
        "b5_linked": encode_frame_header(FramePreferences(
            block_size_id=5)) + b5[7:],
        "b7": (encode_frame_header(FramePreferences(
            block_size_id=7, block_independent=True, content_checksum=True))
            + block_records(merged_blocks(recs, PER_4MB)) + bytes(4)
            + xxh32(corpus, 0).to_bytes(4, "little")),
        "legacy": (spec.LEGACY_MAGIC.to_bytes(4, "little")
                   + block_records(merged_blocks(recs, PER_8MB))),
    }
    comp = D.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                   device=dev)
    parts = [comp.begin()]
    for k, i in enumerate(range(0, len(corpus), FLUSH_CHUNK)):
        parts.append(comp.update(corpus[i:i + FLUSH_CHUNK]))
        if k % 3 == 2:
            parts.append(comp.flush())
    parts.append(comp.end())
    files["flushed"] = b"".join(parts)
    return files


def b4_frame(corpus: bytes, dev) -> bytes:
    """The corpus as a -B4 frame (independent 64 KB blocks, with a content
    checksum), written by ``io.compress_stream`` at -1 -B4 on ``dev``: what
    ``lz4 -B4 file`` writes, and decoded by kernel D's batch mode."""
    import io

    from lz4_tpu_torch import io as tio
    dst = io.BytesIO()
    tio.compress_stream(io.BytesIO(corpus), dst,
                        tio.IoPrefs(level=1, block_size_id=4, verbosity=0),
                        len(corpus), device=dev)
    return dst.getvalue()


def _records(frame: bytes, pos: int):
    """(starts, sizes, stored) of the block records of a frame without
    block checksums."""
    starts, sizes, stored = [], [], []
    for p, st in frame_payloads(frame, pos):
        pos += 4
        starts.append(pos)
        sizes.append(len(p))
        stored.append(int(st))
        pos += len(p)
    return starts, sizes, stored


def stream_cases(files: dict, corpus: bytes, dev, bad_rows, noise_rows):
    """Kernel E's inputs at small sizes, each run in both modes: (what,
    flat bytes, bstart, clen, stored, block size, caps or None)."""
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.frame import FramePreferences

    b7 = files["b7"]
    s7, n7, _ = _records(b7, 7)
    p1 = frame_payloads(files["b5_linked"], 7)[PER_4MB][0]
    four = b7[:s7[0] + n7[0]] + block_records([p1])
    cases = [("4 MB block + 256 KB block, raw frame offsets", four,
              [s7[0], s7[0] + n7[0] + 4], [n7[0], len(p1)], [0, 0], MB4,
              None)]
    # stored blocks, one over its cap, beside a compressed one
    parts = [corpus[:100_000], p1, noise_rows[0] * 17, corpus[:300_000]]
    starts = [sum(map(len, parts[:i])) + 3 for i in range(len(parts))]
    cases.append(("stored blocks", b"\x01\x02\x03" + b"".join(parts), starts,
                  [len(p) for p in parts], [1, 0, 1, 1], 256 << 10,
                  [100_000, 256 << 10, 256 << 10, 200_000]))
    # short mid-stream blocks: a flushed linked chain with cross-block
    # matches (its independent-mode verdicts reject the reaching blocks)
    comp = D.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                   device=dev)
    small = comp.begin() + b"".join(
        comp.update(corpus[i:i + 300_000]) + comp.flush()
        for i in range(0, 1_500_000, 300_000)) + comp.end()
    st, sz, sd = _records(small, 7)
    cases.append(("flushed chain, short mid-stream blocks", small, st, sz,
                  sd, 64 << 10, None))
    # flush() after every 5,000 bytes: references cross up to 13 blocks
    comp = D.DeviceFrameCompressor(FramePreferences(block_size_id=4),
                                   device=dev)
    fine = comp.begin() + b"".join(
        comp.update(corpus[i:i + 5000]) + comp.flush()
        for i in range(0, 200_000, 5000)) + comp.end()
    st, sz, sd = _records(fine, 7)
    cases.append(("flushed chain of 5,000-byte blocks", fine, st, sz, sd,
                  64 << 10, None))
    # a -B5 chain whose first block reaches before the stream's start
    first = fine[st[5]:st[5] + sz[5]]
    recs = frame_payloads(files["b5_linked"], 7)[:4]
    parts = [first] + [p for p, _ in recs]
    cases.append(("-B5 chain, first block reaching before the stream",
                  b"".join(parts),
                  [sum(map(len, parts[:i])) for i in range(len(parts))],
                  [len(p) for p in parts], [0] + [int(t) for _, t in recs],
                  256 << 10, None))
    for what, rows in (("48 corrupted streams", bad_rows),
                       ("64 payloads of noise", noise_rows)):
        starts = [sum(map(len, rows[:i])) for i in range(len(rows))]
        cases.append((what, b"".join(rows), starts, [len(r) for r in rows],
                      [0] * len(rows), 64 << 10, None))
    return cases


def stream_launches(files: dict) -> dict:
    """File name -> the arguments of kernel E's launch on that full-size
    file, as the stream phase's entry points make it (device.py): (what,
    flat bytes, bstart, clen, stored, block size, linked, caps).  A frame's
    stored blocks may fill their own length, every other block its block
    size."""
    out = {}
    for what, name, bs, linked in (
            ("-B7 frame, 16 blocks of 4 MB", "b7", MB4, False),
            ("-B5 linked frame, 256 blocks", "b5_linked", 256 << 10, True),
            ("legacy file, 8 blocks of 8 MB", "legacy", 8 << 20, False),
            ("flushed 64 KB linked chain", "flushed", 64 << 10, True)):
        frame = files[name]
        st, sz, sd = _records(frame, 4 if name == "legacy" else 7)
        caps = [bs] * len(st) if name == "flushed" else \
            [n if s else bs for n, s in zip(sz, sd)]
        out[name] = (what, frame[:st[-1] + sz[-1]], st, sz, sd, bs, linked,
                     caps)
    return out


def stream_phase(files: dict, corpus: bytes, dev, fixtures: Path,
                 tmp_root: Path) -> None:
    """The stream path at full size, through the entry points a user
    calls: decompress_frame_device, decompress_legacy_device and
    lz4_tpu_torch.io.  Every output must equal its input byte for byte."""
    import io
    import tempfile

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import io as tio

    cases = (("-B7 independent + content checksum", files["b7"],
              D.decompress_frame_device),
             ("-B5 linked", files["b5_linked"], D.decompress_frame_device),
             ("legacy (8 MB blocks)", files["legacy"],
              D.decompress_legacy_device),
             ("64 KB linked, flush() every 3rd update", files["flushed"],
              D.decompress_frame_device))
    mb = len(corpus) / 1e6
    for what, frame, fn in cases:
        t0 = time.perf_counter()
        out, used = fn(frame, device=dev)
        dt = time.perf_counter() - t0
        if out != corpus or used != len(frame):
            raise SmokeFailure(f"stream phase: {what} does not decode to the "
                               "corpus")
        log(f"[stream] {len(corpus) >> 20} MiB {what}: {len(frame)} bytes, "
            f"decompress {mb / dt:.1f} MB/s ({dt:.3f} s), byte-exact")
        del out
    golden = (fixtures / "golden_input.bin").read_bytes()
    for name in ("default.lz4", "hc9_b5_linked.lz4", "legacy.lz4"):
        out = io.BytesIO()
        tio.decompress_stream(io.BytesIO((fixtures / name).read_bytes()),
                              out, tio.IoPrefs(), device=dev)
        if out.getvalue() != golden:
            raise SmokeFailure(f"fixture {name} does not decode to "
                               "golden_input.bin")
        log(f"[stream] fixture {name}: decodes to golden_input.bin")
    tmp_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        src, dst = Path(d) / "corpus.lz4", Path(d) / "corpus"
        src.write_bytes(files["b7"])
        t0 = time.perf_counter()
        r, w = tio.decompress_filename(str(src), str(dst), tio.IoPrefs(),
                                       device=dev)
        dt = time.perf_counter() - t0
        if (r, w) != (len(files["b7"]), len(corpus)) or \
                dst.read_bytes() != corpus:
            raise SmokeFailure("io.decompress_filename of the -B7 file "
                               "differs")
    log(f"[stream] io.decompress_filename, {len(corpus) >> 20} MiB -B7 "
        f"file: {mb / dt:.1f} MB/s ({dt:.3f} s) file to file, byte-exact")


# -- the scatter-gather path (kernels G and F): layouts, cases, the phase -----
SG_BYTES = 16 << 20                # the sg phase's content: the corpus head
SG_IOVEC = 4096
SG_LARGE_BYTES, SG_LARGE_IOVEC = 4 << 20, 256 << 10


def ragged_iovecs(data: bytes, seed: int, max_in: int, min_cap: int,
                  max_cap: int, room: float):
    """Input iovecs of 1..max_in bytes over ``data`` and output caps in
    min_cap..max_cap (the first at least SG_MIN_FIRST_OUT) until they hold
    ``room`` times the content, from ``random.Random(seed)``."""
    import random

    from lz4_tpu_torch import spec
    rng = random.Random(seed)
    ins, pos = [], 0
    while pos < len(data):
        n = min(rng.randint(1, max_in), len(data) - pos)
        ins.append(data[pos:pos + n])
        pos += n
    caps = []
    while sum(caps) < room * len(data) + 65536:
        caps.append(rng.randint(min_cap, max_cap))
    caps[0] = max(caps[0], spec.SG_MIN_FIRST_OUT)
    return ins, caps


def sg_layouts(corpus: bytes) -> dict:
    """The sg phase's layouts over the head of the corpus: name -> (what,
    input iovecs, output caps).  '4k': 4 KB input iovecs into 17/16 as
    many 4 KB output iovecs (the fork's sgtest pattern, 16 x 4 KB -> 17 x
    4 KB, scaled up); 'ragged': test_sg.py's fuzz distribution (inputs of
    1..80,000 bytes, outputs of 10..90,000) over the same bytes; 'large':
    16 iovecs of 256 KB into one output buffer (blocks over 64 KB)."""
    from lz4_tpu_torch import spec
    data = corpus[:SG_BYTES]
    n = len(data) // SG_IOVEC
    large = corpus[:SG_LARGE_BYTES]
    return {
        "4k": (f"{n} x 4 KB -> {n * 17 // 16} x 4 KB",
               [data[i:i + SG_IOVEC] for i in range(0, len(data), SG_IOVEC)],
               [SG_IOVEC] * (n * 17 // 16)),
        "ragged": ("ragged iovecs", *ragged_iovecs(
            data, 0xD57, 80_000, spec.SG_MIN_OUT_BUF, 90_000, 1.125)),
        "large": (f"{len(large) // SG_LARGE_IOVEC} x 256 KB -> one buffer",
                  [large[i:i + SG_LARGE_IOVEC]
                   for i in range(0, len(large), SG_LARGE_IOVEC)],
                  [len(large) + 65536]),
    }


def kernel_b_dest_size(dev):
    """A destSize compressor over kernel B for the 'large' layout: the whole
    piece as one independent block (up to 256 KB), or (0, b"") when that
    block does not fit.  An independent block is valid in a linked frame;
    nothing on the card host writes SG blocks over 64 KB otherwise, since
    the chain encoder caps a step at 64 KB."""
    from lz4_tpu_torch import device as D

    def compress(src, capacity, dict_, acceleration):
        rows, lens = D.encode_batch([src], block_size=SG_LARGE_IOVEC,
                                    acceleration=acceleration, device=dev)
        block = rows[0, :int(lens[0])].tobytes()
        return (len(src), block) if len(block) <= capacity else (0, b"")

    return compress


def filled(outs, caps, total):
    """The filled prefix of an SG output list (what a caller sends on)."""
    got, rem = [], total
    for b, c in zip(outs, caps):
        if rem <= 0:
            break
        got.append(b[:min(c, rem)])
        rem -= min(c, rem)
    return got


def sg_chain_cases(text: bytes, mixed: bytes):
    """Kernel G's inputs at small sizes: (what, input iovecs, output caps,
    acceleration, min_match)."""
    def cut(data, n):
        return [data[i:i + n] for i in range(0, len(data), n)]

    ragged = ragged_iovecs(text[:1 << 20], 5, 80_000, 10, 90_000, 1.25)
    stops = ragged_iovecs(text[:200_000], 7, 9_000, 10, 400, 1.5)
    return [
        ("16 x 4 KB -> 17 x 4 KB", cut(text[:W], 4096), [4096] * 17, 1, 4),
        ("16 x 64 KB -> 20 x 60,000", cut(text[:16 * W], W), [60_000] * 20,
         1, 4),
        ("ragged 1 MB", *ragged, 1, 4),
        ("16 x 4 KB, min_match 8", cut(text[W:2 * W], 4096), [4096] * 17,
         1, 8),
        ("16 x 64 KB, acceleration 2", cut(text[:16 * W], W),
         [70_000] * 16, 2, 4),
        ("small caps: capacity stops and zero-pads", *stops, 1, 4),
        ("mixed bytes, 8 KB -> 9,000", cut(mixed, 8192),
         [9000] * (len(mixed) // 8192 + 2), 1, 4),
        ("slot collisions, 8 KB -> 5,000", cut(slot_collisions(200_000, 5),
                                              8192), [5000] * 45, 1, 4),
        ("noise, 20 KB -> 21,000: long skips", cut(noise_bytes(200_000, 6),
                                                   20_000), [21_000] * 11,
         1, 4),
        ("16 x 4 KB, min_match 12, acceleration 7", cut(text[2 * W:3 * W],
                                                        4096),
         [4096] * 17, 7, 12),
        ("slot collisions, 4 KB -> 4 KB, min_match 12, acceleration 7",
         cut(slot_collisions(W, 7), 4096), [4096] * 17, 7, 12),
    ]


def sg_phase(layouts: dict, dev, log_times: dict) -> None:
    """The scatter-gather path at full size, through the entry points a
    user calls: every layout through lz4_tpu_torch.sg.sg_compress, then
    sg_decompress back into the input iovecs, byte-exact; the '4k' and
    'ragged' frames also through decompress_frame_device.  Records MB/s and
    the host walk's share in ``log_times``."""
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import sg

    for name, (what, ins, caps) in layouts.items():
        content = b"".join(ins)
        mb = len(content) / 1e6
        codec = kernel_b_dest_size(dev) if name == "large" else None
        t0 = time.perf_counter()
        total, consumed, outs = sg.sg_compress(ins, caps,
                                               dest_size_compress=codec,
                                               device=dev)
        t_c = time.perf_counter() - t0
        if consumed != len(content) or total <= 0:
            raise SmokeFailure(f"sg phase: {what} compressed {consumed} of "
                               f"{len(content)} bytes")
        comp = filled(outs, caps, total)
        sizes = [len(b) for b in ins]
        t0 = time.perf_counter()
        n, dec = sg.sg_decompress(comp, sizes, device=dev)
        t_d = time.perf_counter() - t0
        if n != len(content) or dec != ins:
            raise SmokeFailure(f"sg phase: {what} does not round-trip")
        # the host walks alone: the compress walk replaying the chain
        # encoder's records, and the decode walk collecting the chain
        walk_c = None
        if codec is None:
            t0 = time.perf_counter()
            scripted = sg._sg_device_compressor(ins, caps, None, None, 1, dev)
            t1 = time.perf_counter()
            if sg.sg_compress(ins, caps, dest_size_compress=scripted) != \
                    (total, consumed, outs):
                raise SmokeFailure(f"sg phase: {what} replays differently")
            walk_c = time.perf_counter() - t1
        t0 = time.perf_counter()
        sg.collect_chain(comp, sizes)
        walk_d = time.perf_counter() - t0
        line = (f"[sg] {what}: {total} bytes (ratio "
                f"{total / len(content):.6f}), sg_compress {mb / t_c:.1f} MB/s "
                f"({t_c:.3f} s"
                + (f", host walk {walk_c:.3f} s = {walk_c / t_c:.1%}"
                   if walk_c is not None else ", kernel B per block")
                + f"), sg_decompress {mb / t_d:.1f} MB/s ({t_d:.3f} s, host "
                f"walk {walk_d:.3f} s = {walk_d / t_d:.1%}), byte-exact")
        if name != "large":
            frame = b"".join(comp)
            t0 = time.perf_counter()
            out, used = D.decompress_frame_device(frame, device=dev)
            t_f = time.perf_counter() - t0
            if out != content or used != len(frame):
                raise SmokeFailure(f"sg phase: the {what} frame does not "
                                   "decode as an LZ4F frame")
            line += (f"; as one LZ4F frame through decompress_frame_device "
                     f"{mb / t_f:.1f} MB/s, byte-exact")
        log(line)
        log_times[name] = {"compress_s": t_c, "decompress_s": t_d,
                           "compress_walk_s": walk_c, "decompress_walk_s":
                           walk_d, "frame_bytes": total,
                           "content_bytes": len(content)}


# -- the HC and file-compress path (kernel I): cases and the phase ----------
HC_LEVELS = (1, 2, 9, 12, 16)      # the levels of kernel I's small cases
HC_SMALL_NS = 4096
HC_SAMPLE_ROWS = 8                 # corpus rows held against the plain version
SWEEP_BYTES, SWEEP_LEVELS = 4 << 20, (3, 9, 16)
# the file-compress settings of the hc phase: (CLI flags, io.IoPrefs fields)
FILE_SETTINGS = (("-9", {"level": 9}), ("-1", {}),
                 ("-1 -BD", {"block_linked": True}))


def hc_small_cases(text: bytes, mixed: bytes):
    """Kernel I's inputs at small sizes: (what, blocks, row width)."""
    import torch

    g = torch.Generator().manual_seed(4321)
    noise = torch.randint(0, 256, (HC_SMALL_NS,), generator=g,
                          dtype=torch.uint8).numpy().tobytes()
    n = HC_SMALL_NS
    needle = (b"needle in a haystack " * 40 + noise[:100]) * 3
    return [
        ("4 KB rows: text, zeros, noise, periods 2 and 3, 13, 12 and 0 "
         "bytes, far repeats",
         [text[i * n:(i + 1) * n] for i in range(4)]
         + [bytes(n), noise, b"ab" * (n // 2), (b"abc" * n)[:n], b"x" * 13,
            text[:12], b"", needle], n),
        ("2 mixed 64 KB rows", [mixed[:W], mixed[W:2 * W - 999]], W),
    ]


def hc_phase(corpus: bytes, dev, tmp_root: Path, kernel_ms: dict) -> dict:
    """The HC and file-compress path at full size, through the entry points
    a user calls: the corpus as a file through io.compress_filename at -9
    (kernel I), -1 (kernel B) and -1 -BD (kernels A and C), each decoded by
    io.decompress_filename; the first 4 MiB through
    compress_frame_device_hc at levels 3, 9 and 16 and back through
    decompress_frame_device; one round trip through the CLI
    (python -m lz4_tpu_torch.cli -9, then -d).  Every output must equal its
    input byte for byte.  ``kernel_ms`` holds kernel I's times on the rows
    these calls give it ("-9" and each sweep level), measured with CUDA
    events before the phase; the -1 and -1 -BD routes' kernel times are in
    chip_profile.py's traces.  Returns the measured numbers."""
    import os
    import tempfile

    import torch

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import io as tio
    from lz4_tpu_torch.frame import FramePreferences

    out, mb = {}, len(corpus) / 1e6
    tmp_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        src = Path(d) / "corpus"
        src.write_bytes(corpus)
        for flags, kw in FILE_SETTINGS:
            dst, back = Path(d) / "corpus.lz4", Path(d) / "back"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            # verbosity 1 (-q): no progress meter on stderr
            r, w = tio.compress_filename(str(src), str(dst), tio.IoPrefs(
                overwrite=True, verbosity=1, **kw), device=dev)
            t_c = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            r2, w2 = tio.decompress_filename(str(dst), str(back), tio.IoPrefs(
                overwrite=True, verbosity=1), device=dev)
            t_d = time.perf_counter() - t0
            if (r, w, r2, w2) != (len(corpus), dst.stat().st_size, w,
                                  len(corpus)) or back.read_bytes() != corpus:
                raise SmokeFailure(f"hc phase: the {flags} file does not "
                                   "round-trip")
            k_ms = kernel_ms.get(flags)
            log(f"[hc] {len(corpus) >> 20} MiB file, lz4 {flags}: ratio "
                f"{w / r:.6f} ({w} bytes), io.compress_filename "
                f"{mb / t_c:.1f} MB/s ({t_c:.3f} s"
                + (f"; kernel I {k_ms:.3f} ms on these rows" if k_ms else "")
                + f"), peak device memory {peak / 2**30:.2f} GiB; "
                f"io.decompress_filename {mb / t_d:.1f} MB/s ({t_d:.3f} s), "
                "byte-exact")
            out[flags] = {"ratio": w / r, "frame_bytes": w,
                          "compress_s": t_c, "decompress_s": t_d,
                          "kernel_ms": k_ms, "peak_bytes": peak}
        data = corpus[:SWEEP_BYTES]
        for level in SWEEP_LEVELS:
            t0 = time.perf_counter()
            frame = D.compress_frame_device_hc(
                data, FramePreferences(block_independent=True), level,
                device=dev)
            t_c = time.perf_counter() - t0
            k_ms = kernel_ms[level]
            if D.decompress_frame_device(frame, device=dev) != \
                    (data, len(frame)):
                raise SmokeFailure(f"hc phase: level {level} does not "
                                   "round-trip")
            log(f"[hc] {len(data) >> 20} MiB, compress_frame_device_hc level "
                f"{level}: ratio {len(frame) / len(data):.6f}, kernel I "
                f"{k_ms:.3f} ms on these rows, wall {t_c:.3f} s, byte-exact")
            out[f"level {level}"] = {"ratio": len(frame) / len(data),
                                     "kernel_ms": k_ms, "compress_s": t_c}
        # the CLI in its own process, on the card
        small, packed, back = (Path(d) / "small", Path(d) / "small.lz4",
                               Path(d) / "small.out")
        small.write_bytes(data)
        env = {k: v for k, v in os.environ.items() if k != "LZ4TPU_FORCE_CPU"}
        env["PYTHONPATH"] = str(REPO)
        t0 = time.perf_counter()
        for args in (["-9", "-f", str(small), str(packed)],
                     ["-d", "-f", str(packed), str(back)]):
            res = subprocess.run([sys.executable, "-m", "lz4_tpu_torch.cli",
                                  *args], env=env, capture_output=True,
                                 text=True, timeout=600)
            if res.returncode != 0:
                raise SmokeFailure(f"lz4_tpu_torch.cli {' '.join(args)} "
                                   f"failed: {res.stderr.strip()}")
        if back.read_bytes() != data:
            raise SmokeFailure("the CLI round trip differs")
        log(f"[hc] python -m lz4_tpu_torch.cli -9, then -d, on "
            f"{len(data) >> 20} MiB: {packed.stat().st_size} bytes, "
            f"byte-exact ({time.perf_counter() - t0:.1f} s with two process "
            "starts)")
    return out


# -- kernel I behind prefixes, and the HC API (lz4_tpu_torch.hc) -------------
HC_PREFIX_LEVELS = (3, 9, 16)      # [64 KB | 64 KB] corpus rows held at these
HC_PREFIX_SMALL_LEVELS = (1, 3, 9, 16)
HC_PREFIX_ROWS = 2                 # corpus rows held per level
HC_API_SIZES = (4 << 10, 64 << 10, 1 << 20)   # the one-shot sources
HC_API_TIMED = (4 << 10, 64 << 10)            # the sizes timed call by call
HC_API_SAMPLE = 3                  # stream chunks held against the CPU


def hc_prefix_cases(text: bytes) -> dict:
    """Kernel I's rows behind prefixes at small sizes: name -> (prefix,
    source).  Prefixes of 1 byte, 4 KB, 65,535 bytes and of zeros; a source
    repeated at distance 65,535 (one match) and 65,536 (out of reach);
    sources of 0, 12 and 13 bytes; noise that repeats part of its
    prefix."""
    x = text[100_000:101_500]
    pre = noise_bytes(4_000, 2)
    return {
        "1-byte prefix": (text[:1], text[1:2_001]),
        "4 KB prefix": (text[:4_096], text[4_096:7_096]),
        "65,535-byte prefix": (text[:65_535], text[65_535:68_535]),
        "zeros prefix": (bytes(4_096), text[:2_000] + bytes(300)),
        "repeat at distance 65,535": (x + noise_bytes(65_535 - len(x), 1),
                                      x),
        "repeat at distance 65,536": (x + noise_bytes(65_536 - len(x), 1),
                                      x),
        "0-byte source": (text[:5_000], b""),
        "12-byte source": (text[:5_000], text[5_000:5_012]),
        "13-byte source": (text[:5_000], text[5_000:5_013]),
        "noise": (pre, noise_bytes(1_000, 3) + pre[500:1_500]
                  + noise_bytes(700, 4)),
    }


def hc_prefixed_batch(dev):
    """1,024 rows [block i | block i + 1] of the corpus's 64 KB blocks (the
    first 64 MiB + 64 KB of it), the first block the prefix: (rows,
    src_lens, window_lens) on ``dev``."""
    import torch
    text = real_text_corpus(CORPUS_BYTES + W)
    blocks = torch.frombuffer(bytearray(text), dtype=torch.uint8) \
        .reshape(-1, W).to(dev)
    return prefix_rows(blocks)


def hc_api_calls(corpus: bytes):
    """Step 16's calls: (what, fn), fn(device, check) returning what the
    calls gave.  With ``check``, fn also decodes each result on ``device``
    through the port's decoders (kernels D and E) and holds it against the
    input (SmokeFailure)."""
    from lz4_tpu_torch import block as B
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import frame as F
    from lz4_tpu_torch import hc as H
    from lz4_tpu_torch import stream as S
    from lz4_tpu_torch.frame import FramePreferences

    def need(ok, what):
        if not ok:
            raise SmokeFailure(f"hc api phase: {what}")

    calls = []
    base = 30 << 20
    for n in HC_API_SIZES:
        s, d = corpus[base:base + n], corpus[base - W:base]
        base += n

        def one_shot(dev, check, s=s, d=d, n=n):
            c0 = H.compress_hc_block(s, device=dev)
            c1 = H.compress_hc_block(s, dict_=d, device=dev)
            res = (c0, c1, H.compress_hc_block(s, capacity=len(c0) - 1,
                                               device=dev),
                   H.compress_hc_dest_size(s, len(c0) // 3, device=dev),
                   H.compress_hc_dest_size(s, len(c1) // 2, dict_=d,
                                           device=dev))
            if check:
                (t1, b1), (t2, b2) = res[3:]
                need(B.decompress_safe(c0, n, device=dev) == s
                     and B.decompress_safe(c1, n, dict_=d, device=dev) == s
                     and res[2] == b"",
                     f"an HC block of {n} bytes does not round-trip")
                need(len(b1) <= len(c0) // 3 and len(b2) <= len(c1) // 2
                     and 0 < t1 < n and 0 < t2 < n
                     and B.decompress_safe(b1, t1, device=dev) == s[:t1]
                     and B.decompress_safe(b2, t2, dict_=d, device=dev)
                     == s[:t2], f"an HC destSize block of {n} bytes passes "
                     "its capacity or does not round-trip")
            return res
        calls.append((f"compress_hc_block and compress_hc_dest_size on "
                      f"{n >> 10} KB, with and without a 64 KB dict_",
                      one_shot))

    rng = random.Random(16)
    sizes = [rng.randint(4 << 10, 96 << 10) for _ in range(API_CHUNKS)]
    ends = [sum(sizes[:i + 1]) for i in range(API_CHUNKS)]
    text = corpus[40 << 20:(40 << 20) + ends[-1]]
    chunks = [text[e - z:e] for e, z in zip(ends, sizes)]
    for discipline in ("double buffer", "ring buffer"):
        def session(dev, check, discipline=discipline, k=API_CHUNKS):
            enc = H.HcCompressStream(device=dev)
            dec = S.BlockDecompressStream(corpus[:W], device=dev)
            enc.load_dict(corpus[:W])
            slots = [bytearray(96 << 10), bytearray(96 << 10)]
            ring, at = bytearray(256 << 10), 0
            blocks, out = [], []
            for i, chunk in enumerate(chunks[:k]):
                if discipline == "double buffer":
                    slots[i % 2][:len(chunk)] = chunk
                    view = bytes(slots[i % 2][:len(chunk)])
                else:
                    at = 0 if at + len(chunk) > len(ring) else at
                    ring[at:at + len(chunk)] = chunk
                    view = bytes(ring[at:at + len(chunk)])
                    at += len(chunk)
                if i % 8 == 7:      # limited output: fails, keeps the window
                    need(enc.compress_continue(view, capacity=1) == b"",
                         "a block fit in one byte")
                blocks.append(enc.compress_continue(view))
                out.append(dec.decompress_continue(blocks[-1], len(view)))
            if check:
                need(b"".join(out) == text[:ends[k - 1]]
                     and enc.save_dict() == (corpus[:W] + text[:ends[k - 1]])[
                         -W:], f"the {discipline} HC session does not "
                     "round-trip or its window differs")
            return blocks, enc.save_dict()
        calls.append((f"an HcCompressStream session of {API_CHUNKS} chunks "
                      f"of 4-96 KB ({discipline})", session))

    for bsid in (4, 7):
        def frame_call(dev, check, bsid=bsid):
            prefs = FramePreferences(block_size_id=bsid, level=9,
                                     content_checksum=True)
            if bsid == 4:           # streamed in updates of 1 KB-3 MiB
                rng = random.Random(19)
                comp = F.FrameCompressor(prefs, device=dev)
                parts, pos = [comp.begin()], 0
                while pos < len(corpus):
                    k = rng.randint(1 << 10, 3 << 20)
                    parts.append(comp.update(corpus[pos:pos + k]))
                    pos += k
                frame = b"".join(parts + [comp.end()])
            else:
                frame = F.compress_frame(corpus, prefs, device=dev)
            if check:
                need(not F.get_frame_info(frame).block_independent
                     and F.decompress_frame(frame, device=dev)
                     == (corpus, len(frame))
                     and D.decompress_frame_device(frame, device=dev)
                     == (corpus, len(frame)), f"the linked -B{bsid} HC frame "
                     "is not linked or does not round-trip")
            return frame
        calls.append((f"FrameCompressor level 9, linked -B{bsid}, on the "
                      f"{len(corpus) >> 20} MiB corpus", frame_call))
    return calls


def hc_api_phase(corpus: bytes, dev):
    """Step 16, after the counters were reset: every call of
    ``hc_api_calls`` on the card, its results decoded on the card and held
    against the input.  Returns (what the calls gave, their walls)."""
    import torch
    results, walls = [], {}
    for what, fn in hc_api_calls(corpus):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(fn(dev, True))
        walls[what] = time.perf_counter() - t0
        log(f"[hc-api] {what}: {walls[what]:.3f} s on the card, decoded "
            "byte-exact")
    return results, walls


def hc_api_plain_check(corpus: bytes, results) -> None:
    """A sample of step 16 again through the plain route on the CPU: the
    one-shot calls on 4 KB and 64 KB and the first HC_API_SAMPLE chunks of
    the double-buffer session must give the card's bytes (tolerance 0)."""
    calls = hc_api_calls(corpus)
    for k in range(2):
        t0 = time.perf_counter()
        if calls[k][1]("cpu", False) != results[k]:
            raise SmokeFailure(f"hc api phase: {calls[k][0]} differs from "
                               "the plain route on the CPU")
        log(f"[hc-api] {calls[k][0]}: equal to the plain route on the CPU "
            f"({time.perf_counter() - t0:.1f} s)")
    at = len(HC_API_SIZES)
    t0 = time.perf_counter()
    blocks, _ = calls[at][1]("cpu", False, k=HC_API_SAMPLE)
    if blocks != results[at][0][:HC_API_SAMPLE]:
        raise SmokeFailure("hc api phase: the stream session's first blocks "
                           "differ from the plain route on the CPU")
    log(f"[hc-api] the first {HC_API_SAMPLE} blocks of {calls[at][0]}: equal "
        f"to the plain route on the CPU ({time.perf_counter() - t0:.1f} s)")


def hc_api_times(corpus: bytes, dev) -> dict:
    """Step 16's per-call times at 4 KB and 64 KB (``call_times``).  Before
    each call to the stream or the frame compressor their window is set
    back to the 64 KB before the chunk (outside the timed span), so every
    timed call compresses the same chunk behind its real history: a chunk
    timed again and again behind itself would find it whole in the
    window."""
    from lz4_tpu_torch import frame as F
    from lz4_tpu_torch import hc as H
    from lz4_tpu_torch.frame import FramePreferences

    out = {}
    base = 44 << 20
    for n in HC_API_TIMED:
        s, d = corpus[base:base + n], corpus[base - W:base]
        cap = len(H.compress_hc_block(s, device=dev)) // 2
        enc = H.HcCompressStream(device=dev)
        fc = []

        def new_frame():
            fc[:] = [F.FrameCompressor(FramePreferences(
                block_size_id=4, level=9, auto_flush=True), device=dev)]
            fc[0].begin()
            fc[0].update(d)

        fns = {
            "compress_hc_block": (lambda: H.compress_hc_block(s, device=dev),
                                  None),
            "compress_hc_block (64 KB dict_)": (lambda: H.compress_hc_block(
                s, dict_=d, device=dev), None),
            "compress_hc_dest_size (half the block)":
                (lambda: H.compress_hc_dest_size(s, cap, device=dev), None),
            "HcCompressStream.compress_continue":
                (lambda: enc.compress_continue(s), lambda: enc.load_dict(d)),
            "FrameCompressor.update (level 9, linked, auto_flush)":
                (lambda: fc[0].update(s), new_frame),
        }
        for name, (fn, setup) in fns.items():
            t = call_times(fn, n, reps=5, setup=setup)
            out.setdefault(name, {})[f"{n >> 10} KB"] = t
            log(f"[hc-api] {name} on {n >> 10} KB: {t['wall_us']:.1f} us a "
                f"call ({t['mbs']:.1f} MB/s), kernels {t['kernel_us']:.1f} "
                f"us, CUDA events around the call {t['event_us']:.1f} us")
    return out


# -- the destSize and checksum path (kernels H, J, K, D resumable) -----------
DS_SAMPLE_ROWS = 8                 # batch rows held against the plain versions
DS_SMALL_CAPS = (1, 2, 5, 6, 10, 17)
DS_DECODE_CAP = 32768              # the resumed decode's room per round
XXH_PAGE_BYTES, XXH_PAGE = 16 << 20, 4096      # the SG page shape
XXH_SEEDS = (0, 1, 0x9E3779B1, (1 << 63) + 12345)
# the SG walk over kernel H: 128 KB iovecs into 32 KB buffers.  Text takes
# about 0.37 of its size under this parse, so a buffer holds 80-90 KB of
# source: most blocks stop at their capacity, and many decode to more than
# 64 KB.  (In 48 KB buffers a block often takes a whole iovec, and fewer
# than half of the blocks are capacity stops.)
SG_H_BYTES, SG_H_IOVEC, SG_H_OUT = 4 << 20, 128 << 10, 32 << 10


def i32_tensor(values, dev):
    import torch
    return torch.tensor(list(values), dtype=torch.int32, device=dev)


def ds_rows(buffers, prefixes, dev):
    """Kernel H's arguments for sources behind prefixes: ([B, NS] uint8 rows
    [prefix | source], NS a multiple of 128; src_lens; window_lens) on
    ``dev``."""
    from lz4_tpu_torch.device import byte_rows
    prefixes = prefixes or [b""] * len(buffers)
    joined = [p + b for p, b in zip(prefixes, buffers)]
    ns = max(-(-max(map(len, joined)) // 128) * 128, 128)
    rows, _ = byte_rows(joined, ns, dev)
    return (rows, i32_tensor(map(len, buffers), dev),
            i32_tensor(map(len, prefixes), dev))


def right_rows(buffers, dev):
    """([B, P] uint8 rows with each buffer right-aligned, [B] lengths): the
    decoders' dictionary rows."""
    import numpy as np

    from lz4_tpu_torch.kernels.common import to_device
    width = max(max(map(len, buffers)), 1)
    arr = np.zeros((len(buffers), width), np.uint8)
    for i, b in enumerate(buffers):
        if b:
            arr[i, width - len(b):] = np.frombuffer(b, np.uint8)
    return (to_device(arr, dev).reshape(arr.shape),
            i32_tensor(map(len, buffers), dev))


def ds_small_cases(text: bytes, mixed: bytes):
    """Kernel H's inputs at small sizes: (what, sources, caps, prefixes or
    None, acceleration, min_match)."""
    import torch

    from lz4_tpu_torch.spec import compress_bound
    g = torch.Generator().manual_seed(2468)
    noise = torch.randint(0, 256, (66_000,), generator=g,
                          dtype=torch.uint8).numpy().tobytes()
    n = 4096
    rows = [text[:n], bytes(n), noise[:n], mixed[:n], b"", text[:12],
            text[:13]]
    half = [len(r) // 2 for r in rows]
    cases = [(f"7 small rows, cap {cap}", rows, [cap] * len(rows), None, 1, 4)
             for cap in DS_SMALL_CAPS]
    cases += [
        ("7 small rows, cap n/2", rows, half, None, 1, 4),
        ("7 small rows, cap compress_bound(n)", rows,
         [compress_bound(len(r)) for r in rows], None, 1, 4),
        ("7 small rows, cap n/2, min_match 8", rows, half, None, 1, 8),
        ("7 small rows, cap n/2, acceleration 2", rows, half, None, 2, 4),
    ]
    plens = (1, 3, 4, 7, 100, n, W)
    cases.append((
        f"prefixes of {plens} bytes, cap n/2",
        [text[W + k:W + k + n] for k in plens], [n // 2] * len(plens),
        [text[W:W + k] for k in plens], 1, 4))
    cases.append(("prefixes before rows of 0, 12 and 13 bytes", rows[4:],
                  [64] * 3, [text[:100]] * 3, 1, 4))
    big = text[:256 << 10]
    cases.append(("256 KB rows (n == NS), cap n/2 and compress_bound",
                  [big, big], [len(big) // 2, compress_bound(len(big))], None,
                  1, 4))
    wrap = noise + text[:8000]
    caps = [65_290, 65_296, 65_300, 65_560, 66_270, 80_000]
    cases.append(("66,000 bytes of noise, then text: literal runs of 65,295 "
                  "and more", [wrap] * len(caps), caps, None, 1, 4))
    # the probe rounds of the warp parse: lanes sharing a table slot, skips
    # of 2 bytes and more, and the largest min_match and acceleration
    adverse = [slot_collisions(W, 8), slot_collisions(n, 9),
               noise_bytes(W, 10), text[:n]]
    for cap in ("n/2", "compress_bound(n)"):
        caps = [len(r) // 2 if cap == "n/2" else compress_bound(len(r))
                for r in adverse]
        cases.append((f"slot collisions, 64 KB of noise, text, cap {cap}",
                      adverse, caps, None, 1, 4))
        cases.append((f"the same, cap {cap}, min_match 12, acceleration 7",
                      adverse, caps, None, 7, 12))
    return cases


def corpus_rows(corpus: bytes, dev):
    """The corpus as [rows, 64 KB] uint8 on ``dev`` with its lengths."""
    import torch
    rows = torch.frombuffer(bytearray(corpus), dtype=torch.uint8) \
        .reshape(len(corpus) // W, W).to(dev)
    return rows, torch.full((rows.shape[0],), W, dtype=torch.int32,
                            device=dev)


def prefix_rows(rows):
    """Rows [block i-1 | block i] of the corpus rows, for i >= 1, with their
    source and prefix lengths (64 KB each)."""
    import torch
    joined = torch.cat([rows[:-1], rows[1:]], dim=1).contiguous()
    full = torch.full((joined.shape[0],), W, dtype=torch.int32,
                      device=rows.device)
    return joined, full, full.clone()


def kernel_b_payloads(rows, lens, group: int = 64):
    """Kernel B's payloads of every row ([B, M] uint8, [B] int32), encoded
    ``group`` rows at a time as the file layer does (the candidate tables
    of more rows at once take gigabytes)."""
    import torch

    from lz4_tpu_torch.kernels import encode_kernel as enc
    parts = [enc.encode_blocks(rows[i:i + group], lens[i:i + group])
             for i in range(0, rows.shape[0], group)]
    return (torch.cat([o for o, _ in parts]),
            torch.cat([n for _, n in parts]))


def in_windows(limit: int, fn, *args):
    """``fn(*args)`` with the linked decoders' int32 cells holding at most
    ``limit`` bytes of output at a time (``decode_kernel.CELL_WINDOW``): a
    chain longer than that decodes window after window, each reading the
    final bytes of the windows before it."""
    from lz4_tpu_torch.kernels import decode_kernel as dec

    saved = dec.CELL_WINDOW
    dec.CELL_WINDOW = limit
    try:
        return fn(*args)
    finally:
        dec.CELL_WINDOW = saved


def in_span_log(span_log: int, fn, *args):
    """``fn(*args)`` with kernel E's independent spans of 2^span_log
    sequences (``decode_kernel.SPAN_LOG``): more spans and walk steps."""
    from lz4_tpu_torch.kernels import decode_kernel as dec

    saved = dec.SPAN_LOG
    dec.SPAN_LOG = span_log
    try:
        return fn(*args)
    finally:
        dec.SPAN_LOG = saved


def in_groups(limit: int, fn, *args):
    """``fn(*args)`` with kernel A's or B's scratch cut to ``limit`` bytes
    (``encode_kernel.SCAN_SCRATCH``): the rows are scanned a group of a few
    rows at a time."""
    from lz4_tpu_torch.kernels import encode_kernel as enc

    saved = enc.SCAN_SCRATCH
    enc.SCAN_SCRATCH = limit
    try:
        return fn(*args)
    finally:
        enc.SCAN_SCRATCH = saved


def make_linked_case(enc, dev, data, prefix, mm, rs=1, zero=False, acc=1):
    """Kernel A's arguments for ``data`` as one linked stream behind
    ``prefix``: (on ``dev``, on the CPU), the candidate tables built on
    ``dev``."""
    import torch

    nb = -(-len(data) // W)
    host = torch.zeros((1, (nb + 1) * W), dtype=torch.uint8)
    if prefix:
        host[0, W - len(prefix):W] = torch.frombuffer(
            bytearray(prefix), dtype=torch.uint8)
    host[0, W:W + len(data)] = torch.frombuffer(bytearray(data),
                                                dtype=torch.uint8)
    lens = torch.tensor([[min(W, len(data) - k * W) for k in range(nb)]],
                        dtype=torch.int32)
    pre = torch.tensor([len(prefix)], dtype=torch.int32)
    delta, jump = enc.linked_tables(host.to(dev), nb, mm,
                                    pre.to(dev) if zero else None)
    args_card = (host.to(dev), lens.to(dev), pre.to(dev), delta, jump, acc,
                 mm, rs)
    args_cpu = (host, lens, pre, delta.cpu(), jump.cpu(), acc, mm, rs)
    return args_card, args_cpu


def edge_chunks(corpus: bytes) -> dict:
    """Kernel A's main-path shape (a 4 MB chunk behind its 64 KB window) on
    inputs at the greedy scan's extremes: all zeros (one match per block,
    run to matchlimit), one 7-byte period (the same), random bytes (no
    match: a 64 KB literal run per block), and the stdlib's charmap codecs
    (``encodings/cp*.py``, tables whose lines recur across files: long
    matches carry a walk of kernel A past where the next walk's parse
    ends, so their walks often fail to join).  name -> (chunk, window)."""
    import torch

    n = (4 << 20) + W
    period = mixed_bytes(7, corpus, 5)
    noise = torch.randint(0, 256, (n,), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    enc = Path(sysconfig.get_paths()["stdlib"]) / "encodings"
    tables = b"".join(p.read_bytes() for p in sorted(enc.glob("cp*.py")))
    out = {"zeros": bytes(n),
           "period7": (period * (n // 7 + 1))[:n],
           "random": noise.numpy().tobytes(),
           "charmaps": (tables * (n // max(len(tables), 1) + 1))[:n]}
    return {k: (v[W:], v[:W]) for k, v in out.items()}


def kernel_b_wide_rows(corpus: bytes):
    """Kernel B at its widest rows (256 KB, the -B5 split that
    ``compress_frame_device(..., block_size=256 << 10)`` and the SG 'large'
    layout send it): the corpus's first four 256 KB blocks, the fifth cut
    to 200,003 bytes, 256 KB of zeros, of one 7-byte period and of noise.
    (rows, lengths) on the CPU."""
    import torch

    n = 256 << 10
    period = mixed_bytes(7, corpus, 5)
    noise = torch.randint(0, 256, (n,), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(7))
    srcs = [corpus[i * n:(i + 1) * n] for i in range(4)]
    srcs += [corpus[4 * n:4 * n + 200_003], bytes(n),
             (period * (n // 7 + 1))[:n], noise.numpy().tobytes()]
    rows = torch.zeros((len(srcs), n), dtype=torch.uint8)
    for i, src in enumerate(srcs):
        rows[i, :len(src)] = torch.frombuffer(bytearray(src),
                                              dtype=torch.uint8)
    return rows, torch.tensor([len(x) for x in srcs], dtype=torch.int32)


def kernel_b_rows(corpus: bytes):
    """Kernel B's smoke rows: the corpus's first 64 rows of 64 KB, rows 5,
    6 and 7 cut to 60,000, 13 and 0 bytes.  (rows, lengths) on the CPU."""
    import torch

    rows = torch.frombuffer(bytearray(corpus[:64 * W]),
                            dtype=torch.uint8).reshape(64, W).clone()
    lens = torch.full((64,), W, dtype=torch.int32)
    lens[5], lens[6], lens[7] = 60_000, 13, 0
    rows[5, 60_000:] = 0
    rows[6, 13:] = 0
    rows[7] = 0
    return rows, lens


def device_ms(fn, reps: int = 5, setup=None) -> dict:
    """Device ms per launch of each kernel ``fn`` launches, from
    torch.profiler's CUDA activity over ``reps`` calls (the kernels alone,
    without the host work of their wrappers).  With ``setup``, each call
    is preceded by ``setup()`` outside the profiled span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    profs = []
    for _ in range(reps if setup else 1):
        if setup:
            setup()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(1 if setup else reps):
                fn()
            torch.cuda.synchronize()
        profs.append(prof)
    out = {}
    for e in (e for prof in profs for e in prof.key_averages()):
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0 and "kernel" in e.key:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return out


def encode_times(root: Path) -> int:
    """``--encode-times ROOT``: kernels A and B of the tree at ROOT (this
    checkout, or another one unpacked beside it) on the smoke's inputs:
    A on the main-path text chunk and on edge_chunks at min_match 8, B on
    kernel_b_rows at min_match 8 and 4.  Prints one JSON line of
    CUDA-event ms (mean of 10 calls after one warm-up), and ``A_corpus``:
    ms of A over every 4 MB chunk of the 64 MiB corpus, each behind its
    64 KB window, as compress_frame_device launches it at min_match 8 (the
    main path's A time per 64 MiB; mean of 3 passes), and, where the
    tree's kernel A has them, the same with its ``tails`` on
    (``A_text_tails``, ``A_corpus_tails``: what legacy compress launches);
    and ``peak_MiB``: the peak device memory of compress_frame_device on
    the corpus as independent 256 KB blocks (kernel B over 256 rows, with
    its tables)."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels import encode_kernel as enc

    if not Path(enc.__file__).resolve().is_relative_to(root.resolve()):
        raise SmokeFailure(f"imported {enc.__file__}, not from {root}")
    build.kernels_lib()
    cuda = torch.device("cuda")
    corpus = real_text_corpus(CORPUS_BYTES)
    chunks = {"text": (corpus[4 << 20:8 << 20],
                       corpus[(4 << 20) - W:4 << 20]),
              **edge_chunks(corpus)}
    res = {}
    tails = "tails" in inspect.signature(enc.scan_linked).parameters
    for what, (data, window) in chunks.items():
        card, _ = make_linked_case(enc, cuda, data, window, 8, zero=True)
        enc.scan_linked(*card)
        res[f"A_{what}"] = event_ms(
            lambda: [enc.scan_linked(*card) for _ in range(10)])[1] / 10
        if tails and what == "text":
            res["A_text_tails"] = event_ms(lambda: [enc.scan_linked(
                *card, tails=True) for _ in range(10)])[1] / 10
    main = [make_linked_case(enc, cuda, corpus[i:i + MB4],
                             corpus[max(i - W, 0):i], 8, zero=True)[0]
            for i in range(0, len(corpus), MB4)]
    for card in main:
        enc.scan_linked(*card)
    res["A_corpus"] = event_ms(lambda: [enc.scan_linked(*card) for _ in
                                        range(3) for card in main])[1] / 3
    if tails:
        res["A_corpus_tails"] = event_ms(lambda: [
            enc.scan_linked(*card, tails=True) for _ in range(3)
            for card in main])[1] / 3
    del main
    rows, lens = kernel_b_rows(corpus)
    rows, lens = rows.to(cuda), lens.to(cuda)
    for mm in (8, 4):
        delta, jump = enc.independent_tables(rows, mm)
        args = (rows, lens, delta, jump, 1, mm, 1)
        enc.scan_blocks(*args)
        res[f"B_mm{mm}"] = event_ms(
            lambda: [enc.scan_blocks(*args) for _ in range(10)])[1] / 10
    del rows, lens, delta, jump, args
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    D.compress_frame_device(corpus, FramePreferences(
        block_size_id=5, block_independent=True), block_size=256 << 10,
        device=cuda)
    res["peak_MiB"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(json.dumps({"encode_times": str(root), "device":
                    torch.cuda.get_device_name(0), **res}))
    return 0


def destsize_times(root: Path) -> int:
    """``--destsize-times ROOT``: kernels G and H of the tree at ROOT (this
    checkout, or another one unpacked beside it) on the smoke's inputs: G
    on the sg phase's '4k' and 'ragged' walks, H on the destsize phase's
    batches (the corpus as 1,024 rows of 64 KB at cap n/2, and rows [block
    i-1 | block i] behind their 64 KB prefix), both also on 16 MiB of
    noise (G as 4 KB iovecs into 4 KB buffers, H as 256 rows of 64 KB at
    cap n/2: long skip runs), and the SG walk over H (``sg_h_layout``
    through sg.sg_compress, one H launch per block).  Prints one JSON line:
    CUDA-event ms of each kernel call and wall ms of the walk, the median
    of 3 after one warm-up."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    from lz4_tpu_torch import sg
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels import destsize_kernel as dsk

    if not Path(dsk.__file__).resolve().is_relative_to(root.resolve()):
        raise SmokeFailure(f"imported {dsk.__file__}, not from {root}")
    build.kernels_lib()
    cuda = torch.device("cuda")
    corpus = real_text_corpus(CORPUS_BYTES)

    def median_ms(fn, wall=False):
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, ms = event_ms(fn)
            times.append((time.perf_counter() - t0) * 1e3 if wall else ms)
        return sorted(times)[1]

    res = {}
    noise = noise_bytes(SG_BYTES, 11)
    layouts = sg_layouts(corpus)
    layouts["noise"] = sg_layouts(noise + corpus[SG_BYTES:])["4k"]
    for lay in ("4k", "ragged", "noise"):
        _, ins, caps = layouts[lay]
        flat, ends = dsk.sg_chain_input(ins, cuda)
        res[f"G_{lay}"] = median_ms(
            lambda: dsk.sg_encode_chain(flat, ends, caps, sum(caps)))
    del layouts, flat
    for what, data in (("half", corpus), ("noise", noise)):
        rows, lens = corpus_rows(data, cuda)
        half = torch.clamp(lens // 2, min=64)
        res[f"H_{what}"] = median_ms(
            lambda: dsk.encode_blocks_dest_size(rows, lens, half))
    rows, lens = corpus_rows(corpus, cuda)
    joined, slens, wlens = prefix_rows(rows)
    res["H_prefix"] = median_ms(
        lambda: dsk.encode_blocks_dest_size(joined, slens, slens // 2, 1,
                                            wlens))
    del rows, joined
    ins, caps = sg_h_layout(corpus)
    res["sg_over_H_wall"] = median_ms(
        lambda: sg.sg_compress(ins, caps, dest_size_compress=(
            sg.dest_size_over_h(cuda, {})), device=cuda), wall=True)
    log(json.dumps({"destsize_times": str(root), "device":
                    torch.cuda.get_device_name(0), **res}))
    return 0


def decode_times(root: Path) -> int:
    """``--decode-times ROOT``: kernels E, F and D of the tree at ROOT (this
    checkout, or another one unpacked beside it) on the smoke's inputs,
    each written by ROOT's own port: E independent on the whole -B7 and
    legacy files and on the -B7 file's first 4 MB block, E linked on the
    -B5 linked and flushed chains, F on the sg phase's '4k' and 'ragged'
    chains, D linked on the main-path chunk (kernel A's 64 blocks behind
    their window), D batch on kernel B's 64 smoke rows at mm=8 and on its
    payloads of the corpus as 1,024 rows of 64 KB, D resumable on those at
    out_caps = 32,768 (each D shape also split per kernel by the
    profiler), and the wall of decompress_frame_device on the corpus as a
    -B4 frame (``b4_frame``).  Prints one JSON line of CUDA-event ms, the
    median of 3 after one warm-up (the wall: host clock, median of 3)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import sg
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels import decode_kernel as dec
    from lz4_tpu_torch.kernels import encode_kernel as enc

    if not Path(dec.__file__).resolve().is_relative_to(root.resolve()):
        raise SmokeFailure(f"imported {dec.__file__}, not from {root}")
    build.kernels_lib()
    cuda = torch.device("cuda")
    corpus = real_text_corpus(CORPUS_BYTES)

    def median_ms(fn):
        fn()
        return sorted(event_ms(fn)[1] for _ in range(3))[1]

    res = {}
    files = stream_files(corpus, cuda)
    for name, (_, flat, st, sz, sd, bs, linked, caps) in \
            stream_launches(files).items():
        flat_d = torch.frombuffer(bytearray(flat), dtype=torch.uint8).to(cuda)
        res[f"E_{name}"] = median_ms(lambda: dec.decode_stream_raw(
            flat_d, st, sz, sd, bs, 0, linked, caps))
    s7, n7, _ = _records(files["b7"], 7)
    b7_d = torch.frombuffer(bytearray(files["b7"]), dtype=torch.uint8).to(
        cuda)
    res["E_one_4mb"] = median_ms(lambda: dec.decode_stream_raw(
        b7_d, [s7[0]], [n7[0]], [0], MB4, 0, linked=False))
    del files, flat_d, b7_d
    for lay, (_, ins, caps) in sg_layouts(corpus).items():
        if lay == "large":
            continue
        total, _, outs = sg.sg_compress(ins, caps, device=cuda)
        _, payloads, sizes = sg.collect_chain(filled(outs, caps, total),
                                              [len(b) for b in ins])
        flat, bstart, clen = dec.join_payloads(payloads, cuda)
        res[f"F_{lay}"] = median_ms(lambda: dec.decode_blocks_sg_raw(
            flat, bstart, clen, sizes))
    card, _ = make_linked_case(enc, cuda, corpus[4 << 20:8 << 20],
                               corpus[(4 << 20) - W:4 << 20], 8, zero=True)
    out, olen = enc.scan_linked(*card)
    dl_args = (out.reshape(64, -1), olen.reshape(64), W, card[0][0, :W], W)
    res["D_linked"] = median_ms(lambda: dec.decode_blocks_linked(*dl_args))
    rows, lens = kernel_b_rows(corpus)
    b_out, b_olen = enc.encode_blocks(rows.to(cuda), lens.to(cuda), 1,
                                      min_match=8)
    c_rows, c_lens = corpus_rows(corpus, cuda)
    comp, clen = kernel_b_payloads(c_rows, c_lens)
    del c_rows
    caps = torch.full_like(clen, DS_DECODE_CAP)
    fill = torch.empty((1,), device=cuda)
    for key, fn in (
            ("D_batch_64", lambda: dec.decode_blocks(b_out, b_olen, W)),
            ("D_resumable_1024", lambda: dec.decode_blocks_dest_size(
                comp, clen, caps, DS_DECODE_CAP)),
            ("D_batch_1024", lambda: dec.decode_blocks(comp, clen, W))):
        res[key] = median_ms(fn)
        # (the profiler drops the first kernel it sees: a fill goes first)
        res[key + "_split"] = device_ms(lambda: (fill.zero_(), fn()))
    del comp
    frame = b4_frame(corpus, cuda)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = D.decompress_frame_device(frame)
        walls.append((time.perf_counter() - t0) * 1e3)
        if out != corpus:
            raise SmokeFailure("the -B4 frame does not decode to the corpus")
    res["B4_wall"] = sorted(walls)[1]
    res["B4_walls"] = walls
    log(json.dumps({"decode_times": str(root), "device":
                    torch.cuda.get_device_name(0), **res}))
    return 0


def hc_times(root: Path) -> int:
    """``--hc-times ROOT``: kernels I and C of the tree at ROOT (this
    checkout, or another one unpacked beside it), on the smoke's inputs:
    I on the corpus as 1,024 rows of 64 KB at level 9 (median of three
    launches) and on its first 64 rows at levels 3, 9 and 16 (median of
    three), its tables' time and peak device memory (``hc_sorted_tables``,
    or ``hc_tables`` in a tree without it), the payloads' ratio; in a tree
    whose kernel I takes prefixes, also on 1,024 rows [64 KB prefix | 64 KB
    source] (``hc_prefixed_batch``) at level 9, with their tables; each
    batch's bound (bytes at 3.35 TB/s); C on
    kernel A's main-path chunk (64 blocks) and on HC's 1,024-row group,
    per call with its wrapper (CUDA events around 20 calls, so a host sync
    in the wrapper counts) and its kernels alone (the profiler).  Prints
    one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels import encode_kernel as enc
    from lz4_tpu_torch.kernels import hc_kernel as hck
    from lz4_tpu_torch.kernels.pack_kernel import pack_frame_payloads

    if not Path(hck.__file__).resolve().is_relative_to(root.resolve()):
        raise SmokeFailure(f"imported {hck.__file__}, not from {root}")
    build.kernels_lib()
    cuda = torch.device("cuda")
    corpus = real_text_corpus(CORPUS_BYTES)
    nrows = len(corpus) // W
    rows = torch.frombuffer(bytearray(corpus), dtype=torch.uint8).reshape(
        nrows, W).to(cuda)
    lens = torch.full((nrows,), W, dtype=torch.int32, device=cuda)
    tables = getattr(hck, "hc_sorted_tables", None) or hck.hc_tables
    res = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tabs = tables(rows)
    torch.cuda.synchronize()
    res["tables_peak_MiB"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    res["tables_ms"] = sorted(event_ms(lambda: tables(rows))[1]
                              for _ in range(3))[1]

    def head(t, k):
        return [x[:k] for x in t] if isinstance(t, (tuple, list)) else t[:k]

    out, olen = hck.hc_scan(rows, lens, tabs, 9)
    res["ratio_level9"] = int(olen.sum()) / len(corpus)
    res["I_rows1024_level9"] = sorted(event_ms(
        lambda: hck.hc_scan(rows, lens, tabs, 9))[1] for _ in range(3))[1]
    for level in SWEEP_LEVELS:
        args = (rows[:64], lens[:64], head(tabs, 64), level)
        res[f"ratio_rows64_level{level}"] = int(
            hck.hc_scan(*args)[1].sum()) / (64 * W)
        res[f"I_rows64_level{level}"] = sorted(
            event_ms(lambda: hck.hc_scan(*args))[1] for _ in range(3))[1]
    del tabs
    if "window_lens" in inspect.signature(hck.hc_scan).parameters:
        # 1,024 rows [64 KB prefix | 64 KB source]: 32-bit tables
        pre = hc_prefixed_batch(cuda)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ptabs = tables(pre[0])
        torch.cuda.synchronize()
        res["tables_prefixed_peak_MiB"] = (torch.cuda.max_memory_allocated()
                                           - base) / 2**20
        res["tables_prefixed_ms"] = sorted(
            event_ms(lambda: tables(pre[0]))[1] for _ in range(3))[1]
        pout, polen = hck.hc_scan(*pre[:2], ptabs, 9, window_lens=pre[2])
        res["ratio_prefixed_level9"] = int(polen.sum()) / (nrows * W)
        res["I_prefixed_rows1024_level9"] = sorted(event_ms(
            lambda: hck.hc_scan(*pre[:2], ptabs, 9,
                                window_lens=pre[2]))[1] for _ in range(3))[1]
        # slot is read only at source positions, perm in full
        res["I_prefixed_bound_ms"] = (
            pre[0].numel() + 4 * ptabs[0].numel() + 4 * int(pre[1].sum())
            + 8 * nrows + int(polen.sum()) + 4 * nrows) / HBM_BYTES_PER_S * 1e3
        del pre, ptabs, pout, polen
    res["I_rows1024_bound_ms"] = (rows.numel() + 4 * rows.numel() + 4 * nrows
                                  + int(olen.sum()) + 4 * nrows
                                  ) / HBM_BYTES_PER_S * 1e3
    card, _ = make_linked_case(enc, cuda, corpus[4 << 20:8 << 20],
                               corpus[(4 << 20) - W:4 << 20], 8, zero=True)
    a_out, a_olen = enc.scan_linked(*card)
    packs = {"chunk": (a_out.reshape(64, -1), a_olen.reshape(64),
                       card[0][0, W:65 * W].view(64, W),
                       torch.full((64,), W, dtype=torch.int32, device=cuda)),
             "hc_group": (out, olen, rows, lens)}
    def calls(args, k):
        for _ in range(k):      # each result freed before the next call
            pack_frame_payloads(*args)

    for what, args in packs.items():
        pack_frame_payloads(*args)
        res[f"C_{what}_wrapper_ms"] = event_ms(lambda: calls(args, 20))[1] / 20
        res[f"C_{what}_kernel_ms"] = sum(device_ms(
            lambda: pack_frame_payloads(*args)).values())
    log(json.dumps({"hc_times": str(root), "device":
                    torch.cuda.get_device_name(0), **res}))
    return 0


def xxh_launch(build, kernel, rows, lens, reps: int = 20):
    """(CUDA-event ms per launch of kernel J or K, ``kernel`` "xxh32" or
    "xxh64", over ``reps`` launches in a row after a warm one; the launch)
    through its C entry point: the kernel alone, without the wrapper's
    fetch, and not counted as a launch of the wrapper."""
    import torch
    entry = getattr(build.kernels_lib(), f"lz4tt_{kernel}_rows")
    out = torch.empty((rows.shape[0],), device=rows.device,
                      dtype=torch.int32 if kernel == "xxh32" else torch.int64)

    def launch():
        build.check_launch(kernel, entry(
            rows.data_ptr(), rows.stride(0), lens.data_ptr(), rows.shape[1],
            0, out.data_ptr(), rows.shape[0],
            torch.cuda.current_stream().cuda_stream))
        return out

    launch()
    _, ms = event_ms(lambda: [launch() for _ in range(reps)])
    return ms / reps, launch


def xxh_times(root: Path) -> int:
    """``--xxh-times ROOT``: kernels J and K of the tree at ROOT (this
    checkout, or another one unpacked beside it) on the smoke's shapes: the
    corpus as 1,024 rows of 64 KB, its first 16 MiB as 4,096 pages of 4 KB
    and as rows of 77 bytes, 256 of its rows (16 MiB) kept in the card's
    L2 (timed right after a warm launch: about the per-row chain alone),
    and 1,023 rows of 64 KB that start one byte into a granule.  For each
    shape and kernel, in ms: ``kernel`` (the profiler's device time per
    launch through the C entry point, the L2 flushed before each launch
    but for the L2 shape), ``kernel_events`` (CUDA events around 20
    launches in a row: 16 MiB shapes stay in L2), ``call`` (CUDA events
    around one xxh32_batch or xxh64_batch call with its fetch, median of
    five), and whether the launch's digests equal the call's.  Prints one
    JSON line with the card's name and power limit."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root.resolve()))
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels import xxh32_kernel as x32
    from lz4_tpu_torch.kernels import xxh64_kernel as x64

    if not Path(x32.__file__).resolve().is_relative_to(root.resolve()):
        raise SmokeFailure(f"imported {x32.__file__}, not from {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    build.kernels_lib()
    cuda = torch.device("cuda")
    rows, lens = corpus_rows(real_text_corpus(CORPUS_BYTES), cuda)
    shapes = {"rows1024": (rows, lens), "pages4096": xxh_pages(rows),
              "rows77": xxh_rows77(rows),
              "l2_rows256": (rows[:256], lens[:256]),
              # every row one byte past a granule: the funnelled reads
              "rows1023_at1": (rows.reshape(-1)[1:1 - W].view(-1, W),
                               lens[1:])}
    kernels = {"xxh32": x32.xxh32_batch, "xxh64": x64.xxh64_batch}
    flush = torch.empty((256 << 20,), dtype=torch.uint8, device=cuda)
    res = {"power": smi}
    for shape, (r, n) in shapes.items():
        for kernel, batch in kernels.items():
            ms, launch = xxh_launch(build, kernel, r, n)
            res[f"{kernel}_{shape}_kernel_events"] = ms

            def cold():
                if shape != "l2_rows256":
                    flush.zero_()
                launch()

            res[f"{kernel}_{shape}_kernel"] = sum(
                ms for name, ms in device_ms(cold).items() if "xxh" in name)
            res[f"{kernel}_{shape}_call"] = sorted(
                event_ms(lambda: batch(r, n))[1] for _ in range(5))[2]
            # the smoke holds the digests against the plain versions; this
            # only shows a timing experiment that hashes nothing at random
            res[f"{kernel}_{shape}_launch_equals_call"] = bool(
                np.array_equal(launch().cpu().numpy().view(
                    np.uint32 if kernel == "xxh32" else np.uint64),
                    batch(r, n)))
    log(json.dumps({"xxh_times": str(root), "device":
                    torch.cuda.get_device_name(0), **res}))
    return 0


def event_ms(fn):
    """(fn's result, its CUDA-event ms)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, a.elapsed_time(b)


def resume_decode(comp, clen, cap: int, width: int, timer=None):
    """Decode every row of ``comp`` ([B, M] payloads, each decoding to at
    most ``width`` <= 64 KB bytes) in pieces of at most ``cap`` bytes with
    decode_blocks_dest_size: every round is fed comp[cons:] and the bytes
    produced so far as dictionary rows, until every row's source is used
    up.  A round in which no row moves (every sequence left is longer than
    the room) doubles the room of the next, as a caller with a larger
    buffer would.  Works on the card and, with CPU tensors, on the plain
    version.  Returns (out [B, width], produced [B], per-round (ms or None,
    room, rows still decoding, bytes produced)); raises on a corrupt row or
    when a round with ``width`` bytes of room moves nothing."""
    import torch

    from lz4_tpu_torch.kernels import decode_kernel as dec
    B, M = comp.shape
    dev = comp.device
    pos = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.int64, device=dev)
    total = torch.zeros((B, width), dtype=torch.uint8, device=dev)
    col_m = torch.arange(M, device=dev)
    col_w = torch.arange(width, device=dev)
    rounds = []
    while True:
        left = clen.long() - pos
        live = int((left > 0).sum())
        if not live:
            return total, done, rounds
        src = comp.gather(1, (col_m[None] + pos[:, None]).clamp(max=M - 1))
        # row i's dictionary: its done[i] bytes, right-aligned
        dict_rows = total.gather(
            1, (col_w[None] - (width - done[:, None])).clamp(min=0))
        args = (src, left.int(), torch.full((B,), cap, dtype=torch.int32,
                                            device=dev), cap, dict_rows,
                done.int())
        if timer is None:
            (out, olen, cons), ms = dec.decode_blocks_dest_size(*args), None
        else:
            (out, olen, cons), ms = timer(
                lambda: dec.decode_blocks_dest_size(*args))
        moved = bool((cons > 0).any())
        if bool((olen < 0).any()) or not (moved or cap < width):
            raise SmokeFailure("resumed decode: a corrupt row, or a round "
                               "without progress")
        r, c = (col_w[None, :cap] < olen[:, None]).nonzero(as_tuple=True)
        total[r, done[r] + c] = out[r, c]
        done += olen
        pos += cons
        rounds.append((ms, cap, live, int(olen.sum())))
        if not moved:
            cap = min(2 * cap, width)


def sg_h_layout(corpus: bytes):
    """(input iovecs, output caps) of the SG walk over kernel H."""
    data = corpus[:SG_H_BYTES]
    ins = [data[i:i + SG_H_IOVEC] for i in range(0, len(data), SG_H_IOVEC)]
    return ins, [SG_H_OUT] * (len(data) // SG_H_OUT + 2)


def xxh_pages(rows):
    """The first 16 MiB of the corpus rows as rows of 4 KB with lengths."""
    import torch
    pages = rows.reshape(-1)[:XXH_PAGE_BYTES].reshape(-1, XXH_PAGE)
    return pages, torch.full((pages.shape[0],), XXH_PAGE, dtype=torch.int32,
                             device=rows.device)


def xxh_rows77(rows):
    """The first 16 MiB of the corpus rows as rows of 77 bytes (most rows
    start at an address that is not a multiple of 4), with lengths."""
    import torch
    n = XXH_PAGE_BYTES // 77
    return rows.reshape(-1)[:n * 77].view(n, 77), torch.full(
        (n,), 77, dtype=torch.int32, device=rows.device)


def destsize_phase(corpus: bytes, dev) -> dict:
    """The destSize and checksum path at full size, through the kernel-level
    entry points its users call (see step 9 of the module's docstring).
    Every decoded byte must equal its source.  Returns the measured
    numbers."""
    import importlib.util

    import numpy as np
    import torch

    from lz4_tpu_torch import sg
    from lz4_tpu_torch.kernels import decode_kernel as dec
    from lz4_tpu_torch.kernels import destsize_kernel as dsk
    from lz4_tpu_torch.kernels.xxh32_kernel import xxh32_batch
    from lz4_tpu_torch.kernels.xxh64_kernel import (xxh64_batch,
                                                    xxh64_rows_plain)
    from lz4_tpu_torch.ops.xxhash import xxh32

    out = {}
    rows, lens = corpus_rows(corpus, dev)
    nrows = rows.shape[0]

    def check_blocks(what, src_rows, blocks, olen, consumed, caps, dicts):
        """Kernel D (batch mode) decodes every block, with out_caps =
        consumed, to exactly the first consumed bytes of its source."""
        if bool((olen > caps).any()) or bool((olen <= 0).any()):
            raise SmokeFailure(f"destsize phase: {what}: a block passes its "
                               "capacity or is empty")
        d_out, d_len = dec.decode_blocks(blocks, olen, W, out_caps=consumed,
                                         **dicts)
        cols = torch.arange(W, device=dev)[None]
        same = (d_out == src_rows) | (cols >= consumed[:, None])
        if not torch.equal(d_len, consumed) or not bool(same.all()):
            raise SmokeFailure(f"destsize phase: {what}: a block does not "
                               "decode to row[:consumed]")

    # H at cap = max(n // 2, 64), as the encode_dest_size cell of fullbench.py
    caps = torch.clamp(lens // 2, min=64)
    (blocks, olen, consumed), ms = event_ms(
        lambda: dsk.encode_blocks_dest_size(rows, lens, caps))
    check_blocks("cap n/2", rows, blocks, olen, consumed, caps, {})
    plain_total = int(consumed[1:].sum())
    out["h_half"] = {"ms": ms, "consumed": int(consumed.sum()),
                     "olen": int(olen.sum())}
    log(f"[destsize] kernel H, {nrows} rows of 64 KB, cap n/2: {ms:.3f} ms, "
        f"consumed {int(consumed.sum())} / olen {int(olen.sum())} = "
        f"{int(consumed.sum()) / int(olen.sum()):.4f}; every block decodes "
        "(kernel D, batch mode) to row[:consumed]")
    # H behind a prefix: rows [block i-1 | block i]
    joined, slens, wlens = prefix_rows(rows)
    caps = slens // 2
    (blocks, olen, consumed), ms = event_ms(
        lambda: dsk.encode_blocks_dest_size(joined, slens, caps,
                                            window_lens=wlens))
    check_blocks("prefixes", rows[1:], blocks, olen, consumed, caps,
                 {"dict_rows": rows[:-1], "dict_lens": wlens})
    if int(consumed.sum()) < plain_total:
        raise SmokeFailure("destsize phase: the prefix made the blocks cover "
                           "less source")
    out["h_prefix"] = {"ms": ms, "consumed": int(consumed.sum()),
                       "olen": int(olen.sum()),
                       "consumed_without_prefix": plain_total}
    log(f"[destsize] kernel H, {nrows - 1} rows [block i-1 | block i], cap "
        f"n/2: {ms:.3f} ms, consumed {int(consumed.sum())} (without the "
        f"prefix {plain_total}) / olen {int(olen.sum())} = "
        f"{int(consumed.sum()) / int(olen.sum()):.4f}; every block decodes "
        "with block i-1 as its dictionary row")
    del joined, blocks

    # D resumable: kernel B's payloads, 32 KB of room per round
    comp, clen = kernel_b_payloads(rows, lens)
    got, produced, rounds = resume_decode(comp, clen, DS_DECODE_CAP, W,
                                          timer=event_ms)
    if not torch.equal(got, rows) or not bool((produced == W).all()):
        raise SmokeFailure("destsize phase: the resumed decode's pieces are "
                           "not the corpus")
    out["resume"] = {"rounds": [{"ms": ms, "room": c, "rows": n, "bytes": b}
                                for ms, c, n, b in rounds]}
    log(f"[destsize] kernel D resumable, kernel B's {nrows} payloads at "
        f"out_caps {DS_DECODE_CAP}, resumed with dictionary rows: "
        f"{len(rounds)} rounds, " + ", ".join(
            f"{ms:.3f} ms ({n} rows, {b} bytes)" for ms, _, n, b in rounds)
        + "; the joined pieces are the corpus")
    del comp, got

    # J and K on the corpus rows and on 4 KB pages
    rows_h = rows.cpu().numpy()
    for what, (r, n) in (("rows of 64 KB", (rows, lens)),
                         ("pages of 4 KB", xxh_pages(rows))):
        h32, ms32 = event_ms(lambda: xxh32_batch(r, n))
        h64, ms64 = event_ms(lambda: xxh64_batch(r, n))
        width = r.shape[1]
        flat = rows_h.reshape(-1)[:r.numel()]
        host = np.array([xxh32(flat[i:i + width].tobytes(), 0)
                         for i in range(0, len(flat), width)], np.uint32)
        plain = xxh64_rows_plain(flat.reshape(-1, width), n.cpu().numpy(), 0)
        if not np.array_equal(h32, host) or not np.array_equal(h64, plain):
            raise SmokeFailure(f"destsize phase: a digest differs ({what})")
        out[f"xxh {what}"] = {"xxh32_ms": ms32, "xxh64_ms": ms64,
                              "rows": len(h32)}
        log(f"[destsize] {len(h32)} {what}: xxh32_batch {ms32:.3f} ms "
            f"({r.numel() / 1e6 / ms32:.1f} GB/s with the fetch), equal to "
            f"the host XXH32 of every row; xxh64_batch {ms64:.3f} ms "
            f"({r.numel() / 1e6 / ms64:.1f} GB/s), equal to its plain "
            "version on every row")

    # H as the compressor of an SG walk; kernel E decodes its chain
    ins, caps = sg_h_layout(corpus)
    tally = {}
    t0 = time.perf_counter()
    total, used, outs = sg.sg_compress(
        ins, caps, dest_size_compress=sg.dest_size_over_h(dev, tally),
        device=dev)
    t_c = time.perf_counter() - t0
    content = sum(map(len, ins))
    if used != content or total <= 0:
        raise SmokeFailure(f"destsize phase: the SG walk over kernel H "
                           f"compressed {used} of {content} bytes")
    t0 = time.perf_counter()
    n, back = sg.sg_decompress(filled(outs, caps, total),
                               [len(b) for b in ins], device=dev)
    t_d = time.perf_counter() - t0
    if n != content or back != ins:
        raise SmokeFailure("destsize phase: the SG walk over kernel H does "
                           "not round-trip")
    if 2 * tally["stops"] <= tally["blocks"]:
        raise SmokeFailure(f"destsize phase: only {tally['stops']} of "
                           f"{tally['blocks']} SG blocks stopped at their "
                           "capacity")
    out["sg_h"] = {"compress_s": t_c, "decompress_s": t_d, **tally,
                   "frame_bytes": total, "content_bytes": content}
    log(f"[destsize] SG walk over kernel H, {len(ins)} x 128 KB -> "
        f"{SG_H_OUT >> 10} KB buffers: {total} bytes (ratio "
        f"{total / content:.6f}), {tally['blocks']} blocks, "
        f"{tally['stops']} capacity stops, sg_compress {t_c:.3f} s, "
        f"sg_decompress (kernel E) {t_d:.3f} s, byte-exact")

    # the example, in this process
    script = REPO / "examples" / "torch_port" / "dest_size_resume_torch.py"
    spec = importlib.util.spec_from_file_location("dest_size_resume_torch",
                                                  script)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    if example.main(["--device", str(dev)]) != 0:
        raise SmokeFailure("examples/torch_port/dest_size_resume_torch.py "
                           "failed")
    return out


# -- legacy compress (kernels A and I, their tails) ---------------------------
LEGACY_SETTINGS = (("-l -1", 1), ("-l -9", 9))


def legacy_phase(corpus: bytes, dev) -> dict:
    """Legacy compress at full size, through the entry point a user calls:
    the corpus through io.compress_stream with -l -1 (kernel A, 8 MB slices
    as linked chains) and -l -9 (kernel I), each decoded by
    decompress_legacy_device (kernel E) to the corpus.  Returns the ratio
    and walls of each."""
    import io

    import torch

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import io as tio
    res = {}
    mb = len(corpus) / 1e6
    for flags, level in LEGACY_SETTINGS:
        dst = io.BytesIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, w = tio.compress_stream(io.BytesIO(corpus), dst, tio.IoPrefs(
            legacy=True, level=level, verbosity=0), len(corpus), device=dev)
        t1 = time.perf_counter()
        out, used = D.decompress_legacy_device(dst.getvalue(), device=dev)
        t2 = time.perf_counter()
        if (r, w) != (len(corpus), len(dst.getvalue())) or out != corpus \
                or used != w:
            raise SmokeFailure(f"legacy phase: {flags} does not round-trip")
        res[flags] = {"ratio": w / len(corpus), "bytes": w,
                      "compress_s": t1 - t0, "decompress_s": t2 - t1}
        log(f"[legacy] {len(corpus) >> 20} MiB corpus, io.compress_stream "
            f"{flags}: ratio {w / len(corpus):.6f} ({w} bytes), compress "
            f"{mb / (t1 - t0):.1f} MB/s ({t1 - t0:.3f} s), "
            f"decompress_legacy_device {mb / (t2 - t1):.1f} MB/s "
            f"({t2 - t1:.3f} s), byte-exact")
        del out
    return res


# -- the library API: block, stream and frame (step 15) -----------------------
API_SIZES = (4 << 10, 64 << 10, 256 << 10, 1 << 20)   # the one-shot slices
API_TIMED = (4 << 10, 64 << 10)          # the sizes timed call by call
API_CHUNKS = 64                          # chunks of each stream session
API_MATRIX_BYTES = 16 << 20              # the FrameCompressor matrix's input
API_HC_BYTES = 256 << 10                 # its HC cell (level 9)
API_FEED = (1 << 10, 1 << 20)            # FrameDecompressor's slices
# (block_size_id, independent, checksums, auto_flush, flush every k
# updates, level, bytes): ids 4-7, both block modes, and an HC cell
API_MATRIX = ((4, True, False, False, 0, 0, API_MATRIX_BYTES),
              (4, False, True, False, 3, 0, API_MATRIX_BYTES),
              (5, True, True, False, 0, 0, API_MATRIX_BYTES),
              (5, False, False, True, 0, 0, API_MATRIX_BYTES),
              (6, True, False, False, 2, 0, API_MATRIX_BYTES),
              (6, False, True, False, 0, 0, API_MATRIX_BYTES),
              (7, True, True, False, 0, 0, API_MATRIX_BYTES),
              (7, False, False, False, 0, 0, API_MATRIX_BYTES),
              (5, True, True, False, 0, 9, API_HC_BYTES))


def api_outcome(fn, *args, **kwargs):
    """("ok", result) or ("error", message) of an API call."""
    from lz4_tpu_torch.block import Lz4BlockError
    from lz4_tpu_torch.frame import Lz4FrameError
    try:
        return "ok", fn(*args, **kwargs)
    except (Lz4BlockError, Lz4FrameError) as e:
        return "error", str(e)


def api_adversarial(text: bytes):
    """Malformed and edge blocks for the one-shot decoders: truncations,
    bit flips, a literal-length bomb, a wild offset, offset 0, an offset
    before the output, a block cut right after a match, a long overlapping
    match, and the empty block."""
    good = (lz4_seq(text[:300], 7, 600) + lz4_seq(text[300:340], 299, 70)
            + lz4_seq(text[340:400]))
    rng = random.Random(15)
    cases = [good, b"", long_match(60_000, text[:7])]
    cases += [good[:rng.randrange(1, len(good))] for _ in range(6)]
    for _ in range(6):
        b = bytearray(good)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        cases.append(bytes(b))
    return cases + [
        b"\xf0" + b"\xff" * 40 + good, bytes([0x12, 0xAA, 0xFF, 0xFF]) + good,
        b"\x20ab\x00\x00" + lz4_seq(b"tail!"),
        lz4_seq(b"ab", 5_000, 20) + lz4_seq(b"x"), lz4_seq(b"ab", 2, 20)]


def api_calls(corpus: bytes, frames: dict):
    """Step 15's calls: (what, fn), fn(device, check) returning what the
    calls gave (bytes, lengths, or the errors they raised).  With
    ``check``, fn also holds its round trips against the input
    (SmokeFailure)."""
    from lz4_tpu_torch import block as B
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import frame as F
    from lz4_tpu_torch import stream as S
    from lz4_tpu_torch.frame import FramePreferences

    def need(ok, what):
        if not ok:
            raise SmokeFailure(f"api phase: {what}")

    calls = []
    base = 5 << 20
    for n in API_SIZES:
        s = corpus[base:base + n]
        base += n

        def one_shot(dev, check, s=s, n=n):
            c = B.compress_fast(s, device=dev)
            res = (c, B.compress_default(s, len(c) - 1, device=dev),
                   B.compress_fast(s, 4, device=dev),
                   B.compress_dest_size(s, n // 2, device=dev),
                   B.decompress_safe(c, n, device=dev),
                   B.decompress_safe(c, 2 ** 31 - 1, device=dev),
                   B.decompress_safe_partial(c, n // 3 + 7, device=dev),
                   B.decompress_dest_size(c, n // 2, device=dev),
                   B.decompress_fast(c + b"tail", n, device=dev))
            if check:
                (blk, took), (out, used) = res[3], res[7]
                need(res[1] == b"" and res[4] == res[5] == s
                     and res[6] == s[:n // 3 + 7]
                     and res[8] == (s, len(c))
                     and B.decompress_safe(res[2], n, device=dev) == s
                     and B.decompress_safe(blk, took, device=dev) == s[:took]
                     and s.startswith(out) and 0 < used <= len(c),
                     f"a one-shot call on {n} bytes does not round-trip")
            return res
        calls.append((f"one-shot calls on {n >> 10} KB", one_shot))

    bad = api_adversarial(corpus[:W])

    def adversarial(dev, check):
        out = []
        for c in bad:
            out.append(api_outcome(B.decompress_safe, c, W, device=dev))
            out.append(api_outcome(B.decompress_fast, c, 1_070, device=dev))
            out += [api_outcome(B.decompress_safe_partial, c, t, device=dev)
                    for t in (0, 5, 350, 10_000)]
            out += [api_outcome(B.decompress_dest_size, c, cap, device=dev)
                    for cap in (0, 100, W)]
        if check:
            need(out[0][0] == "ok" and out[9][0] == "error",
                 "the adversarial set's first two verdicts are wrong")
        return out
    calls.append((f"the decoders on {len(bad)} adversarial blocks",
                  adversarial))

    rng = random.Random(16)
    sizes = [rng.randint(4 << 10, 96 << 10) for _ in range(API_CHUNKS)]
    ends = [sum(sizes[:i + 1]) for i in range(API_CHUNKS)]
    text = corpus[16 << 20:(16 << 20) + ends[-1]]
    chunks = [text[e - z:e] for e, z in zip(ends, sizes)]
    for discipline in ("double buffer", "ring buffer"):
        def session(dev, check, discipline=discipline):
            enc = S.BlockCompressStream(device=dev)
            dec = S.BlockDecompressStream(corpus[:W], device=dev)
            enc.load_dict(corpus[:W])
            slots = [bytearray(96 << 10), bytearray(96 << 10)]
            ring, at = bytearray(256 << 10), 0
            blocks, out = [], []
            for i, chunk in enumerate(chunks):
                if discipline == "double buffer":
                    slots[i % 2][:len(chunk)] = chunk
                    view = bytes(slots[i % 2][:len(chunk)])
                else:
                    at = 0 if at + len(chunk) > len(ring) else at
                    ring[at:at + len(chunk)] = chunk
                    view = bytes(ring[at:at + len(chunk)])
                    at += len(chunk)
                if i % 8 != 7:
                    blocks.append(enc.compress_continue(view))
                    out.append(dec.decompress_continue(blocks[-1],
                                                       len(view)))
                    continue
                # the destSize forms: a third of the chunk's room, the
                # block decoded in two resumed pieces, then the rest
                used, blk = enc.compress_dest_size_continue(view,
                                                            len(view) // 3)
                cons, first = dec.decompress_dest_size_continue(
                    blk, used // 2 + 1)
                cons2, second = dec.decompress_dest_size_continue(
                    blk[cons:], used)
                blocks.append(blk)
                out += [first, second]
                need(cons + cons2 == len(blk), "a resumed destSize "
                     "decode does not consume its block")
                if used < len(view):
                    blocks.append(enc.compress_continue(view[used:]))
                    out.append(dec.decompress_continue(blocks[-1],
                                                       len(view) - used))
            if check:
                need(b"".join(out) == text, f"the {discipline} session "
                     "does not round-trip")
            return blocks, out, enc.save_dict()
        calls.append((f"a stream session of {API_CHUNKS} chunks of 4-96 KB "
                      f"({discipline})", session))

    for name, (frame, want) in frames.items():
        def feed(dev, check, frame=frame, want=want):
            rng = random.Random(17)
            d, pos, res, out = F.FrameDecompressor(device=dev), 0, [], []
            while not d.finished:
                used, got = d.feed(frame[pos:pos + rng.randint(*API_FEED)])
                if not used:
                    raise SmokeFailure("api phase: a feed consumed nothing")
                pos += used
                res.append((used, len(got), d.src_hint))
                out.append(got)
            content = b"".join(out)
            if check:
                need(content == want and pos == len(frame)
                     and D.decompress_frame_device(frame, device=dev)[0]
                     == content, f"FrameDecompressor on the {name} frame "
                     "differs from the corpus or decompress_frame_device")
            return res, content
        calls.append((f"FrameDecompressor fed the {name} frame in slices of "
                      "1 KB-1 MiB", feed))

    for bsid, indep, sums, auto, every, level, nbytes in API_MATRIX:
        src = corpus[24 << 20:(24 << 20) + nbytes]
        prefs = FramePreferences(
            block_size_id=bsid, block_independent=indep,
            block_checksum=sums, content_checksum=sums, auto_flush=auto,
            content_size=len(src) if sums else None, level=level)
        what = (f"FrameCompressor -B{bsid} "
                f"{'independent' if indep else 'linked'}"
                f"{' checksums' if sums else ''}"
                f"{' auto_flush' if auto else ''}"
                f"{f' flush every {every}' if every else ''}"
                f"{f' level {level}' if level else ''} on "
                f"{len(src) >> 10} KB")

        def matrix(dev, check, src=src, prefs=prefs, every=every):
            rng = random.Random(18)
            comp = F.FrameCompressor(prefs, device=dev)
            parts, pos, k = [comp.begin()], 0, 0
            while pos < len(src):
                n = rng.randint(1 << 10, 3 << 20)
                parts.append(comp.update(src[pos:pos + n]))
                pos, k = pos + n, k + 1
                if every and k % every == 0:
                    parts.append(comp.flush())
            frame = b"".join(parts + [comp.end()])
            if check:
                need(D.decompress_frame_device(frame, device=dev)
                     == (src, len(frame)), f"{prefs} does not round-trip")
            return frame
        calls.append((what, matrix))
    return calls


def api_phase(corpus: bytes, frames: dict, dev):
    """Step 15, after the counters were reset: every call of
    ``api_calls`` on the card (its round trips held against the input).
    Returns (what the calls gave, their walls)."""
    import torch
    results, walls = [], {}
    for what, fn in api_calls(corpus, frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(fn(dev, True))
        walls[what] = time.perf_counter() - t0
        log(f"[api] {what}: {walls[what]:.3f} s on the card, round trips "
            "byte-exact")
    return results, walls


def api_plain_check(corpus: bytes, frames: dict, results) -> None:
    """Step 15's calls again through the port's plain route on the CPU:
    every result must equal the card's (tolerance 0)."""
    for (what, fn), got in zip(api_calls(corpus, frames), results):
        t0 = time.perf_counter()
        if fn("cpu", False) != got:
            raise SmokeFailure(f"api phase: {what} differs from the plain "
                               "route on the CPU")
        log(f"[api] {what}: equal to the plain route on the CPU "
            f"({time.perf_counter() - t0:.1f} s)")


def call_times(fn, n: int, reps: int = 9, setup=None) -> dict:
    """One call's wall (the median of ``reps`` calls after 2), the span of
    CUDA events recorded around it, and the device time of the kernels it
    launches (the profiler, per call over 5), in microseconds, with MB/s of
    the wall for ``n`` bytes.  With ``setup``, each call is preceded by
    ``setup()``, outside every timed span."""
    import statistics

    import torch
    for _ in range(2):
        if setup:
            setup()
        fn()
    walls, spans = [], []
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b))
    wall = statistics.median(walls)
    kernel = sum(device_ms(fn, reps=5, setup=setup).values())
    return {"wall_us": wall * 1e6, "kernel_us": kernel * 1e3,
            "event_us": statistics.median(spans) * 1e3,
            "mbs": n / 1e6 / wall}


def api_times(corpus: bytes, dev, card: str) -> dict:
    """Step 15's per-call times at 4 KB and 64 KB: each function's wall
    (the median of 9 calls after 2), the span of CUDA events recorded
    around it, and the device time of the kernels it launches (the
    profiler, per call over 5), in microseconds, with MB/s of the wall;
    and the two routes for the linked blocks one feed
    completes, on 1, 8 and 64 blocks of a -B4 linked frame: kernel E
    behind a window from the host (``decode_stream_runs``, what
    FrameDecompressor runs) and kernel D's linked mode behind a window on
    the device (``decode_blocks_linked``)."""
    from lz4_tpu_torch import block as B
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import frame as F
    from lz4_tpu_torch import stream as S
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.kernels.common import to_host
    from lz4_tpu_torch.kernels.decode_kernel import decode_blocks_linked

    timed = call_times

    out = {"card": card, "calls": {}, "linked_routes": {}}
    for n in API_TIMED:
        s = corpus[(40 << 20):(40 << 20) + n]
        c = B.compress_fast(s, device=dev)
        enc = S.BlockCompressStream(device=dev)
        enc.load_dict(corpus[:W])
        sblk = enc.compress_continue(s)
        dec = S.BlockDecompressStream(corpus[:W], device=dev)
        fc = F.FrameCompressor(FramePreferences(block_size_id=4,
                                                auto_flush=True), device=dev)
        fc.begin()
        prefs = FramePreferences(block_size_id=4)
        frame = F.compress_frame(s, prefs, device=dev)
        fns = {
            "compress_default": lambda: B.compress_default(s, device=dev),
            "compress_dest_size": lambda: B.compress_dest_size(
                s, n // 2, device=dev),
            "decompress_safe": lambda: B.decompress_safe(c, n, device=dev),
            "decompress_safe_partial": lambda: B.decompress_safe_partial(
                c, n // 2, device=dev),
            "decompress_dest_size": lambda: B.decompress_dest_size(
                c, n // 2, device=dev),
            "decompress_fast": lambda: B.decompress_fast(c, n, device=dev),
            "BlockCompressStream.compress_continue":
                lambda: enc.compress_continue(s),
            "BlockCompressStream.compress_dest_size_continue":
                lambda: enc.compress_dest_size_continue(s, n // 2),
            "BlockDecompressStream.decompress_continue":
                lambda: dec.decompress_continue(sblk, n),
            "BlockDecompressStream.decompress_dest_size_continue":
                lambda: dec.decompress_dest_size_continue(sblk, n // 2),
            "FrameCompressor.update (auto_flush)": lambda: fc.update(s),
            "FrameDecompressor.feed (one frame)": lambda:
                F.FrameDecompressor(device=dev).feed(frame),
            "compress_frame": lambda: F.compress_frame(s, prefs,
                                                       device=dev),
            "decompress_frame": lambda: F.decompress_frame(frame,
                                                           device=dev),
        }
        for name, fn in fns.items():
            t = timed(fn, n)
            out["calls"].setdefault(name, {})[f"{n >> 10} KB"] = t
            log(f"[api] {name} on {n >> 10} KB: {t['wall_us']:.1f} us a "
                f"call ({t['mbs']:.1f} MB/s), kernels {t['kernel_us']:.1f} "
                f"us, CUDA events around the call {t['event_us']:.1f} us")
    content = corpus[:5 << 20]
    recs = frame_payloads(D.compress_frame_device(
        content, FramePreferences(block_size_id=4), device=dev), 7)
    for nb in (1, 8, 64):
        k0 = 4
        pay = [p for p, _ in recs[k0:k0 + nb]]
        stored = [st for _, st in recs[k0:k0 + nb]]
        sizes = [len(p) for p in pay]
        starts = [sum(sizes[:i]) for i in range(nb)]
        window = content[(k0 - 1) * W:k0 * W]
        want = content[k0 * W:(k0 + nb) * W]
        win_dev = D.window_tensor(window, dev)

        def e_route():
            return D.decode_stream_runs(
                b"".join(pay), starts, sizes, stored, [W] * nb, W, True, dev,
                window=window)[0]

        def d_route():
            rows, lens = D.byte_rows([D._literal_block(p) if st else p
                                      for p, st in zip(pay, stored)],
                                     max(sizes), dev)
            res, olen = decode_blocks_linked(rows, lens, W,
                                             init_window=win_dev,
                                             init_window_len=W)
            return to_host(res).tobytes()
        if e_route() != want or d_route() != want:
            raise SmokeFailure("api phase: a linked route differs")
        out["linked_routes"][f"{nb} blocks"] = {
            "E (decode_stream_runs)": timed(e_route, nb * W),
            "D linked (decode_blocks_linked)": timed(d_route, nb * W)}
        log(f"[api] linked feed of {nb} blocks: "
            + "; ".join(f"{k} {v['wall_us']:.1f} us ({v['kernel_us']:.1f} us "
                        "in kernels)"
                        for k, v in out["linked_routes"][
                            f"{nb} blocks"].items()))
    # independent 4 MB blocks: kernel D's batch mode (a row each) against
    # kernel E's independent mode (FrameDecompressor's route past 64 KB)
    big = corpus[:16 << 20]
    recs = frame_payloads(F.compress_frame(big, FramePreferences(
        block_size_id=7, block_independent=True), device=dev), 7)
    bs = 4 << 20
    out["independent_routes"] = {}
    for nb in (1, 4):
        pay = [p for p, _ in recs[:nb]]
        sizes = [len(p) for p in pay]
        starts = [sum(sizes[:i]) for i in range(nb)]
        want = big[:nb * bs]

        def e_route():
            return D.decode_stream_runs(b"".join(pay), starts, sizes,
                                        [False] * nb, [bs] * nb, bs, False,
                                        dev)[0]

        def d_route():
            rows, lens = D.byte_rows(pay, max(sizes), dev)
            return to_host(D.decode_blocks(rows, lens, bs)[0]).tobytes()
        if e_route() != want or d_route() != want:
            raise SmokeFailure("api phase: an independent route differs")
        out["independent_routes"][f"{nb} blocks of 4 MB"] = {
            "E (decode_stream_runs)": timed(e_route, nb * bs),
            "D batch (decode_blocks)": timed(d_route, nb * bs)}
        log(f"[api] independent feed of {nb} blocks of 4 MB: "
            + "; ".join(f"{k} {v['wall_us']:.1f} us ({v['kernel_us']:.1f} "
                        "us in kernels)"
                        for k, v in out["independent_routes"][
                            f"{nb} blocks of 4 MB"].items()))
    return out


# -- the single-card envelope: frames past 2 GiB, SG layouts outside G and F --
ENV_BLOCK = 4 << 20                # the frames' block size (-B7)
ENV_LEAD_BLOCKS = 500              # stored noise blocks before the text
ENV_TAIL_BLOCKS = 20               # and after it
ENV_TEXT_COPIES = 4                # the corpus's 16 blocks, this many times
SG_PARTIAL = 3 * (1 << 20) + 12345  # the partial walk's source_size


def envelope_frame(text_blocks, linked: bool, noise: bytes):
    """A -B7 frame of just over 2 GiB of raw bytes: ENV_LEAD_BLOCKS stored
    blocks of noise, ENV_TEXT_COPIES copies of ``text_blocks`` ((payload,
    content) of the corpus's 4 MB blocks, compressed), ENV_TAIL_BLOCKS more
    of noise; independent or linked.  Kernel E's int32 input puts a cut
    among the text blocks; in a linked frame the block after the cut is
    one whose matches reach into the block before (not the first of a
    copy), moving the lead by a block where needed.  Returns (frame,
    content, the index of the first block after each cut)."""
    import numpy as np

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import spec
    from lz4_tpu_torch.frame import FramePreferences, encode_frame_header
    header = encode_frame_header(FramePreferences(
        block_size_id=7, block_independent=not linked))
    n_text = len(text_blocks)
    for lead in range(ENV_LEAD_BLOCKS, ENV_LEAD_BLOCKS + 4):
        kinds = ([None] * lead + list(range(n_text)) * ENV_TEXT_COPIES
                 + [None] * ENV_TAIL_BLOCKS)
        sizes = [ENV_BLOCK if k is None else len(text_blocks[k][0])
                 for k in kinds]
        starts = (len(header) + 4
                  + np.cumsum([0] + [4 + n for n in sizes[:-1]])).tolist()
        bounds = D._runs(starts, sizes, [ENV_BLOCK] * len(sizes),
                         W if linked else 0)
        cuts = bounds[1:-1]
        if cuts and all(kinds[c] is not None and kinds[c - 1] is not None
                        and (not linked or kinds[c] != 0) for c in cuts):
            break
    else:
        raise SmokeFailure("no layout puts every cut among the text blocks")
    records, content = [header], []
    at = 0
    for k in kinds:
        if k is None:
            piece = noise[at:at + ENV_BLOCK]
            at += ENV_BLOCK
            records += [(ENV_BLOCK | spec.UNCOMPRESSED_BIT).to_bytes(
                4, "little"), piece]
            content.append(piece)
        else:
            payload, text = text_blocks[k]
            records += [len(payload).to_bytes(4, "little"), payload]
            content.append(text)
    records.append(bytes(4))
    return b"".join(records), b"".join(content), cuts


def envelope_inputs(corpus: bytes, dev):
    """The text blocks of the envelope frames: the main path's linked 64 KB
    chain of the corpus merged per 4 MB (each block's first matches reach
    into the block before), the corpus's 4 MB slices, and the noise of the
    stored blocks."""
    import numpy as np

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.legacy import merged_blocks
    linked_frame = D.compress_frame_device(
        corpus, FramePreferences(block_size_id=4), device=dev)
    linked_blocks = merged_blocks(frame_payloads(linked_frame, 7),
                                  ENV_BLOCK // W)
    texts = [corpus[i:i + ENV_BLOCK] for i in range(0, len(corpus),
                                                     ENV_BLOCK)]
    noise = np.random.default_rng(2024).bytes(
        (ENV_LEAD_BLOCKS + 3 + ENV_TAIL_BLOCKS) * ENV_BLOCK)
    return linked_blocks, texts, noise


def envelope_phase(corpus: bytes, b7_blocks, dev, sg_layout) -> dict:
    """The layouts lz4_tpu hands to its host codec, on the card through the
    entry points a user calls: an independent -B7 frame and a linked 4 MB
    frame of just over 2 GiB through decompress_frame_device (kernel E in
    runs, matches of the linked frame reaching across each cut), compared
    with the content rebuilt on the host; an SG walk of a partial source
    over kernel H; a walk with dsk.MAX_TOTAL patched to 1 MiB (over H,
    equal to the explicit H callback's frame); the '4k' chain decoded with
    MAX_DEVICE_CONTENT and STREAM_MAX_INPUT patched down (kernel E in
    several runs),
    equal to kernel F's answer.  Returns the walls."""
    import torch

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import sg
    from lz4_tpu_torch.kernels import decode_kernel as dec
    from lz4_tpu_torch.kernels import destsize_kernel as dsk
    from lz4_tpu_torch.kernels.common import LAUNCHES
    from lz4_tpu_torch.kernels.decode_kernel import decode_block_plain
    res = {}
    # the text blocks: kernel B's 256 KB payloads merged per 4 MB
    # (independent), and the linked chain's
    linked_blocks, texts, noise = envelope_inputs(corpus, dev)
    for name, blocks, linked in (("-B7 independent", b7_blocks, False),
                                 ("-B7 -BD linked", linked_blocks, True)):
        frame, content, cuts = envelope_frame(list(zip(blocks, texts)),
                                              linked, noise)
        if linked:
            # the block after each cut does not decode without its window
            for c in cuts:
                k = (c - ENV_LEAD_BLOCKS) % len(texts)
                if decode_block_plain(blocks[k], len(blocks[k]),
                                      ENV_BLOCK)[0] >= 0:
                    raise SmokeFailure(f"envelope: block {c} after a cut "
                                       "needs no window")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, used = D.decompress_frame_device(frame, device=dev)
        wall = time.perf_counter() - t0
        if used != len(frame) or out != content:
            raise SmokeFailure(f"envelope: the {len(frame)}-byte {name} "
                               "frame does not decode to its content")
        key = "b7_linked" if linked else "b7"
        res[key] = {"frame_bytes": len(frame), "content_bytes": len(content),
                    "runs": len(cuts) + 1, "cuts": cuts, "wall_s": wall}
        log(f"[envelope] {name} frame of {len(frame)} bytes "
            f"({len(frame) / 2**30:.3f} GiB), {len(content)} bytes of "
            f"content, kernel E in {len(cuts) + 1} runs (cut before block "
            f"{cuts}): decompress_frame_device {len(content) / 1e6 / wall:.1f}"
            f" MB/s ({wall:.3f} s), byte-exact")
        del frame, content, out
    del noise
    # SG: a partial-source walk over H, and a walk past dsk.MAX_TOTAL
    ins, caps = sg_h_layout(corpus)
    data = b"".join(ins)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, consumed, outs = sg.sg_compress(ins, caps, source_size=SG_PARTIAL,
                                           device=dev)
    t1 = time.perf_counter()
    n, dec_outs = sg.sg_decompress(filled(outs, caps, total), [consumed],
                                   device=dev)
    t2 = time.perf_counter()
    if consumed != SG_PARTIAL or total <= 0 or \
            (n, dec_outs) != (consumed, [data[:consumed]]):
        raise SmokeFailure("envelope: the partial SG walk over H does not "
                           "round-trip")
    res["sg_partial_h"] = {"total_out": total, "consumed": consumed,
                           "compress_s": t1 - t0, "decompress_s": t2 - t1}
    log(f"[envelope] SG partial walk over H: {consumed} of {len(data)} "
        f"bytes as 128 KB iovecs into 32 KB buffers, {total} bytes (ratio "
        f"{total / consumed:.6f}), sg_compress {consumed / 1e6 / (t1 - t0):.1f}"
        f" MB/s ({t1 - t0:.3f} s), sg_decompress ({t2 - t1:.3f} s), "
        f"byte-exact")
    want = sg.sg_compress(ins, caps,
                          dest_size_compress=sg.dest_size_over_h(dev))
    saved = dsk.MAX_TOTAL
    dsk.MAX_TOTAL = min(1 << 20, len(data) - 1)
    try:
        t0 = time.perf_counter()
        got = sg.sg_compress(ins, caps, device=dev)
        wall = time.perf_counter() - t0
    finally:
        dsk.MAX_TOTAL = saved
    if got != want or got[1] != len(data):
        raise SmokeFailure("envelope: the SG walk past MAX_TOTAL differs "
                           "from the walk over the H callback")
    res["sg_past_max_total"] = {"total_out": got[0], "compress_s": wall}
    log(f"[envelope] SG walk of {len(data)} bytes with MAX_TOTAL at 1 MiB: "
        f"over H, equal to the explicit H callback's frame ({got[0]} bytes,"
        f" {wall:.3f} s)")
    # SG decode past kernel F: the '4k' chain in runs of kernel E
    what, ins, caps = sg_layout
    total, consumed, outs = sg.sg_compress(ins, caps, device=dev)
    comp = filled(outs, caps, total)
    sizes = [len(b) for b in ins]
    t0 = time.perf_counter()
    want = sg.sg_decompress(comp, sizes, device=dev)
    t1 = time.perf_counter()
    saved = sg.MAX_DEVICE_CONTENT, dec.STREAM_MAX_INPUT
    sg.MAX_DEVICE_CONTENT = min(1 << 20, consumed - 1)
    dec.STREAM_MAX_INPUT = max(total // 3, 2 * W)
    before = (LAUNCHES["decode_stream"], LAUNCHES["decode_sg"])
    try:
        got = sg.sg_decompress(comp, sizes, device=dev)
        t2 = time.perf_counter()
    finally:
        sg.MAX_DEVICE_CONTENT, dec.STREAM_MAX_INPUT = saved
    runs = LAUNCHES["decode_stream"] - before[0]
    if runs < 2 or LAUNCHES["decode_sg"] != before[1]:
        raise SmokeFailure(f"envelope: {what} took {runs} runs of kernel E "
                           "and launched kernel F")
    if got != want or got != (consumed, ins):
        raise SmokeFailure(f"envelope: {what} decoded in runs of kernel E "
                           "differs from kernel F's answer")
    res["sg_decode_in_runs"] = {"f_s": t1 - t0, "e_runs_s": t2 - t1,
                                "runs": runs}
    log(f"[envelope] {what}: {consumed} bytes decoded with "
        f"MAX_DEVICE_CONTENT at 1 MiB and STREAM_MAX_INPUT at "
        f"{max(total // 3, 2 * W)} "
        f"(kernel E in {runs} runs, {t2 - t1:.3f} s) equal kernel F's answer "
        f"({t1 - t0:.3f} s)")
    return res


# -- the mesh and multihost paths (lz4_tpu_torch.parallel) ---------------------
MESH_SG_LISTS = 64                 # the big bucket: lists of 256 KB, each
MESH_SG_LIST = 256 << 10           # 64 x 4 KB iovecs into 68 x 4 KB buffers
# the six ragged lists: three layouts (test_sg.py's, 16 times over), each
# with its output caps
MESH_RAGGED = (((32768, 32768), (36864,) * 3),
               ((16384, 49152), (53248,) * 2),
               ((65536,), (69632, 8192)))
MULTIHOST_TIMEOUT = 300            # seconds a multihost worker may take


def mesh_sg_lists(corpus: bytes):
    """The mesh phase's SG lists: (lists, caps per list, sizes per list).
    The first MESH_SG_LISTS lists are the corpus's first 16 MiB as lists of
    256 KB (one bucket); six ragged lists of three layouts follow, 64 KB
    each, from the bytes after them."""
    lists, caps, sizes = [], [], []
    n = MESH_SG_LIST // SG_IOVEC
    for i in range(MESH_SG_LISTS):
        head = corpus[i * MESH_SG_LIST:(i + 1) * MESH_SG_LIST]
        lists.append([head[j:j + SG_IOVEC]
                      for j in range(0, len(head), SG_IOVEC)])
        caps.append([SG_IOVEC] * (n * 17 // 16))
        sizes.append([SG_IOVEC] * n)
    pos = MESH_SG_LISTS * MESH_SG_LIST
    for i in range(6):
        layout, cap = MESH_RAGGED[i % 3]
        bufs = []
        for s in layout:
            bufs.append(corpus[pos:pos + s])
            pos += s
        lists.append(bufs)
        caps.append(list(cap))
        sizes.append(list(layout))
    return lists, caps, sizes


def peak_bytes(devices) -> int:
    """The largest peak of device memory on ``devices`` since their last
    reset."""
    import torch
    return max(torch.cuda.max_memory_allocated(d) for d in set(devices))


def mesh_phase(corpus: bytes, meshes: dict, ref, card: str) -> dict:
    """lz4_tpu_torch.parallel.mesh at full size, through the entry points a
    user calls, on each mesh of ``meshes``: compress_frame_mesh on the
    corpus (default min_match 4; kernels A and C), decoded by
    decompress_frame_device; the corpus as 1,024 rows of 64 KB through
    encode_blocks_sharded and decode_blocks_sharded (kernel B, batch D),
    every row back and the payloads ``ref``'s (one unsharded encode_blocks
    call), and roundtrip_step; the SG lists of ``mesh_sg_lists`` through
    sg_compress_mesh (kernel G with its list axis) and sg_decompress_mesh
    (kernel F), byte-exact.  Every mesh's frame and SG frames must equal
    the first mesh's.  Returns walls, MB/s and peak device memory."""
    import torch

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.parallel import mesh as M
    ref_comp, ref_clen = ref
    dev0 = ref_comp.device
    rows, lens = corpus_rows(corpus, dev0)
    lists, caps, sizes = mesh_sg_lists(corpus)
    sg_bytes = sum(len(b) for lst in lists for b in lst)
    mb, sg_mb = len(corpus) / 1e6, sg_bytes / 1e6
    res = {"card": card, "corpus_bytes": len(corpus), "sg_lists": len(lists),
           "sg_bytes": sg_bytes}
    first = None

    def timed(devices, fn):
        for d in set(devices):
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        out = fn()
        for d in set(devices):
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0, peak_bytes(devices)

    for name, mesh in meshes.items():
        devs = mesh.devices
        r = res[name] = {"devices": [str(d) for d in devs]}
        # the first call pays each card's first use in this process (the
        # second is timed too)
        frame, t_c, peak_c = timed(
            devs, lambda: M.compress_frame_mesh(mesh, corpus))
        again, t_c2, _ = timed(
            devs, lambda: M.compress_frame_mesh(mesh, corpus))
        (out, used), t_d, _ = timed(
            devs, lambda: D.decompress_frame_device(frame, device=devs[0]))
        if out != corpus or used != len(frame) or again != frame:
            raise SmokeFailure(f"mesh phase ({name}): the frame does not "
                               "decode to the corpus, or differs on a "
                               "second call")
        del out, again
        r["frame"] = {"bytes": len(frame), "ratio": len(frame) / len(corpus),
                      "compress_s": t_c, "compress_again_s": t_c2,
                      "decompress_s": t_d, "compress_mbs": mb / t_c,
                      "compress_again_mbs": mb / t_c2,
                      "decompress_mbs": mb / t_d, "peak_bytes": peak_c}
        log(f"[mesh] {name} ({len(devs)} positions on "
            f"{sorted(set(map(str, devs)))}): compress_frame_mesh of "
            f"{len(corpus) >> 20} MiB at mm=4: ratio "
            f"{len(frame) / len(corpus):.6f} ({len(frame)} bytes), "
            f"{mb / t_c:.1f} MB/s ({t_c:.3f} s, peak {peak_c >> 20} MiB), "
            f"again {mb / t_c2:.1f} MB/s ({t_c2:.3f} s); "
            f"decompress_frame_device {mb / t_d:.1f} MB/s ({t_d:.3f} s), "
            "byte-exact")

        def rows_round_trip():
            comp, clen = M.encode_blocks_sharded(mesh, rows, lens)
            out, olen = M.decode_blocks_sharded(mesh, comp, clen, W)
            return comp, clen, out, olen

        (comp, clen, out, olen), t_r, peak_r = timed(devs, rows_round_trip)
        comp, clen = M.gather_rows(comp).to(dev0), M.gather_rows(clen).to(dev0)
        out, olen = M.gather_rows(out).to(dev0), M.gather_rows(olen).to(dev0)
        cols = torch.arange(comp.shape[1], device=dev0)[None, :]
        live = cols < ref_clen[:, None]
        if not (torch.equal(out, rows) and bool((olen == W).all())):
            raise SmokeFailure(f"mesh phase ({name}): a row does not come "
                               "back through the sharded encode and decode")
        if not torch.equal(clen, ref_clen) or bool(
                ((comp != ref_comp) & live).any()):
            raise SmokeFailure(f"mesh phase ({name}): the sharded payloads "
                               "differ from one encode_blocks call")
        (s_clen, _, bad), t_s, _ = timed(
            devs, lambda: M.roundtrip_step(mesh, rows, lens, W))
        if bad or not torch.equal(M.gather_rows(s_clen).to(dev0), ref_clen):
            raise SmokeFailure(f"mesh phase ({name}): roundtrip_step counts "
                               f"{bad} bad rows")
        del comp, clen, out, olen
        r["rows"] = {"encode_decode_s": t_r, "encode_decode_mbs": mb / t_r,
                     "peak_bytes": peak_r, "roundtrip_step_s": t_s}
        log(f"[mesh] {name}: {rows.shape[0]} rows of 64 KB through "
            f"encode_blocks_sharded + decode_blocks_sharded {mb / t_r:.1f} "
            f"MB/s ({t_r:.3f} s, peak {peak_r >> 20} MiB), payloads equal "
            f"one encode_blocks call; roundtrip_step {t_s:.3f} s, bad 0")

        results, t_sc, peak_sc = timed(
            devs, lambda: M.sg_compress_mesh(mesh, lists, caps))
        comp_lists = []
        for (total, consumed, outs), lst, c in zip(results, lists, caps):
            if consumed != sum(map(len, lst)) or total <= 0:
                raise SmokeFailure(f"mesh phase ({name}): an SG list "
                                   "compressed short")
            comp_lists.append(filled(outs, c, total))
        dec, t_sd, _ = timed(
            devs, lambda: M.sg_decompress_mesh(mesh, comp_lists, sizes))
        if dec != [(sum(map(len, lst)), lst) for lst in lists]:
            raise SmokeFailure(f"mesh phase ({name}): an SG list does not "
                               "round-trip")
        r["sg"] = {"compress_s": t_sc, "decompress_s": t_sd,
                   "compress_mbs": sg_mb / t_sc,
                   "decompress_mbs": sg_mb / t_sd, "peak_bytes": peak_sc,
                   "frame_bytes": sum(t for t, _, _ in results)}
        log(f"[mesh] {name}: {len(lists)} SG lists ({MESH_SG_LISTS} of 256 "
            f"KB as 4 KB iovecs, 6 ragged), {sg_mb:.1f} MB: "
            f"sg_compress_mesh {sg_mb / t_sc:.1f} MB/s ({t_sc:.3f} s), "
            f"sg_decompress_mesh {sg_mb / t_sd:.1f} MB/s ({t_sd:.3f} s), "
            "byte-exact")
        if first is None:
            first = (name, frame, results)
        elif (frame, results) != first[1:]:
            raise SmokeFailure(f"mesh phase: {name}'s frames differ from "
                               f"{first[0]}'s")
    return res


def multihost_worker(rank: int, world: int, store: str, outdir: str,
                     device: str) -> int:
    """One process of the multihost phase: joins the group (NCCL on cards,
    gloo for ``device="cpu"``) through the ``file://`` store, compresses
    its slice of ``outdir/plain.bin``'s 64 KB rows with the lengths
    all-gathered (kernel B), decodes them again (batch D), and writes its
    frame segment and its decoded segment.  Rank 0 then splices the
    segments behind a header into one block-independent frame with a
    content checksum, which decompress_frame_device must decode to the
    content, and checks that the decoded segments join into it.  Each rank
    writes its launch counts and walls."""
    import struct

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.frame import FramePreferences, encode_frame_header
    from lz4_tpu_torch.kernels import common
    from lz4_tpu_torch.ops.xxhash import xxh32
    from lz4_tpu_torch.parallel import multihost as mh

    dev = mh.initialize(f"file://{store}", world, rank, device=device)
    mesh = mh.global_mesh()
    data = (Path(outdir) / "plain.bin").read_bytes()
    B = len(data) // W
    lo, hi = mh.process_block_range(B)
    local = np.frombuffer(data, np.uint8)[lo * W:hi * W].reshape(-1, W)
    rows, first = mh.global_blocks(mesh, local)
    if first != lo:
        raise SmokeFailure(f"rank {rank}: rows start at {first}, not {lo}")
    lens = torch.full((hi - lo,), W, dtype=torch.int32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    common.reset_counts()
    # the first call pays this process's first launches; the second is the
    # one timed as "encode_s"
    sync()
    t0 = time.perf_counter()
    mh.encode_blocks_multihost(mesh, rows, lens)
    first_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    comp, all_len = mh.encode_blocks_multihost(mesh, rows, lens)
    t1 = time.perf_counter()
    seg = mh.frame_segment(comp, all_len, [W] * B, lo, hi)
    clens = torch.from_numpy(all_len[lo:hi].astype(np.int32)).to(dev)
    sync()
    t2 = time.perf_counter()
    out, all_olen = mh.decode_blocks_multihost(mesh, comp, clens, W)
    t3 = time.perf_counter()
    dec = mh.decoded_segment(out, all_olen, lo, hi)
    if all_olen.tolist() != [W] * B:
        raise SmokeFailure(f"rank {rank}: decoded lengths differ")
    out_dir = Path(outdir)
    (out_dir / f"seg{rank}.bin").write_bytes(seg)
    (out_dir / f"dec{rank}.bin").write_bytes(dec)
    del comp, out
    dist.barrier()
    rec = {"rank": rank, "device": str(dev), "blocks": [lo, hi],
           "encode_first_s": first_s, "encode_s": t1 - t0,
           "decode_s": t3 - t2}
    if rank == 0:
        prefs = FramePreferences(block_size_id=4, block_independent=True,
                                 content_checksum=True)
        frame = (encode_frame_header(prefs)
                 + b"".join((out_dir / f"seg{r}.bin").read_bytes()
                            for r in range(world))
                 + struct.pack("<I", 0) + struct.pack("<I", xxh32(data, 0)))
        sync()
        t4 = time.perf_counter()
        got, used = D.decompress_frame_device(frame, device=dev)
        rec["frame_decode_s"] = time.perf_counter() - t4
        joined = b"".join((out_dir / f"dec{r}.bin").read_bytes()
                          for r in range(world))
        if got != data or used != len(frame) or joined != data:
            raise SmokeFailure("rank 0: the spliced frame or the decoded "
                               "segments differ from the content")
        rec["frame_bytes"] = len(frame)
    rec.update(launches=dict(common.LAUNCHES),
               plain=dict(common.PLAIN_CALLS),
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def multihost_phase(corpus: bytes, world: int, root: Path,
                    device: str = "cuda") -> dict:
    """lz4_tpu_torch.parallel.multihost at full size: ``world`` worker
    processes (this script with --multihost-worker), one per card, on a
    ``file://`` store under ``root``, all within MULTIHOST_TIMEOUT seconds;
    a worker that fails or hangs fails the phase.  A header, the ranks'
    frame segments in order, the endmark and the content checksum must be
    one frame that decompress_frame_device decodes to the corpus,
    and the decoded segments must join into it (rank 0 checks both).
    Returns the workers' records (launch counts, walls, peak memory) and
    the wall."""
    import shutil

    work = root / "multihost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "plain.bin").write_bytes(corpus)
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host: loopback only
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--multihost-worker",
         str(rank), str(world), str(work / "store"), str(work), device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs, failed = [], []
    try:
        for rank, p in enumerate(procs):
            try:
                outs.append(p.communicate(
                    timeout=max(MULTIHOST_TIMEOUT - (time.perf_counter()
                                                     - t0), 1))[0])
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} timed out")
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            failed.append(f"rank {rank} exited {p.returncode}: "
                          f"{out[-3000:]}")
    if failed:
        raise SmokeFailure("multihost phase: " + "; ".join(failed))
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    mb = len(corpus) / 1e6
    enc_s = max(r["encode_s"] for r in ranks)
    first_s = max(r["encode_first_s"] for r in ranks)
    dec_s = max(r["decode_s"] for r in ranks)
    frame_bytes = ranks[0]["frame_bytes"]
    log(f"[multihost] {world} process(es) on "
        f"{[r['device'] for r in ranks]}: encode_blocks_multihost of "
        f"{len(corpus) // W} rows {mb / enc_s:.1f} MB/s (slowest rank "
        f"{enc_s:.3f} s; its first call {first_s:.3f} s), "
        f"decode_blocks_multihost {mb / dec_s:.1f} MB/s "
        f"({dec_s:.3f} s), wall with start-up {wall:.1f} s; rank 0's "
        f"spliced frame ({frame_bytes} bytes, ratio "
        f"{frame_bytes / len(corpus):.6f}, decoded in "
        f"{ranks[0]['frame_decode_s']:.3f} s) and the decoded segments "
        "equal the corpus")
    return {"world": world, "ranks": ranks, "wall_s": wall,
            "frame_bytes": frame_bytes, "encode_s": enc_s, "decode_s": dec_s,
            "encode_mbs": mb / enc_s, "decode_mbs": mb / dec_s}


def parallel_phases(corpus: bytes, mesh_ref, card_line: str,
                    device: str = "cuda"):
    """Steps 13 and 14, each with its own counts: the mesh phase over the
    default mesh (every visible card) and four positions on card 0, the
    counters reset just before and read just after (kernels A, C, B, batch
    D, F and G's list axis must launch, no plain version may run); then
    the multihost phase, one worker per visible card (B and batch D must
    launch in the workers, no plain version may run there).  Returns
    ({"mesh": counts, "multihost": counts}, the mesh_phase record)."""
    import torch

    from lz4_tpu_torch.kernels import common
    from lz4_tpu_torch.parallel import mesh as M

    def check_counts(phase, launches, plain, need):
        log(f"[counts] {phase}: kernel launches {launches}; plain-version "
            f"calls {plain}")
        missing = [k for k in need if launches[k] <= 0]
        if missing or plain:
            raise SmokeFailure(f"{phase} skipped kernels {missing} or ran "
                               f"plain versions {plain}")
        return launches

    dev0 = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    common.reset_counts()
    mesh_times = mesh_phase(corpus, {
        "default mesh": M.default_mesh(device=device),
        "4 positions on cuda:0": M.Mesh((dev0,) * 4)}, mesh_ref, card_line)
    counts = {"mesh": check_counts(
        "mesh", {k: common.LAUNCHES.get(k, 0) for k in KERNELS},
        {k: v for k, v in common.PLAIN_CALLS.items() if v},
        ["encode_linked", "pack", "encode", "decode_batch", "decode_sg",
         "sg_encode_chain_batch"])}
    world = torch.cuda.device_count() if device == "cuda" else 2
    mh_times = multihost_phase(corpus, world, REPO / "build", device)
    counts["multihost"] = check_counts(
        "multihost (all ranks)",
        {k: sum(r["launches"].get(k, 0) for r in mh_times["ranks"])
         for k in KERNELS},
        [r["plain"] for r in mh_times["ranks"] if r["plain"]],
        ["encode", "decode_batch"])
    mh_times["card"] = card_line
    return counts, {**mesh_times, "multihost": mh_times}


# -- the decompress landing (step 20) -----------------------------------------
LANDING_CALLS = 3                  # decodes of each frame, one after another


def half_noise(text: bytes, seed: int) -> bytes:
    """``text``'s length in 1 MiB segments, exactly half of them seeded
    noise, in a seeded order; the others are the text's segments there."""
    import numpy as np

    seg = 1 << 20
    kinds = np.random.default_rng(seed).permutation(
        [0, 1] * (len(text) // seg // 2))
    return b"".join(noise_bytes(seg, seed + i) if kind
                    else text[i * seg:(i + 1) * seg]
                    for i, kind in enumerate(kinds))


def host_allocs(torch):
    """The pinned allocations PyTorch's caching host allocator has made, or
    None where it reports no such count."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return stats().get("num_host_alloc") if stats else None


def landing_phase(corpus: bytes, dev) -> dict:
    """``decompress_frame_device``'s landing on the card: the corpus as an
    hc9 frame (independent 64 KB blocks, kernel D batch), a half-noise
    object as a linked -BD frame (kernel D linked, stored blocks) and the
    corpus as a -B7 frame (independent 4 MB blocks, kernel E), each
    decoded LANDING_CALLS times, every output ``bytes`` equal to its input
    and ``pinned_d2h_bytes`` equal to its content, with no pinned memory
    allocated after each frame's first call; then all decoded at once, a
    thread each.  Returns the walls, counts and allocations."""
    import threading

    import torch

    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import trace
    from lz4_tpu_torch.frame import FramePreferences

    mixed = half_noise(corpus, 7)
    frames = {
        "hc9": (corpus, D.compress_frame_device_hc(corpus, FramePreferences(
            block_size_id=4, block_independent=True, content_checksum=True),
            level=9, device=dev)),
        "mixed linked": (mixed, D.compress_frame_device(
            mixed, FramePreferences(block_size_id=4, content_checksum=True),
            device=dev)),
        "cli-default": (corpus, D.compress_frame_device(
            corpus, FramePreferences(block_size_id=7, block_independent=True,
                                     content_checksum=True),
            block_size=4 << 20, device=dev))}
    record = {"calls": LANDING_CALLS}
    for what, (data, frame) in frames.items():
        walls, allocs = [], []
        for _ in range(LANDING_CALLS):
            trace.reset_counts()
            t0 = time.perf_counter()
            content, used = D.decompress_frame_device(frame, device=dev)
            walls.append(time.perf_counter() - t0)
            allocs.append(host_allocs(torch))
            if type(content) is not bytes or content != data \
                    or used != len(frame):
                raise SmokeFailure(f"landing phase: the {what} frame does "
                                   f"not decode to its input")
            if trace.COUNTS["pinned_d2h_bytes"] != len(data):
                raise SmokeFailure(
                    f"landing phase: {what}: pinned_d2h_bytes "
                    f"{trace.COUNTS['pinned_d2h_bytes']}, content "
                    f"{len(data)}")
        if allocs[0] is not None and len(set(allocs)) != 1:
            raise SmokeFailure(f"landing phase: {what}: pinned allocations "
                               f"after the first call: {allocs}")
        record[what] = {"walls_s": walls, "host_allocs": allocs,
                        "frame_bytes": len(frame),
                        "counts": dict(trace.COUNTS)}
        log(f"[landing] {what}: {len(frame)} B frame, {LANDING_CALLS} "
            f"decodes byte-exact, walls {[round(w, 4) for w in walls]} s, "
            f"pinned_d2h_bytes = content, host allocations after each call "
            f"{allocs}")
    errors, outs = [], {}

    def decode(what):
        try:
            for _ in range(2):
                outs[what] = D.decompress_frame_device(frames[what][1],
                                                       device=dev)[0]
                if outs[what] != frames[what][0]:
                    errors.append(what)
        except Exception as e:                  # noqa: BLE001
            errors.append(f"{what}: {e!r}")

    threads = [threading.Thread(target=decode, args=(what,))
               for what in frames]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors or len(outs) != len(frames):
        raise SmokeFailure(f"landing phase: threads at once: {errors}")
    record["threads"] = "all byte-exact, twice each"
    stats = getattr(torch.cuda, "host_memory_stats", None)
    record["host_memory_stats"] = dict(stats()) if stats else None
    log(f"[landing] a thread per frame, all at once, twice each: "
        f"byte-exact; host allocator {record['host_memory_stats']}")
    return record


def landing_only() -> int:
    """Steps 1, 2 and 20 alone: the card line, the build, the corpus, then
    the landing phase; prints its JSON line and the last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lz4_tpu_torch.kernels import build, common
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                 else f"nvidia-smi: {smi.stderr.strip()}")
    log(card_line)
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name}")
    build.kernels_lib()
    common.reset_counts()
    record = landing_phase(real_text_corpus(CORPUS_BYTES),
                           torch.device("cuda"))
    if common.PLAIN_CALLS or not (common.LAUNCHES["decode_batch"]
                                  and common.LAUNCHES["decode_linked"]
                                  and common.LAUNCHES["decode_stream"]):
        raise SmokeFailure(f"landing phase: launches "
                           f"{dict(common.LAUNCHES)}, plain calls "
                           f"{dict(common.PLAIN_CALLS)}")
    log(json.dumps({"card": card_line, "landing_phase": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def parallel_only() -> int:
    """Steps 1, 2, 13 and 14 alone (the four-card check): the card line,
    the build, the corpus, one unsharded encode_blocks call of its rows,
    then the mesh and multihost phases over every visible card; prints
    their JSON line and the last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels import encode_kernel as enc
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = "; ".join(smi.stdout.strip().splitlines()) \
        or f"nvidia-smi: {smi.stderr.strip()}"
    log(card_line)
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.kernels_lib()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    corpus = real_text_corpus(CORPUS_BYTES)
    mesh_ref = enc.encode_blocks(*corpus_rows(corpus, torch.device("cuda")))
    counts, times = parallel_phases(corpus, mesh_ref, card_line)
    log(json.dumps({"launches_by_phase": counts, "mesh_phase": times}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def compare_pack(cmp_rows, pack_kernel, what, k, p):
    """Kernel C against its plain version: totals, stored flags and the
    body's bytes."""
    import torch

    (kf, kt, ks), (pf, pt, ps) = k, p
    kn, pn = pack_kernel.body_length(kt), pack_kernel.body_length(pt)
    if kn != pn or not torch.equal(ks.cpu(), ps):
        raise SmokeFailure(f"pack totals or stored flags differ ({what})")
    cmp_rows("pack", what, kf[:kn].reshape(1, -1), torch.tensor([kn]),
             pf[:pn].reshape(1, -1), torch.tensor([pn]))


PACK_GUARD = 4096                  # bytes after flat that kernel C must not touch


def pack_guard_check(build, comp, olen, src, blen) -> int:
    """Kernel C's entry point on a fault, with a flat buffer followed by
    PACK_GUARD guard bytes, all holding one pattern: afterwards the total
    carries the fault flag and every byte still holds the pattern.
    Returns the number of guard bytes."""
    import torch

    B, M = comp.shape
    NS = src.shape[1]
    size = B * (4 + max(M, NS))
    dev = comp.device
    arena = torch.full((size + PACK_GUARD,), 0xA5, dtype=torch.uint8,
                       device=dev)
    sizes = torch.empty((2, B), dtype=torch.int32, device=dev)
    dst = torch.empty((B,), dtype=torch.int64, device=dev)
    stored = torch.empty((B,), dtype=torch.bool, device=dev)
    total = torch.empty((2,), dtype=torch.int64, device=dev)
    err = build.kernels_lib().lz4tt_pack(
        comp.data_ptr(), M, src.data_ptr(), src.stride(0), NS,
        olen.data_ptr(), blen.data_ptr(), B, sizes[0].data_ptr(),
        sizes[1].data_ptr(), dst.data_ptr(), stored.data_ptr(),
        total.data_ptr(), arena.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("pack", err)
    torch.cuda.synchronize()
    if int(total[1]) != 1 or not bool((arena == 0xA5).all()):
        raise SmokeFailure("pack wrote bytes after a fault, or missed it")
    return PACK_GUARD


# -- kernel A's adaptive mode, fullbench_torch.py and the example twins -------
ADAPTIVE_CYCLE = (4, 6, 8, 12)     # the per-block min_match, block by block
ADAPTIVE_CHUNK = 4 << 20           # the main path's chunk: 64 linked blocks
FULLBENCH_MB = 16                  # fullbench_torch.py's corpus on the card
EXAMPLE_TWINS = ("tpu_batch_torch.py", "mesh_frame_torch.py",
                 "scatter_gather_torch.py", "print_version_torch.py")


def load_script(path: Path):
    """The module of a script of the repo, loaded in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adaptive_mm(nb: int):
    """[1, nb] int32 mm_rows cycling through ADAPTIVE_CYCLE."""
    import torch
    return torch.tensor([[ADAPTIVE_CYCLE[k % len(ADAPTIVE_CYCLE)]
                          for k in range(nb)]], dtype=torch.int32)


def adaptive_stream(corpus: bytes, lo: int):
    """Kernel A's input for the chunk at corpus[lo:lo + ADAPTIVE_CHUNK]
    behind the 64 KB before it: (stream [1, (nb+1)*W], lens [1, nb],
    prefix_lens [1]) on the CPU."""
    import torch

    chunk = corpus[lo:lo + ADAPTIVE_CHUNK]
    window = corpus[max(0, lo - W):lo]
    nb = -(-len(chunk) // W)
    stream = torch.zeros((1, (nb + 1) * W), dtype=torch.uint8)
    if window:
        stream[0, W - len(window):W] = torch.frombuffer(bytearray(window),
                                                        dtype=torch.uint8)
    stream[0, W:W + len(chunk)] = torch.frombuffer(bytearray(chunk),
                                                   dtype=torch.uint8)
    lens = torch.tensor([[min(W, len(chunk) - k * W) for k in range(nb)]],
                        dtype=torch.int32)
    return stream, lens, torch.tensor([len(window)], dtype=torch.int32)


def adaptive_round_trip(enc, dec, corpus: bytes, dev) -> dict:
    """The corpus through ``encode_blocks_linked(..., mm_rows=)`` (mm_rows
    cycling through ADAPTIVE_CYCLE) chunk by chunk, each chunk behind the
    64 KB before it, and back through ``decode_blocks_linked`` (kernel D on
    the card) behind the same window; the decoded chunks must be the
    corpus.  Returns the payload bytes and the walls."""
    import torch

    payload, t_enc, t_dec = 0, 0.0, 0.0
    for lo in range(0, len(corpus), ADAPTIVE_CHUNK):
        stream, lens, pre = (t.to(dev) for t in adaptive_stream(corpus, lo))
        nb = lens.shape[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, olen = enc.encode_blocks_linked(
            stream, lens, prefix_lens=pre, mm_rows=adaptive_mm(nb).to(dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window = stream[0, :W] if lo else None
        got, glen = dec.decode_blocks_linked(out[0], olen[0], W,
                                             init_window=window,
                                             init_window_len=W if lo else 0)
        torch.cuda.synchronize()
        t_enc, t_dec = t_enc + t1 - t0, t_dec + time.perf_counter() - t1
        n = int(lens.sum())
        if not torch.equal(glen, lens[0]) or not torch.equal(
                got.reshape(-1)[:n], stream[0, W:W + n]):
            raise SmokeFailure(f"adaptive round trip differs in the chunk at "
                               f"{lo}")
        payload += int(olen.sum())
    return {"payload_bytes": payload, "content_bytes": len(corpus),
            "ratio": payload / len(corpus), "encode_s": t_enc,
            "decode_s": t_dec}


HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 rate (NVIDIA data sheet)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import sg
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.kernels import build, common
    from lz4_tpu_torch.kernels import decode_kernel as dec
    from lz4_tpu_torch.kernels import destsize_kernel as dsk
    from lz4_tpu_torch.kernels import encode_kernel as enc
    from lz4_tpu_torch.kernels import hc_kernel as hck
    from lz4_tpu_torch.kernels import pack_kernel
    from lz4_tpu_torch.kernels.pack_kernel import pack_frame_payloads
    from lz4_tpu_torch.legacy import _ext, literal_head, terminal_literals
    from lz4_tpu_torch.parallel import mesh as pmesh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                 else f"nvidia-smi: {smi.stderr.strip()}")
    log(card_line)
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name}")
    cuda = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.kernels_lib()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    stats = {k: {"max_abs_err": 0, "ms": None, "plain_ms": None,
                 "library_ms": None} for k in KERNELS}

    def set_bound(kernel, bytes_in, bytes_out):
        """The least time of the timed call: its inputs read once and its
        outputs written once at the card's memory rate (no PyTorch call
        computes an LZ4 codec, so library_ms stays null)."""
        stats[kernel].update(
            bytes_in=int(bytes_in), bytes_out=int(bytes_out),
            bound_ms=(int(bytes_in) + int(bytes_out)) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")

    def cmp_rows(kernel, what, k_out, k_olen, p_out, p_olen):
        """Exact comparison of out[:olen] rows and olen; records the max
        absolute difference (0 when equal) and fails on any difference."""
        torch.cuda.synchronize()
        k_olen = k_olen.cpu().reshape(-1)
        p_olen = p_olen.cpu().reshape(-1)
        k_out = k_out.cpu().reshape(len(k_olen), -1)
        p_out = p_out.cpu().reshape(len(p_olen), -1)
        err = int((k_olen.long() - p_olen.long()).abs().max())
        for i, n in enumerate(p_olen.tolist()):
            if n > 0:
                d = (k_out[i, :n].int() - p_out[i, :n].int()).abs().max()
                err = max(err, int(d))
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        log(f"[compare] {kernel:14s} {what}: rows={len(p_olen)} "
            f"bytes={int(p_olen.clamp(min=0).sum())} max_abs_err={err}")
        if err:
            raise SmokeFailure(f"{kernel} disagrees with its plain version "
                               f"on {what}")

    def cmp_stream(what, k, p):
        """Exact comparison of two decode_stream results: olen, and the
        bytes of the good blocks."""
        torch.cuda.synchronize()
        (k_out, k_olen), (p_out, p_olen) = k, p
        k_olen = k_olen.cpu()
        total = int(p_olen.clamp(min=0).sum())
        err = int((k_olen.long() - p_olen.long()).abs().max()) \
            if len(p_olen) else 0
        if total:
            d = (k_out[:total].cpu().int() - p_out[:total].int()).abs().max()
            err = max(err, int(d))
        stats["decode_stream"]["max_abs_err"] = max(
            stats["decode_stream"]["max_abs_err"], err)
        log(f"[compare] {'decode_stream':14s} {what}: blocks={len(p_olen)} "
            f"rejected={int((p_olen < 0).sum())} bytes={total} "
            f"max_abs_err={err}")
        if err:
            raise SmokeFailure(f"decode_stream disagrees with its plain "
                               f"version on {what}")

    def time_card(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def time_host(fn):
        t = time.perf_counter()
        res = fn()
        return res, (time.perf_counter() - t) * 1e3

    def time_rounds(fn, rounds=3):
        """CUDA-event ms of ``rounds`` single launches."""
        out = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return out

    t0 = time.perf_counter()
    corpus = real_text_corpus(CORPUS_BYTES)
    log(f"[corpus] {len(corpus)} bytes of stdlib text in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 3a. kernel A: 8 blocks + a partial, mm 4/8, prefix 0/64 KB ---------
    linked_case = functools.partial(make_linked_case, enc, cuda)

    small = corpus[3 * W:3 * W + 8 * W + 20_011]
    for mm in (4, 8):
        for prefix in (b"", corpus[2 * W:3 * W]):
            card, cpu = linked_case(small, prefix, mm)
            k = enc.scan_linked(*card)
            p = enc.scan_linked(*cpu)
            cmp_rows("encode_linked", f"9 blocks mm={mm} prefix="
                     f"{len(prefix)}", *k, *p)
            # the same in groups of 2 blocks (5 rounds of three launches)
            k = in_groups(2 * enc.scan_row_bytes(W), enc.scan_linked, *card)
            cmp_rows("encode_linked", f"9 blocks mm={mm} prefix="
                     f"{len(prefix)}, groups of 2", *k, *p)

    # main-path shape: one 4 MB chunk with its 64 KB window, bench point
    chunk = corpus[4 << 20:8 << 20]
    window = corpus[(4 << 20) - W:4 << 20]
    card, cpu = linked_case(chunk, window, 8, zero=True)
    stats["encode_linked"]["ms"] = time_card(lambda: enc.scan_linked(*card))
    p, stats["encode_linked"]["plain_ms"] = time_host(
        lambda: enc.scan_linked(*cpu))
    k = enc.scan_linked(*card)
    cmp_rows("encode_linked", "64 blocks mm=8 (main-path chunk)", *k, *p)
    # the window and chunk, the candidate and jump tables, the lengths
    set_bound("encode_linked", card[0].numel() + 4 * (
        card[3].numel() + card[4].numel() + card[1].numel() + 1),
        int(k[1].sum()))
    stream_d = card[0]
    t_tab = time_card(lambda: enc.linked_tables(stream_d, 64, 8,
                                                card[2]))
    log(f"[time] linked candidate tables (torch.sort etc.), 64 blocks: "
        f"{t_tab:.3f} ms")
    a_out, a_olen = k
    stats["encode_linked"]["phase_ms"] = device_ms(
        lambda: enc.scan_linked(*card))
    # the same shape at the scan's extremes
    for what, (data, win) in edge_chunks(corpus).items():
        e_card, e_cpu = linked_case(data, win, 8, zero=True)
        cmp_rows("encode_linked", f"64 blocks mm=8 ({what} chunk)",
                 *enc.scan_linked(*e_card), *enc.scan_linked(*e_cpu))
        stats["encode_linked"][f"ms_{what}"] = time_card(
            lambda: enc.scan_linked(*e_card))
    del e_card, e_cpu
    log("[time] encode_linked (kernel A) per 4 MB chunk at mm=8: " + ", ".join(
        f"{what} {stats['encode_linked'][key]:.4f} ms" for what, key in (
            ("text", "ms"), ("zeros", "ms_zeros"), ("period7", "ms_period7"),
            ("random", "ms_random"), ("charmaps", "ms_charmaps")))
        + "; device ms per phase on text "
        + json.dumps(stats["encode_linked"]["phase_ms"]))

    # -- 3b. kernel C on kernel A's output ----------------------------------
    blocks_d = stream_d[0, W:65 * W].view(64, W)
    lens64 = torch.full((64,), W, dtype=torch.int32)
    pack_args = (a_out.reshape(64, -1), a_olen.reshape(64), blocks_d,
                 lens64.to(cuda))
    # the wrapper on the card makes no host sync: under "error" any sync
    # (a .item(), a blocking copy) raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k_flat, k_total, k_stored = pack_frame_payloads(*pack_args)
    except RuntimeError as e:
        raise SmokeFailure(f"pack_frame_payloads synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("[check] pack_frame_payloads on the card makes no host sync "
        "(torch.cuda.set_sync_debug_mode('error'))")
    stats["pack"]["ms"] = time_card(lambda: pack_frame_payloads(*pack_args))
    (p_flat, p_total, p_stored), stats["pack"]["plain_ms"] = time_host(
        lambda: pack_frame_payloads(*[t.cpu() for t in pack_args]))
    k_bytes = pack_kernel.body_length(k_total)
    set_bound("pack", int(a_olen.sum()) + 2 * 4 * 64, k_bytes)
    # "ms" above is the wrapper's time per call; the kernels alone, from
    # the profiler
    stats["pack"]["kernel_ms"] = sum(device_ms(
        lambda: pack_frame_payloads(*pack_args)).values())
    log(f"[time] pack (kernel C), 64 blocks: {stats['pack']['ms']:.4f} ms "
        f"with its wrapper, {stats['pack']['kernel_ms']:.4f} ms kernels "
        f"only")
    # a stored block and a padding row, too
    olen_mix = a_olen.reshape(64).clone()
    olen_mix[3] = W + 5
    lens_mix = lens64.clone()
    lens_mix[63] = 0
    k2 = pack_frame_payloads(a_out.reshape(64, -1), olen_mix, blocks_d,
                             lens_mix.to(cuda))
    p2 = pack_frame_payloads(a_out.reshape(64, -1).cpu(), olen_mix.cpu(),
                             blocks_d.cpu(), lens_mix)
    cmp_pack = functools.partial(compare_pack, cmp_rows, pack_kernel)
    cmp_pack("64 blocks (main-path chunk)", (k_flat, k_total, k_stored),
             (p_flat, p_total, p_stored))
    cmp_pack("stored block + padding row", k2, p2)
    # a fault: one olen past its row, in compressed rows cut to half a
    # block (M < NS, so the block is not stored instead).  The call returns
    # without a sync; reading the total raises, and nothing was written
    # (the flat buffer and the guard bytes after it keep their pattern)
    comp_half = a_out.reshape(64, -1)[:, :W // 2].contiguous()
    olen_bad = a_olen.reshape(64).clamp(max=W // 2).to(cuda)
    olen_bad[5] = W // 2 + 1
    bad = pack_frame_payloads(comp_half, olen_bad, blocks_d, lens64.to(cuda))
    for what, read in (("body_length", lambda: pack_kernel.body_length(
            bad[1])), ("device._fetch_body", lambda: D._fetch_body(
                bad[0], bad[1], False))):
        try:
            read()
            raise SmokeFailure(f"pack: {what} took a length past its row")
        except ValueError as e:
            if "exceeds its row" not in str(e):
                raise
    guard = pack_guard_check(build, comp_half, olen_bad, blocks_d,
                             lens64.to(cuda))
    log(f"[check] pack fault (olen {int(olen_bad[5])} > M on block 5): "
        f"ValueError when the total is read (body_length, "
        f"device._fetch_body); flat and {guard} guard bytes untouched")

    # -- 3c. kernel D, linked mode ------------------------------------------
    win_d = stream_d[0, :W]
    dl_args = (a_out.reshape(64, -1), a_olen.reshape(64), W, win_d, W)
    stats["decode_linked"]["ms"] = time_card(
        lambda: dec.decode_blocks_linked(*dl_args))
    k = dec.decode_blocks_linked(*dl_args)
    p, stats["decode_linked"]["plain_ms"] = time_host(
        lambda: dec.decode_blocks_linked(
            a_out.reshape(64, -1).cpu(), a_olen.reshape(64).cpu(), W,
            win_d.cpu(), W))
    cmp_rows("decode_linked", "64-block chain with init window", *k, *p)
    set_bound("decode_linked", int(a_olen.sum()) + W + 4 * 64,
              int(k[1].sum()))
    if k[0].cpu().reshape(-1).numpy().tobytes() != chunk:
        raise SmokeFailure("linked decode of kernel A's chunk is not the "
                           "chunk")
    k = dec.decode_blocks_linked(a_out.reshape(64, -1), a_olen.reshape(64),
                                 W)
    p = dec.decode_blocks_linked(a_out.reshape(64, -1).cpu(),
                                 a_olen.reshape(64).cpu(), W)
    cmp_rows("decode_linked", "64-block chain, no window", *k, *p)
    # a 64-block chain of one 7-byte period (kernel A's parse, mm=4): every
    # block refers into the one before it, so references run through all 64
    period = mixed_bytes(7, corpus, 5)
    pattern = (period * (len(chunk) // 7 + 1))[:len(chunk)]
    per_out, per_olen = enc.scan_linked(*linked_case(pattern, b"", 4)[0])
    per_args = (per_out.reshape(64, -1), per_olen.reshape(64), W)
    k = dec.decode_blocks_linked(*per_args)
    p = dec.decode_blocks_linked(per_args[0].cpu(), per_args[1].cpu(), W)
    cmp_rows("decode_linked", "64-block chain of a 7-byte period", *k, *p)
    if k[0].cpu().reshape(-1).numpy().tobytes() != pattern:
        raise SmokeFailure("the 7-byte period chain does not decode to its "
                           "content")
    k = in_windows(8 * W, dec.decode_blocks_linked, *per_args)
    cmp_rows("decode_linked", "64-block chain of a 7-byte period, in 8 "
             "windows of 8 rows", *k, *p)
    stats["decode_linked"]["ms_period"] = time_card(
        lambda: dec.decode_blocks_linked(*per_args))
    # a short block at index 20: every later block that reaches back fails
    short_rows = a_out.reshape(64, -1).cpu().clone()
    short_lens = a_olen.reshape(64).cpu().clone()
    lit = literal_head(1000) + chunk[20 * W:20 * W + 1000]
    short_rows[20, :len(lit)] = torch.frombuffer(bytearray(lit),
                                                 dtype=torch.uint8)
    short_lens[20] = len(lit)
    k = dec.decode_blocks_linked(short_rows.to(cuda), short_lens.to(cuda), W,
                                 win_d, W)
    p = dec.decode_blocks_linked(short_rows, short_lens, W, win_d.cpu(), W)
    cmp_rows("decode_linked", "64-block chain with init window, a short "
             "block at index 20", *k, *p)
    # the same two chains go through kernel E too (step 3f), the second
    # behind its window as a literal-only block
    chains = {"64-block chain of a 7-byte period": per_args[:2],
              "64-block chain, a short block at index 20": (short_rows,
                                                            short_lens)}
    chains = {what: [r[:n].numpy().tobytes() for r, n in
                     zip(rows.cpu(), lens.tolist())]
              for what, (rows, lens) in chains.items()}
    chains["64-block chain, a short block at index 20"].insert(
        0, literal_head(W) + window)
    del per_out, per_olen, per_args, short_rows

    # -- 3d. kernel B, then kernel D batch mode on its output -----------------
    rows_h, blens = kernel_b_rows(corpus)
    rows_d = rows_h.to(cuda)
    for mm in (4, 8):
        delta, jump = enc.independent_tables(rows_d, mm)
        card_b = (rows_d, blens.to(cuda), delta, jump, 1, mm, 1)
        cpu_b = (rows_h, blens, delta.cpu(), jump.cpu(), 1, mm, 1)
        if mm == 8:
            stats["encode"]["ms"] = time_card(
                lambda: enc.scan_blocks(*card_b))
            p, stats["encode"]["plain_ms"] = time_host(
                lambda: enc.scan_blocks(*cpu_b))
        else:
            p = enc.scan_blocks(*cpu_b)
        k = enc.scan_blocks(*card_b)
        if mm == 8:
            set_bound("encode", int(blens.sum()) + 4 * (
                delta.numel() + jump.numel() + 64), int(k[1].sum()))
            stats["encode"]["phase_ms"] = device_ms(
                lambda: enc.scan_blocks(*card_b))
            log(f"[time] encode (kernel B), 64 rows mm=8: "
                f"{stats['encode']['ms']:.4f} ms; device ms per phase "
                + json.dumps(stats["encode"]["phase_ms"]))
        cmp_rows("encode", f"64 rows of <= 64 KB mm={mm}", *k, *p)
    b_out, b_olen, b_src_lens = *k, blens
    # kernel B at 256 KB rows: 18-bit positions, 2 KB walk segments; mm=8
    # also in groups of 3 rows
    wide_h, wide_lens = kernel_b_wide_rows(corpus)
    wide_d = wide_h.to(cuda)
    for mm in (4, 8):
        delta, jump = enc.independent_tables(wide_d, mm)
        card_w = (wide_d, wide_lens.to(cuda), delta, jump, 1, mm, 1)
        p = enc.scan_blocks(wide_h, wide_lens, delta.cpu(), jump.cpu(), 1,
                            mm, 1)
        cmp_rows("encode", f"8 rows of <= 256 KB mm={mm}",
                 *enc.scan_blocks(*card_w), *p)
        if mm == 8:
            k = in_groups(3 * enc.scan_row_bytes(wide_h.shape[1]),
                          enc.scan_blocks, *card_w)
            cmp_rows("encode", f"8 rows of <= 256 KB mm={mm}, groups of 3",
                     *k, *p)
    del wide_d, card_w
    db_args = (b_out, b_olen, W)
    stats["decode_batch"]["ms"] = time_card(
        lambda: dec.decode_blocks(*db_args))
    k = dec.decode_blocks(*db_args)
    p, stats["decode_batch"]["plain_ms"] = time_host(
        lambda: dec.decode_blocks(b_out.cpu(), b_olen.cpu(), W))
    cmp_rows("decode_batch", "kernel B's 64 rows", *k, *p)
    set_bound("decode_batch", int(b_olen.sum()) + 4 * 64,
              int(k[1].clamp(min=0).sum()))

    # corrupted streams: truncations, bit flips, length bombs, bad offsets
    gen = torch.Generator().manual_seed(1234)
    comp_rows, comp_lens = [], []
    b_out_h, b_olen_h = b_out.cpu(), b_olen.cpu()
    for i in range(48):
        n = int(b_olen_h[i % 8])
        row = bytearray(b_out_h[i % 8, :n].numpy().tobytes())
        kind = i % 4
        if kind == 0:
            row = row[:int(torch.randint(1, max(n, 2), (1,),
                                         generator=gen))]
        elif kind == 1:
            for _ in range(int(torch.randint(1, 9, (1,), generator=gen))):
                pos = int(torch.randint(0, len(row), (1,), generator=gen))
                row[pos] = int(torch.randint(0, 256, (1,), generator=gen))
        elif kind == 2:
            row = bytearray([0xF0] + [255] * (i + 1)) + row
        else:
            row = bytearray([0x12, 0xAA, 0xFF, 0xFF]) + row
        comp_rows.append(bytes(row))
        comp_lens.append(len(row))
    M = max(comp_lens)
    bad = torch.zeros((len(comp_rows), M), dtype=torch.uint8)
    for i, r in enumerate(comp_rows):
        bad[i, :len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
    bad_lens = torch.tensor(comp_lens, dtype=torch.int32)
    k = dec.decode_blocks(bad.to(cuda), bad_lens.to(cuda), W)
    p = dec.decode_blocks(bad, bad_lens, W)
    cmp_rows("decode_batch", "48 corrupted streams", *k, *p)
    k = dec.decode_blocks_linked(bad.to(cuda), bad_lens.to(cuda), W)
    p = dec.decode_blocks_linked(bad, bad_lens, W)
    cmp_rows("decode_linked", "48 corrupted streams as a chain", *k, *p)
    nrej = int((p[1] < 0).sum())
    log(f"[compare] corrupted streams rejected: {nrej} of {len(comp_rows)}")

    # -- 3e. inputs unlike text: zero runs, noise, short periods, repeats ----
    mixed = mixed_bytes(9 * W - 7000, corpus[:1 << 20], 99)
    for mm, rs, acc in ((4, 1, 1), (8, 3, 1), (12, 1, 4)):
        prefix = corpus[:W] if mm == 8 else b""
        card, cpu = linked_case(mixed, prefix, mm, rs, acc=acc)
        k = enc.scan_linked(*card)
        p = enc.scan_linked(*cpu)
        what = f"mixed 9 blocks mm={mm} rs={rs} acc={acc} prefix={len(prefix)}"
        cmp_rows("encode_linked", what, *k, *p)
        win = card[0][0, :W]
        dk = dec.decode_blocks_linked(k[0][0], k[1][0], W, win, len(prefix))
        dp = dec.decode_blocks_linked(p[0][0], p[1][0], W, win.cpu(),
                                      len(prefix))
        cmp_rows("decode_linked", what, *dk, *dp)
        got = b"".join(dk[0][i, :n].cpu().numpy().tobytes()
                       for i, n in enumerate(dk[1].cpu().tolist()))
        if got != mixed:
            raise SmokeFailure(f"mixed chain does not round-trip ({what})")
    sizes = [W, 1, 12, 13, 100, 4096, 30_000, 65_535] * 2
    rows_h = torch.zeros((len(sizes), W), dtype=torch.uint8)
    for i, n in enumerate(sizes):
        rows_h[i, :n] = torch.frombuffer(
            bytearray(mixed[i * 20_011:i * 20_011 + n]), dtype=torch.uint8)
    blens = torch.tensor(sizes, dtype=torch.int32)
    for mm, acc in ((4, 2), (12, 1)):
        delta, jump = enc.independent_tables(rows_h.to(cuda), mm)
        k = enc.scan_blocks(rows_h.to(cuda), blens.to(cuda), delta, jump,
                            acc, mm, 1)
        p = enc.scan_blocks(rows_h, blens, delta.cpu(), jump.cpu(), acc, mm,
                            1)
        cmp_rows("encode", f"16 mixed rows mm={mm} acc={acc}", *k, *p)
        dk = dec.decode_blocks(k[0], k[1], W)
        dp = dec.decode_blocks(p[0], p[1], W)
        cmp_rows("decode_batch", f"16 mixed rows mm={mm}", *dk, *dp)
        if not torch.equal(dk[1].cpu(), blens):
            raise SmokeFailure("mixed rows do not round-trip")
    # noise as compressed input: every load and store stays in bounds
    noise = torch.randint(0, 256, (64, 4096), generator=gen,
                          dtype=torch.uint8)
    noise_lens = torch.randint(0, 4097, (64,), generator=gen,
                               dtype=torch.int32)
    for mode, fn in (("decode_batch", dec.decode_blocks),
                     ("decode_linked", dec.decode_blocks_linked)):
        k = fn(noise.to(cuda), noise_lens.to(cuda), W)
        p = fn(noise, noise_lens, W)
        cmp_rows(mode, "64 rows of noise", *k, *p)

    # -- 3f. kernel E: full-size inputs, small cases, times ------------------
    t0 = time.perf_counter()
    files = stream_files(corpus, cuda)
    log(f"[stream] inputs written on the card in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {len(v)} bytes" for k, v in files.items()))
    noise_rows = [noise[i, :n].numpy().tobytes()
                  for i, n in enumerate(noise_lens.tolist())]
    for what, flat, st, cl, sd, bs, caps in stream_cases(
            files, corpus, cuda, comp_rows, noise_rows):
        for linked in (False, True):
            args = (st, cl, sd, bs, 0, linked, caps)
            k = dec.decode_stream_raw(torch.frombuffer(
                bytearray(flat), dtype=torch.uint8).to(cuda), *args)
            p = dec.decode_stream_raw(torch.frombuffer(
                bytearray(flat), dtype=torch.uint8), *args)
            cmp_stream(f"{what}, {'linked' if linked else 'independent'}",
                       k, p)
    for what, payloads in chains.items():
        cmp_stream(f"{what}, linked",
                   dec.decode_stream(payloads, W, 0, device=cuda),
                   dec.decode_stream(payloads, W, 0, device="cpu"))
    del chains
    # the hard cases of independent mode's parallel parse, at 4 MB, and a
    # literal run summing past int32 in an 8 MB block; the 255s last
    adv = stream_adversarial(MB4, corpus)
    adv = adv[1:] + [("a literal run past int32", INT32_RUN,
                      dec.STREAM_BLOCK_CAP)] + adv[:1]
    flat_h, bst, cln = dec.join_payloads([p for _, p, _ in adv], "cpu")
    flat_d = flat_h.to(cuda)
    for linked in (False, True):
        args = (bst, cln, [0] * len(adv), MB4, 0, linked,
                [c for _, _, c in adv])
        p = dec.decode_stream_raw(flat_h, *args)
        cmp_stream(f"{len(adv)} hard blocks ("
                   + "; ".join(w for w, _, _ in adv)
                   + f"), {'linked' if linked else 'independent'}",
                   dec.decode_stream_raw(flat_d, *args), p)
        if not linked:
            cmp_stream("the hard blocks in spans of 4 sequences",
                       in_span_log(2, dec.decode_stream_raw, flat_d, *args),
                       p)
    del flat_d, flat_h, adv
    # every launch the stream phase makes (step 6), on the whole file; the
    # two linked chains timed too (median of three single launches)
    launches = stream_launches(files)
    plain_full, chain_ms = {}, {}
    for fname, (what, flat, st, cl, sd, bs, linked, caps) in \
            launches.items():
        flat_h = torch.frombuffer(bytearray(flat), dtype=torch.uint8)
        flat_d = flat_h.to(cuda)
        args = (st, cl, sd, bs, 0, linked, caps)
        k = dec.decode_stream_raw(flat_d, *args)
        p, plain_full[fname] = time_host(
            lambda: dec.decode_stream_raw(flat_h, *args))
        cmp_stream(f"{what} (the stream phase's launch)", k, p)
        # the same chain in windows of 1 MiB of caps (independent: a
        # window per block)
        k = in_windows(1 << 20, dec.decode_stream_raw, flat_d, *args)
        cmp_stream(f"{what}, in windows of 1 MiB of caps", k, p)
        if fname == "b7":
            k = in_span_log(2, dec.decode_stream_raw, flat_d, *args)
            cmp_stream(f"{what}, in spans of 4 sequences", k, p)
        chain_ms[fname] = time_rounds(
            lambda: dec.decode_stream_raw(flat_d, *args))
        st_ = stats["decode_stream"]
        st_[f"ms_{fname}"] = sorted(chain_ms[fname])[1]
        st_[f"ms_rounds_{fname}"] = chain_ms[fname]
        st_[f"plain_ms_{fname}"] = plain_full[fname]
        # the input and 16 bytes of metadata per block in; the content and
        # olen out
        st_[f"bound_ms_{fname}"] = (len(flat) + 16 * len(st) + int(
            p[1].clamp(min=0).sum()) + 4 * len(st)) / HBM_BYTES_PER_S * 1e3
        del k, p, flat_d
    s7, n7, _ = _records(files["b7"], 7)
    b7_d = torch.frombuffer(bytearray(files["b7"]), dtype=torch.uint8).to(cuda)
    one = ([s7[0]], [n7[0]], [0], MB4, 0)
    # three alternating rounds of the two modes on one 4 MB block; the
    # reported time is each mode's median
    rounds = {True: [], False: []}
    for _ in range(3):
        for linked in (True, False):
            rounds[linked].append(time_card(lambda: dec.decode_stream_raw(
                b7_d, *one, linked=linked)))
    ms = {m: sorted(r)[1] for m, r in rounds.items()}
    stats["decode_stream"]["ms"] = ms[True]
    stats["decode_stream"]["ms_independent"] = ms[False]
    stats["decode_stream"]["ms_rounds"] = rounds[True]
    stats["decode_stream"]["ms_rounds_independent"] = rounds[False]
    b7_h = b7_d.cpu()
    plain_ms = {}
    for linked in (True, False):
        p, plain_ms[linked] = time_host(
            lambda: dec.decode_stream_raw(b7_h, *one, linked=linked))
        k = dec.decode_stream_raw(b7_d, *one, linked=linked)
        cmp_stream(f"one 4 MB block (timed), "
                   f"{'linked' if linked else 'independent'}", k, p)
    stats["decode_stream"]["plain_ms"] = plain_ms[True]
    set_bound("decode_stream", n7[0] + 16, MB4 + 4)
    stats["decode_stream"]["plain_ms_independent"] = plain_ms[False]
    t16 = stats["decode_stream"]["ms_b7"]
    stats["decode_stream"]["ms_64mib_independent"] = t16
    stats["decode_stream"]["plain_ms_64mib_independent"] = plain_full["b7"]
    log(f"[time] decode_stream, one 4 MB block: linked {ms[True]:.3f} ms "
        f"({MB4 / 1e3 / ms[True]:.1f} MB/s), independent {ms[False]:.3f} ms "
        f"({MB4 / 1e3 / ms[False]:.1f} MB/s), rounds linked "
        f"{[round(t, 3) for t in rounds[True]]} independent "
        f"{[round(t, 3) for t in rounds[False]]}; plain linked "
        f"{plain_ms[True]:.1f} ms, independent {plain_ms[False]:.1f} ms; "
        f"16 blocks, {len(corpus) >> 20} MiB independent: {t16:.3f} ms "
        f"({len(corpus) / 1e3 / t16:.1f} MB/s), plain "
        f"{plain_full['b7']:.1f} ms")
    log("[time] decode_stream plain version, whole files: " + ", ".join(
        f"{f} {t:.1f} ms" for f, t in plain_full.items()))
    log("[time] decode_stream, whole files: " + ", ".join(
        f"{f} rounds {[round(t, 3) for t in r]} ms "
        f"({len(corpus) / 1e3 / sorted(r)[1]:.1f} MB/s)"
        for f, r in chain_ms.items()))
    del b7_d, b7_h, launches

    # -- 3g. kernels G and F: small cases, every sg-phase launch, times -----
    def cmp_chain(what, k, p):
        """Exact comparison of two sg_encode_chain results: every step's
        boff, blen, consumed, isz and osz, and the block bytes."""
        torch.cuda.synchronize()
        (kb, *kr), (pb, *pr) = k, p
        err = max(int((a.cpu().long() - b.long()).abs().max())
                  for a, b in zip(kr, pr))
        if len(pb):
            err = max(err, int((kb[:len(pb)].cpu().int() - pb.int())
                               .abs().max()))
        stats["sg_encode_chain"]["max_abs_err"] = max(
            stats["sg_encode_chain"]["max_abs_err"], err)
        log(f"[compare] {'sg_encode_chain':14s} {what}: steps="
            f"{int((pr[1] >= 0).sum())} of {len(pr[1])} block bytes="
            f"{len(pb)} max_abs_err={err}")
        if err:
            raise SmokeFailure(f"sg_encode_chain disagrees with its plain "
                               f"version on {what}")

    def cmp_sg(what, k, p):
        """Exact comparison of two decode_blocks_sg_raw results: olen and
        every output byte (both start from zeros)."""
        torch.cuda.synchronize()
        (k_out, k_olen), (p_out, p_olen) = k, p
        err = int((k_olen.cpu().long() - p_olen.long()).abs().max())
        if len(p_out):
            err = max(err, int((k_out.cpu().int() - p_out.int()).abs().max()))
        stats["decode_sg"]["max_abs_err"] = max(
            stats["decode_sg"]["max_abs_err"], err)
        log(f"[compare] {'decode_sg':14s} {what}: blocks={len(p_olen)} "
            f"rejected={int((p_olen < 0).sum())} bytes={len(p_out)} "
            f"max_abs_err={err}")
        if err:
            raise SmokeFailure(f"decode_sg disagrees with its plain version "
                               f"on {what}")

    def chain_args(ins, caps, acc=1, mm=4):
        """sg_encode_chain's arguments for a list, on the card and on the
        CPU, as sg_compress makes them."""
        flat_h, ends = dsk.sg_chain_input(ins, "cpu")
        rest = (ends, caps, sum(caps), acc, mm)
        return (flat_h.to(cuda), *rest), (flat_h, *rest)

    def sg_chain_of(ins, caps):
        """(payloads, sizes) of the chain in the frame the card writes for
        a list, as sg_decompress collects them."""
        total, _, outs = sg.sg_compress(ins, caps, device=cuda)
        _, payloads, sizes = sg.collect_chain(filled(outs, caps, total),
                                              [len(b) for b in ins])
        return payloads, sizes

    def sg_decode_args(payloads, sizes):
        """decode_blocks_sg_raw's arguments, on the card and on the CPU."""
        flat, bstart, clen = dec.join_payloads(payloads, "cpu")
        return (flat.to(cuda), bstart, clen, sizes), (flat, bstart, clen,
                                                      sizes)

    mixed_sg = mixed_bytes(600_000, corpus[:1 << 20], 77)
    for what, ins, caps, acc, mm in sg_chain_cases(corpus, mixed_sg):
        card, cpu = chain_args(ins, caps, acc, mm)
        cmp_chain(what, dsk.sg_encode_chain(*card), dsk.sg_encode_chain(*cpu))
        if (acc, mm) == (1, 4):         # the frames sg_compress writes
            kf, pf = sg_decode_args(*sg_chain_of(ins, caps))
            cmp_sg(what, dec.decode_blocks_sg_raw(*kf),
                   dec.decode_blocks_sg_raw(*pf))
    # kernel F's hard chains, each eight times over, blocks of 32,767
    for what, chain, sizes in sg_adversarial(32767, corpus):
        kf, pf = sg_decode_args(chain * 8, sizes * 8)
        cmp_sg(f"{what} (x8)", dec.decode_blocks_sg_raw(*kf),
               dec.decode_blocks_sg_raw(*pf))
    for what, rows, sizes in (("48 corrupted streams", comp_rows, [W] * 48),
                              ("64 payloads of noise", noise_rows,
                               [4096] * 64)):
        kf, pf = sg_decode_args(rows, sizes)
        cmp_sg(f"{what} as an SG chain", dec.decode_blocks_sg_raw(*kf),
               dec.decode_blocks_sg_raw(*pf))
    # every launch of G and F the sg phase makes, on the whole layout
    layouts = sg_layouts(corpus)
    sg_plain, timed = {}, {}
    for lay in ("4k", "ragged"):
        what, ins, caps = layouts[lay]
        card, cpu = chain_args(ins, caps)
        k = dsk.sg_encode_chain(*card)
        p, sg_plain[f"G {lay}"] = time_host(
            lambda: dsk.sg_encode_chain(*cpu))
        cmp_chain(f"{what} (the sg phase's launch)", k, p)
        payloads, sizes = sg_chain_of(ins, caps)
        kf, pf = sg_decode_args(payloads, sizes)
        k2 = dec.decode_blocks_sg_raw(*kf)
        p2, sg_plain[f"F {lay}"] = time_host(
            lambda: dec.decode_blocks_sg_raw(*pf))
        cmp_sg(f"{what} (the sg phase's launch)", k2, p2)
        cmp_sg(f"{what}, in windows of 1 MiB",
               in_windows(1 << 20, dec.decode_blocks_sg_raw, *kf), p2)
        if lay == "4k":
            T = len(p[1])
            # content, input ends and caps in; blocks and step records out
            set_bound("sg_encode_chain", len(cpu[0]) - dsk.TAIL
                      + 4 * (len(cpu[1]) + len(caps)),
                      len(p[0]) + T * (8 + 4 * 4))
            # payloads and per-block offsets, lengths and caps in; content
            # and olen out
            set_bound("decode_sg", sum(map(len, payloads))
                      + len(sizes) * (8 + 8 + 4 + 4),
                      sum(sizes) + 4 * len(sizes))
            timed = {"G": card, "F": kf}
        del k, p, k2, p2
    what, ins, caps = layouts["large"]
    total, _, outs = sg.sg_compress(ins, caps, device=cuda,
                                    dest_size_compress=kernel_b_dest_size(
                                        cuda))
    _, payloads, sizes = sg.collect_chain(filled(outs, caps, total),
                                          [len(b) for b in ins])
    args = (-(-max(sizes) // W) * W, total, True, sizes)
    cmp_stream(f"{what} (the sg phase's launch)",
               dec.decode_stream(payloads, *args, device=cuda),
               dec.decode_stream(payloads, *args, device="cpu"))
    g_ms = time_rounds(lambda: dsk.sg_encode_chain(*timed["G"]))
    f_ms = time_rounds(lambda: dec.decode_blocks_sg_raw(*timed["F"]))
    for kname, rounds, tag in (("sg_encode_chain", g_ms, "G"),
                               ("decode_sg", f_ms, "F")):
        stats[kname].update(ms=sorted(rounds)[1], ms_rounds=rounds,
                            plain_ms=sg_plain[f"{tag} 4k"],
                            plain_ms_ragged=sg_plain[f"{tag} ragged"])
    mb = SG_BYTES / 1e3
    log(f"[time] sg_encode_chain, {layouts['4k'][0]} walk: rounds "
        f"{[round(t, 3) for t in g_ms]} ms ({mb / sorted(g_ms)[1]:.1f} "
        f"MB/s); decode_blocks_sg_raw on its chain: rounds "
        f"{[round(t, 3) for t in f_ms]} ms ({mb / sorted(f_ms)[1]:.1f} "
        f"MB/s); plain versions: " + ", ".join(
            f"{k} {t:.1f} ms" for k, t in sg_plain.items()))
    del timed

    # -- 3h. kernel I: small cases, sampled corpus rows, times --------------
    def cmp_tables(what, k_tabs, rows_h):
        """The tables the card built equal the CPU's (one stable sort)."""
        for k_t, p_t in zip(k_tabs, hck.hc_sorted_tables(rows_h)):
            if not torch.equal(k_t.cpu(), p_t):
                raise SmokeFailure(f"the HC tables differ on the card "
                                   f"({what})")

    def cmp_hc(what, k, rows_h, lens_h, tabs_h, level):
        """Kernel I's rows equal the round model's (its plain version) and
        the serial walk's over the d48 table, at tolerance 0."""
        cmp_rows("encode_hc", f"{what}, level {level}", *k,
                 *hck.hc_scan(rows_h, lens_h, tabs_h, level))
        cmp_rows("encode_hc", f"{what}, level {level}, serial walk", *k,
                 *hck.hc_scan_serial(rows_h, lens_h, level))

    for what, blocks, width in hc_small_cases(corpus, mixed):
        rows_h, lens_h = D.byte_rows(blocks, width, "cpu")
        tabs = hck.hc_sorted_tables(rows_h.to(cuda))
        cmp_tables(what, tabs, rows_h)
        tabs_h = [t.cpu() for t in tabs]
        for level in HC_LEVELS if width == HC_SMALL_NS else (9, 16):
            cmp_hc(what, hck.hc_scan(rows_h.to(cuda), lens_h.to(cuda), tabs,
                                     level), rows_h, lens_h, tabs_h, level)
        if width == HC_SMALL_NS:
            # rows that start at any byte of their storage: kernel I reads
            # them as aligned words
            for off in (1, 2, 3):
                store = torch.zeros(rows_h.numel() + 4, dtype=torch.uint8,
                                    device=cuda)
                view = store[off:off + rows_h.numel()].view(rows_h.shape)
                view.copy_(rows_h.to(cuda))
                cmp_hc(f"{what}, at storage offset {off}",
                       hck.encode_blocks_hc(view, lens_h.to(cuda), 9),
                       rows_h, lens_h, tabs_h, 9)
    # the corpus batch: 1,024 rows of 64 KB at level 9 (what -9 launches)
    nrows = len(corpus) // W
    hc_rows_h = torch.frombuffer(bytearray(corpus), dtype=torch.uint8) \
        .reshape(nrows, W)
    hc_args = (hc_rows_h.to(cuda), torch.full((nrows,), W, dtype=torch.int32,
                                              device=cuda))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hc_tabs = hck.hc_sorted_tables(hc_args[0])
    torch.cuda.synchronize()
    t_peak = torch.cuda.max_memory_allocated() - base
    t_tab = time_card(lambda: hck.hc_sorted_tables(hc_args[0]), reps=2)
    k = hck.hc_scan(*hc_args, hc_tabs, 9)
    sample = sorted({round(i * (nrows - 1) / (HC_SAMPLE_ROWS - 1))
                     for i in range(HC_SAMPLE_ROWS)})
    idx = torch.tensor(sample)
    cmp_tables(f"{len(sample)} sampled corpus rows",
               [t[idx.to(cuda)] for t in hc_tabs], hc_rows_h[idx].contiguous())
    p, hc_plain = time_host(lambda: hck.hc_scan(
        hc_rows_h[idx].contiguous(), hc_args[1][idx.to(cuda)].cpu(),
        [t[idx.to(cuda)].cpu() for t in hc_tabs], 9))
    cmp_rows("encode_hc", f"corpus rows {sample} of {nrows}, level 9",
             k[0][idx.to(cuda)], k[1][idx.to(cuda)], *p)
    cmp_rows("encode_hc", f"corpus rows {sample} of {nrows}, level 9, "
             f"serial walk", k[0][idx.to(cuda)], k[1][idx.to(cuda)],
             *hck.hc_scan_serial(hc_rows_h[idx].contiguous(),
                                 hc_args[1][idx.to(cuda)].cpu(), 9))
    hc_ms = time_rounds(lambda: hck.hc_scan(*hc_args, hc_tabs, 9))
    # kernel I on what the hc phase gives it: the batch of -9, and the first
    # SWEEP_BYTES of the corpus at each level of the sweep
    ns = SWEEP_BYTES // W
    hc_phase_ms = {"-9": sorted(hc_ms)[1], **{
        level: time_card(lambda: hck.hc_scan(
            hc_args[0][:ns], hc_args[1][:ns], [t[:ns] for t in hc_tabs],
            level), reps=2)
        for level in SWEEP_LEVELS}}
    stats["encode_hc"].update(
        ms=sorted(hc_ms)[1], ms_rounds=hc_ms, plain_ms=hc_plain,
        plain_rows=len(sample), table_ms=t_tab, table_peak_bytes=t_peak)
    # rows and the two 16-bit tables in; payloads and lengths out
    set_bound("encode_hc", hc_args[0].numel() + 2 * (
        hc_tabs[0].numel() + hc_tabs[1].numel()) + 4 * nrows,
        int(k[1].sum()) + 4 * nrows)
    log(f"[time] encode_hc (kernel I), {nrows} rows of 64 KB, level 9: "
        f"rounds {[round(t, 3) for t in hc_ms]} ms "
        f"({len(corpus) / 1e3 / sorted(hc_ms)[1]:.1f} MB/s), ratio of the "
        f"payloads {int(k[1].sum()) / len(corpus):.6f}; tables (perm, "
        f"slot) {t_tab:.3f} ms, {t_peak / 2**30:.2f} GiB peak; plain "
        f"version {hc_plain:.1f} ms on {len(sample)} rows; on the first "
        f"{SWEEP_BYTES >> 20} MiB at levels {SWEEP_LEVELS}: " + ", ".join(
            f"{hc_phase_ms[lv]:.3f}" for lv in SWEEP_LEVELS) + " ms")
    # kernel C on HC's group: the 1,024 rows' payloads, stored blocks where
    # they do not shrink
    hc_pack = (k[0], k[1], hc_args[0], hc_args[1])
    compare_pack(cmp_rows, pack_kernel, f"HC's group of {nrows} rows",
                 pack_frame_payloads(*hc_pack),
                 pack_frame_payloads(*[t.cpu() for t in hc_pack]))
    stats["pack"]["ms_hc_group"] = time_card(
        lambda: pack_frame_payloads(*hc_pack))
    stats["pack"]["kernel_ms_hc_group"] = sum(device_ms(
        lambda: pack_frame_payloads(*hc_pack)).values())
    log(f"[time] pack (kernel C), HC's group of {nrows} rows: "
        f"{stats['pack']['ms_hc_group']:.4f} ms with its wrapper, "
        f"{stats['pack']['kernel_ms_hc_group']:.4f} ms kernels only")
    del hc_rows_h, hc_args, hc_tabs, hc_pack, k, p

    # -- 3i. kernels H, J, K and D resumable: small cases, sampled rows, times
    def cmp_third(kernel, what, k, p):
        """cmp_rows on (out, olen), and the third result (consumed or cons)
        equal too."""
        cmp_rows(kernel, what, k[0], k[1], p[0], p[1])
        err = int((k[2].cpu().long() - p[2].long()).abs().max()) \
            if len(p[2]) else 0
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        if err:
            raise SmokeFailure(f"{kernel}: consumed counts differ from the "
                               f"plain version's on {what}")

    def cmp_dest_size(what, bufs, caps, prefixes, acc, mm):
        """Kernel H against its plain version on one batch, then every
        block through kernel D (batch mode, the prefix as its dictionary
        row) against the plain decoder, back to the consumed source."""
        k_args = ds_rows(bufs, prefixes, cuda)
        p_args = ds_rows(bufs, prefixes, "cpu")
        k = dsk.encode_blocks_dest_size(
            k_args[0], k_args[1], i32_tensor(caps, cuda), acc,
            window_lens=k_args[2], min_match=mm)
        p = dsk.encode_blocks_dest_size(
            p_args[0], p_args[1], i32_tensor(caps, "cpu"), acc,
            window_lens=p_args[2], min_match=mm)
        cmp_third("encode_dest_size", what, k, p)
        over = [i for i, (n, cap) in enumerate(zip(k[1].cpu().tolist(), caps))
                if n > max(cap, 0)]
        if over:
            raise SmokeFailure(f"{what}: kernel H's blocks {over} pass their "
                               "caps")
        width = max(max(map(len, bufs)), 1)
        pre = prefixes or [b""] * len(bufs)
        dk = dec.decode_blocks(k[0], k[1], width, k[2],
                               *right_rows(pre, cuda))
        dp = dec.decode_blocks(p[0], p[1], width, p[2],
                               *right_rows(pre, "cpu"))
        cmp_rows("decode_batch", f"{what}: H's blocks, dictionary rows",
                 *dk, *dp)
        for i, (b, n) in enumerate(zip(bufs, p[2].tolist())):
            # (a capacity under 1 leaves no block to decode)
            if int(p[1][i]) and (int(dp[1][i]) != n or
                                 dp[0][i, :n].numpy().tobytes() != b[:n]):
                raise SmokeFailure(f"{what}: block {i} does not decode to "
                                   "its consumed source")

    for case in ds_small_cases(corpus, mixed):
        cmp_dest_size(*case)

    def cmp_resumable(what, rows_c, lens_c, cap, dicts=()):
        """Kernel D's resumable mode against its plain version on CPU
        tensors and their copies on the card, every row at ``cap``;
        returns the plain version's (olen, cons) pairs."""
        caps = i32_tensor([cap] * len(lens_c), "cpu")
        k = dec.decode_blocks_dest_size(
            rows_c.to(cuda), lens_c.to(cuda), caps.to(cuda), W,
            *(t.to(cuda) for t in dicts))
        p = dec.decode_blocks_dest_size(rows_c, lens_c, caps, W, *dicts)
        cmp_third("decode_dest_size", f"{what}, cap {cap}", k, p)
        return list(zip(p[1].tolist(), p[2].tolist()))

    # D resumable on kernel B's 64 rows (3d), at several caps
    b_cpu = (b_out.cpu(), b_olen.cpu())
    for cap in (0, 1, 100, 1000, DS_DECODE_CAP, W):
        cmp_resumable("kernel B's 64 rows", *b_cpu, cap)
    # their resumed rounds, which decode against dictionary rows
    k_total, k_done, k_rounds = resume_decode(b_out, b_olen, 10_000, W)
    p_total, p_done, p_rounds = resume_decode(*b_cpu, 10_000, W)
    if k_rounds != p_rounds:
        raise SmokeFailure("the resumed decode's rounds differ from the "
                           "plain version's")
    cmp_rows("decode_dest_size", f"kernel B's 64 rows resumed in "
             f"{len(p_rounds)} rounds of 10,000 bytes or more (dictionary "
             "rows)",
             k_total, k_done.int(), p_total, p_done.int())
    if not torch.equal(p_done.int(), b_src_lens):
        raise SmokeFailure("the resumed rows do not decode to their lengths")
    # an offset of 0, a block cut after its last match, and the same block
    # cut one byte earlier (inside a sequence)
    row0 = b_cpu[0][0, :int(b_cpu[1][0])].numpy().tobytes()
    zero_off = bytearray(row0)
    run, at = row0[0] >> 4, 1
    if run == 15:
        run, at = _ext(row0, at, run)
    at += run                           # the first sequence's offset
    zero_off[at] = zero_off[at + 1] = 0
    cut = terminal_literals(row0)
    odd = D.byte_rows([bytes(zero_off), row0[:cut], row0[:cut - 1], b""],
                      len(row0), "cpu")
    for cap in (W, 3000):
        verdicts = cmp_resumable("offset 0, cut after a match, cut in a "
                                 "sequence, empty", *odd, cap)
        if verdicts[0] != (-1, -1) or verdicts[3] != (0, 0) or (
                cap == W and (verdicts[1][1] != cut
                              or verdicts[2] != (-1, -1))):
            raise SmokeFailure(f"resumable verdicts {verdicts} at cap {cap}")
    for what, rows_c, lens_c, cap in (
            ("48 corrupted streams", bad, bad_lens, W),
            ("48 corrupted streams", bad, bad_lens, 1000),
            ("64 rows of noise", noise, noise_lens, W)):
        cmp_resumable(f"{what} behind a dictionary", rows_c, lens_c, cap,
                      right_rows([row0[:777]] * len(lens_c), "cpu"))

    # J and K: every length 0..70 (rows 8-aligned, and not), ragged rows
    from lz4_tpu_torch.kernels import xxh32_kernel
    from lz4_tpu_torch.kernels.xxh32_kernel import xxh32_batch
    from lz4_tpu_torch.kernels.xxh64_kernel import xxh64_batch
    from lz4_tpu_torch.ops.xxhash import xxh32 as host_xxh32

    def cmp_xxh(what, bufs, width, seed, offset=0):
        """J and K against their plain versions on ``bufs`` in rows of
        ``width`` bytes, on the card ``offset`` bytes into their storage,
        and J against the host XXH32 of every buffer."""
        rows_c, lens_c = D.byte_rows(bufs, width, "cpu")
        flat = torch.zeros((offset + rows_c.numel(),), dtype=torch.uint8,
                           device=cuda)
        flat[offset:] = rows_c.reshape(-1).to(cuda)
        rows_d = flat[offset:].view(rows_c.shape)
        for kernel, fn in (("xxh32", xxh32_batch), ("xxh64", xxh64_batch)):
            k = fn(rows_d, lens_c.to(cuda), seed)
            p = fn(rows_c, lens_c, seed)
            err = int((k != p).sum())
            stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"],
                                               err)
            log(f"[compare] {kernel:14s} {what}, seed {seed:#x}, storage "
                f"offset {offset}: rows={len(p)} differing digests={err}")
            if err:
                raise SmokeFailure(f"{kernel} disagrees with its plain "
                                   f"version on {what}")
            if kernel == "xxh32" and k.tolist() != [
                    host_xxh32(b, seed & 0xFFFFFFFF) for b in bufs]:
                raise SmokeFailure(f"xxh32_batch differs from the host "
                                   f"XXH32 on {what}")

    ragged = [0, 1, 3, 4, 5, 15, 16, 17, 31, 32, 33, 63, 64, 100, 1000, 4096,
              65536, 65537, 100001]
    for seed in XXH_SEEDS:
        for width in (72, 77):           # 77: rows start at odd addresses
            cmp_xxh(f"lengths 0..70 in rows of {width}",
                    [mixed[1000 + n:1000 + 2 * n] for n in range(71)], width,
                    seed)
        cmp_xxh("ragged rows up to 100,001 bytes",
                [corpus[i * 1000:i * 1000 + n] for i, n in enumerate(ragged)],
                max(ragged), seed)
    # rows at any address: the staging copies from the 16-byte granule of
    # a row's first byte; lengths either side of the staging's tiles;
    # batch sizes around its groups of 8 rows; one long row among short
    for offset in (1, 2, 3, 15):
        for width in (72, 77):
            cmp_xxh(f"lengths 0..70 in rows of {width}",
                    [mixed[1000 + n:1000 + 2 * n] for n in range(71)], width,
                    0x9E3779B1, offset)
        cmp_xxh("8 rows of 65,536 bytes",
                [corpus[i * W + 5 * i:(i + 1) * W - 3 * i] for i in range(8)],
                W, 0, offset)
    tile = xxh32_kernel.TILE
    edges = [n + d for n in (tile, 2 * tile) for d in (-1, 0, 1)]
    for offset in (0, 5):
        cmp_xxh(f"lengths {edges} (tiles of {tile})",
                [corpus[i * 9000:i * 9000 + n] for i, n in enumerate(edges)],
                max(edges), (1 << 63) + 12345, offset)
    rng = random.Random(12)
    for nrows in (1, 7, 4097):
        cmp_xxh(f"{nrows} ragged rows up to 2,000 bytes",
                [corpus[i * 500:i * 500 + rng.randint(0, 2000)]
                 for i in range(nrows)], 2000, 1, 3)
    cmp_xxh("one row of 1 MiB beside 63 rows of 4 KB",
            [corpus[:1 << 20]] + [corpus[(1 << 20) + i * 4096:
                                         (1 << 20) + (i + 1) * 4096]
                                  for i in range(63)], 1 << 20, 0)

    # the corpus batches of the destsize phase: sampled rows against the
    # plain versions, and the times (median of three single launches)
    ds_rows_d, ds_lens = corpus_rows(corpus, cuda)
    nrows = ds_rows_d.shape[0]
    sample = sorted({round(i * (nrows - 2) / (DS_SAMPLE_ROWS - 1))
                     for i in range(DS_SAMPLE_ROWS)})
    idx = torch.tensor(sample, device=cuda)
    half = torch.clamp(ds_lens // 2, min=64)
    h_args = (ds_rows_d, ds_lens, half)
    k = dsk.encode_blocks_dest_size(*h_args)
    p, h_plain = time_host(lambda: dsk.encode_blocks_dest_size(
        *(t[idx].cpu() for t in h_args)))
    cmp_third("encode_dest_size", f"corpus rows {sample} of {nrows}, cap "
              "n/2", [t[idx] for t in k], p)
    h_ms = time_rounds(lambda: dsk.encode_blocks_dest_size(*h_args))
    stats["encode_dest_size"].update(
        ms=sorted(h_ms)[1], ms_rounds=h_ms, plain_ms=h_plain,
        plain_rows=len(sample))
    # the rows as far as consumed and three lengths per row in; blocks,
    # olen and consumed out
    set_bound("encode_dest_size", int(k[2].sum()) + 12 * nrows,
              int(k[1].sum()) + 8 * nrows)
    joined, j_slens, j_wlens = prefix_rows(ds_rows_d)
    hp_args = (joined, j_slens, j_slens // 2, 1, j_wlens)
    kp = dsk.encode_blocks_dest_size(*hp_args)
    pp, hp_plain = time_host(lambda: dsk.encode_blocks_dest_size(
        *(t[idx].cpu() if isinstance(t, torch.Tensor) else t
          for t in hp_args)))
    cmp_third("encode_dest_size", f"rows [block i-1 | block i] {sample}, "
              "cap n/2", [t[idx] for t in kp], pp)
    dk = dec.decode_blocks(kp[0][idx], kp[1][idx], W, kp[2][idx],
                           ds_rows_d[idx], j_wlens[idx])
    dp = dec.decode_blocks(pp[0], pp[1], W, pp[2], ds_rows_d[idx].cpu(),
                           j_wlens[idx].cpu())
    cmp_rows("decode_batch", f"H's blocks of rows {sample}, block i-1 as "
             "the dictionary row", *dk, *dp)
    hp_ms = time_rounds(lambda: dsk.encode_blocks_dest_size(*hp_args))
    stats["encode_dest_size"].update(
        ms_prefix=sorted(hp_ms)[1], ms_rounds_prefix=hp_ms,
        plain_ms_prefix=hp_plain)
    del joined, kp, pp, k, p
    # D resumable, first round: kernel B's payloads at out_caps 32,768
    ds_comp, ds_clen = kernel_b_payloads(ds_rows_d, ds_lens)
    r_args = (ds_comp, ds_clen, i32_tensor([DS_DECODE_CAP] * nrows, cuda),
              DS_DECODE_CAP)
    k = dec.decode_blocks_dest_size(*r_args)
    p, r_plain = time_host(lambda: dec.decode_blocks_dest_size(
        *(t[idx].cpu() for t in r_args[:3]), DS_DECODE_CAP))
    cmp_third("decode_dest_size", f"kernel B's payloads of corpus rows "
              f"{sample}, cap {DS_DECODE_CAP}", [t[idx] for t in k], p)
    r_ms = time_rounds(lambda: dec.decode_blocks_dest_size(*r_args))
    stats["decode_dest_size"].update(
        ms=sorted(r_ms)[1], ms_rounds=r_ms, plain_ms=r_plain,
        plain_rows=len(sample))
    # the payload bytes consumed, and a length and a cap per row in; the
    # bytes produced, olen and cons out
    set_bound("decode_dest_size", int(k[2].sum()) + 8 * nrows,
              int(k[1].sum()) + 8 * nrows)
    # D batch on the same payloads, whole rows: the shape of a 64 MiB -B4
    # frame; every row must be its corpus row, sampled rows the plain's
    b_args = (ds_comp, ds_clen, W)
    k = dec.decode_blocks(*b_args)
    p, b_plain = time_host(lambda: dec.decode_blocks(
        ds_comp[idx].cpu(), ds_clen[idx].cpu(), W))
    cmp_rows("decode_batch", f"kernel B's payloads of corpus rows {sample}",
             k[0][idx], k[1][idx], *p)
    if not (bool((k[1] == W).all()) and torch.equal(k[0], ds_rows_d)):
        raise SmokeFailure("batch D does not decode the 1,024 corpus rows "
                           "to the corpus")
    b_ms = time_rounds(lambda: dec.decode_blocks(*b_args))
    stats["decode_batch"].update(
        ms_rows1024=sorted(b_ms)[1], ms_rounds_rows1024=b_ms,
        plain_ms_rows1024=b_plain, plain_rows=len(sample),
        bound_ms_rows1024=(int(ds_clen.sum()) + 4 * nrows + nrows * W)
        / HBM_BYTES_PER_S * 1e3)
    log(f"[time] decode_batch (D), {nrows} corpus rows of 64 KB: rounds "
        f"{[round(t, 3) for t in b_ms]} ms, plain {b_plain:.1f} ms on "
        f"{len(sample)} rows; every row equals the corpus")
    del ds_comp, k, p
    # J and K on the rows, on 4 KB pages and on rows of 77 bytes, every row
    # against the plain
    for shape, (r, n) in (("rows", (ds_rows_d, ds_lens)),
                          ("pages", xxh_pages(ds_rows_d)),
                          ("rows of 77", xxh_rows77(ds_rows_d))):
        r_h, n_h = r.cpu(), n.cpu()
        for kernel, fn in (("xxh32", xxh32_batch), ("xxh64", xxh64_batch)):
            p, plain_ms = time_host(lambda: fn(r_h, n_h, 0))
            err = int((fn(r, n, 0) != p).sum())
            stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"],
                                               err)
            log(f"[compare] {kernel:14s} {len(p)} corpus {shape} of "
                f"{r.shape[1]} bytes: differing digests={err}")
            if err:
                raise SmokeFailure(f"{kernel} disagrees with its plain "
                                   f"version on the corpus {shape}")
            rounds = time_rounds(lambda: fn(r, n, 0))
            tag = {"rows": "", "pages": "_pages", "rows of 77": "_rows77"}[
                shape]
            stats[kernel].update({"ms" + tag: sorted(rounds)[1],
                                  "ms_rounds" + tag: rounds,
                                  "plain_ms" + tag: plain_ms})
            if shape == "rows":
                # the rows and their lengths in, one digest per row out
                set_bound(kernel, r.numel() + 4 * nrows,
                          (4 if kernel == "xxh32" else 8) * nrows)
                # 256 rows (16 MiB) resident in L2 after a warm launch: the
                # kernel's time is about the per-row chain
                stats[kernel]["chain_ms"] = xxh_launch(
                    build, kernel, r[:256], n[:256])[0]
    mb = len(corpus) / 1e3
    log(f"[time] encode_dest_size (kernel H), {nrows} rows of 64 KB, cap "
        f"n/2: rounds {[round(t, 3) for t in h_ms]} ms "
        f"({mb / sorted(h_ms)[1]:.1f} MB/s of rows), behind 64 KB prefixes "
        f"{[round(t, 3) for t in hp_ms]} ms; plain version {h_plain:.1f} ms "
        f"and {hp_plain:.1f} ms on {len(sample)} rows; decode_dest_size (D "
        f"resumable), first round at {DS_DECODE_CAP}: rounds "
        f"{[round(t, 3) for t in r_ms]} ms, plain {r_plain:.1f} ms on "
        f"{len(sample)} rows; " + "; ".join(
            f"{k} {stats[k]['ms']:.3f} ms ({mb / 1e3 / stats[k]['ms']:.1f} "
            f"GB/s) on the rows, {stats[k]['ms_pages']:.3f} ms on "
            f"{XXH_PAGE_BYTES >> 20} MiB of 4 KB pages, "
            f"{stats[k]['ms_rows77']:.3f} ms as rows of 77 bytes, each with "
            f"its fetch (plain version {stats[k]['plain_ms']:.1f} ms on the "
            f"rows); the kernel alone on 256 rows in L2 "
            f"{stats[k]['chain_ms']:.4f} ms"
            for k in ("xxh32", "xxh64")))
    del ds_rows_d

    # -- 3j. the tails of kernels A and I (legacy compress's join) ----------
    def cmp_tails(kernel, what, k_off, k_on, p_on):
        """With tails on, the card's payloads equal its payloads with tails
        off, and payloads and tails equal the plain version's (tolerance
        0)."""
        cmp_rows(kernel, f"{what}, tails on against off", *k_on[:2], *k_off)
        cmp_rows(kernel, f"{what}, tails on", *k_on[:2], *p_on[:2])
        err = int((k_on[2].cpu().long() - p_on[2].long()).abs().max())
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        log(f"[compare] {kernel:14s} {what}: tails of {p_on[2].numel()} "
            f"blocks max_abs_err={err}")
        if err:
            raise SmokeFailure(f"{kernel}'s tails disagree with its plain "
                               f"version on {what}")

    tail_cases = [(f"9 blocks mm={mm}, no prefix",
                   linked_case(corpus[3 * W:12 * W + 20_011], b"", mm))
                  for mm in (4, 8)]
    tail_cases.append(("64 blocks mm=8 (main-path chunk)", linked_case(
        corpus[4 << 20:8 << 20], corpus[(4 << 20) - W:4 << 20], 8,
        zero=True)))
    tail_cases.append(("4 MB of noise, mm=4", linked_case(
        noise_bytes(MB4, 17), b"", 4)))
    for what, (card, cpu) in tail_cases:
        cmp_tails("encode_linked", what, enc.scan_linked(*card),
                  enc.scan_linked(*card, tails=True),
                  enc.scan_linked(*cpu, tails=True))
    card = tail_cases[2][1][0]
    stats["encode_linked"]["ms_tails"] = time_card(
        lambda: enc.scan_linked(*card, tails=True))
    log(f"[time] encode_linked (kernel A), main-path chunk: "
        f"{stats['encode_linked']['ms']:.3f} ms with tails off, "
        f"{stats['encode_linked']['ms_tails']:.3f} ms with tails on")
    del tail_cases, card
    for what, blocks, width in hc_small_cases(corpus, mixed):
        rows_h, lens_h = D.byte_rows(blocks, width, "cpu")
        tabs = hck.hc_sorted_tables(rows_h.to(cuda))
        tabs_h = [t.cpu() for t in tabs]
        for level in (1, 9) if width == HC_SMALL_NS else (9,):
            args = (rows_h.to(cuda), lens_h.to(cuda), tabs, level)
            cmp_tails("encode_hc", f"{what}, level {level}",
                      hck.hc_scan(*args), hck.hc_scan(*args, tails=True),
                      hck.hc_scan(rows_h, lens_h, tabs_h, level, tails=True))
    hc_rows = torch.frombuffer(bytearray(corpus), dtype=torch.uint8) \
        .reshape(-1, W).to(cuda)
    hc_lens = torch.full((hc_rows.shape[0],), W, dtype=torch.int32,
                         device=cuda)
    hc_tabs = hck.hc_sorted_tables(hc_rows)
    k_off = hck.hc_scan(hc_rows, hc_lens, hc_tabs, 9)
    k_on = hck.hc_scan(hc_rows, hc_lens, hc_tabs, 9, tails=True)
    cmp_rows("encode_hc", f"{hc_rows.shape[0]} corpus rows, level 9, tails "
             "on against off", *k_on[:2], *k_off)
    stats["encode_hc"]["ms_tails_rounds"] = time_rounds(
        lambda: hck.hc_scan(hc_rows, hc_lens, hc_tabs, 9, tails=True))
    stats["encode_hc"]["ms_tails"] = sorted(
        stats["encode_hc"]["ms_tails_rounds"])[1]
    log(f"[time] encode_hc (kernel I), {hc_rows.shape[0]} rows, level 9: "
        f"{stats['encode_hc']['ms']:.3f} ms with tails off, rounds with "
        f"tails on {[round(t, 3) for t in stats['encode_hc']['ms_tails_rounds']]}"
        " ms")
    del hc_rows, hc_lens, hc_tabs, k_off, k_on

    # -- 3k. kernel G with a list axis: the mesh phase's bucket --------------
    def cmp_chain_batch(what, k, p):
        """Exact comparison of two sg_encode_chain_batch results: every
        list's boff, blen, consumed, isz and osz, and its block bytes up to
        the end of its last step."""
        torch.cuda.synchronize()
        (kb, *kr), (pb, *pr) = k, p
        err = max(int((a.cpu().long() - b.long()).abs().max())
                  for a, b in zip(kr, pr))
        boff, blen = pr[0], pr[1]
        for i in range(len(pb)):
            live = int((blen[i] >= 0).sum())
            end = int(boff[i, live - 1] + blen[i, live - 1]) if live else 0
            if end:
                err = max(err, int((kb[i, :end].cpu().int()
                                    - pb[i, :end].int()).abs().max()))
        stats["sg_encode_chain_batch"]["max_abs_err"] = max(
            stats["sg_encode_chain_batch"]["max_abs_err"], err)
        log(f"[compare] sg_encode_chain_batch {what}: lists={len(pb)} "
            f"steps={int((blen >= 0).sum())} max_abs_err={err}")
        if err:
            raise SmokeFailure(f"sg_encode_chain_batch disagrees on {what}")

    m_lists, m_caps, _ = mesh_sg_lists(corpus)
    bucket = m_lists[:MESH_SG_LISTS]
    b_caps = m_caps[0]
    b_rows, b_ends = pmesh.sg_bucket_rows(bucket, "cpu")
    b_args = (b_ends, b_caps, sum(b_caps))
    b_card = b_rows.to(cuda)
    k = dsk.sg_encode_chain_batch(b_card, *b_args)
    p, plain_ms = time_host(lambda: dsk.sg_encode_chain_batch(b_rows,
                                                              *b_args))
    cmp_chain_batch(f"{MESH_SG_LISTS} lists of 256 KB (the mesh phase's "
                    "bucket) against its plain version", k, p)
    # the same lists one launch each (the single-list kernel G)
    singles = [dsk.sg_encode_chain(b_card[i], *b_args)
               for i in range(MESH_SG_LISTS)]
    width = max(len(s[0]) for s in singles)
    cmp_chain_batch(f"{MESH_SG_LISTS} lists of 256 KB against one "
                    "sg_encode_chain launch per list", k, (
                        torch.stack([torch.nn.functional.pad(
                            s[0], (0, width - len(s[0]))) for s in singles]
                        ).cpu(),
                        *(torch.stack([s[j] for s in singles]).cpu()
                          for j in range(1, 6))))
    del singles
    # four lists of the bucket in one launch, against the plain version
    cmp_chain_batch("4 lists of 256 KB against its plain version",
                    dsk.sg_encode_chain_batch(b_card[:4], *b_args),
                    dsk.sg_encode_chain_batch(b_rows[:4], *b_args))
    bucket_ms = time_rounds(lambda: dsk.sg_encode_chain_batch(b_card,
                                                              *b_args))
    four_ms = time_rounds(lambda: dsk.sg_encode_chain_batch(b_card[:4],
                                                            *b_args))
    _, single_ms = event_ms(lambda: [dsk.sg_encode_chain(b_card[i], *b_args)
                                     for i in range(MESH_SG_LISTS)])
    stats["sg_encode_chain_batch"].update(
        ms=sorted(bucket_ms)[1], ms_rounds=bucket_ms, plain_ms=plain_ms,
        lists=MESH_SG_LISTS, ms_4_lists=sorted(four_ms)[1],
        ms_single_launches=single_ms)
    T = k[1].shape[1]
    # the lists' content, input ends and caps in; blocks and records out
    blocks_out = sum(int(k[1][i, int((k[2][i] >= 0).sum()) - 1]
                         + k[2][i, int((k[2][i] >= 0).sum()) - 1])
                     for i in range(MESH_SG_LISTS))
    set_bound("sg_encode_chain_batch",
              MESH_SG_LISTS * MESH_SG_LIST + 4 * (len(b_ends) + len(b_caps)),
              blocks_out + MESH_SG_LISTS * T * (8 + 4 * 4))
    mb = MESH_SG_LISTS * MESH_SG_LIST / 1e6
    log(f"[time] sg_encode_chain_batch, {MESH_SG_LISTS} lists of 256 KB in "
        f"one launch: rounds {[round(t, 3) for t in bucket_ms]} ms "
        f"({mb / sorted(bucket_ms)[1] * 1e3:.1f} MB/s); 4 lists "
        f"{sorted(four_ms)[1]:.3f} ms; {MESH_SG_LISTS} single-list launches "
        f"{single_ms:.3f} ms; plain version {plain_ms:.1f} ms")
    del k, p, b_card, b_rows
    # -- 3l. kernel I behind prefixes: small cases, corpus rows, times -------
    def cmp_hc_prefixed(what, args_h, level, serial=True):
        """Kernel I behind prefixes against its plain version (payloads,
        olen and tails) and the serial walk, at tolerance 0."""
        rows_h, lens_h, wls_h = args_h
        args = [t.to(cuda) for t in args_h]
        cmp_tails("encode_hc", f"{what}, level {level}",
                  hck.encode_blocks_hc(*args[:2], level, window_lens=args[2]),
                  hck.encode_blocks_hc(*args[:2], level, tails=True,
                                       window_lens=args[2]),
                  hck.encode_blocks_hc(rows_h, lens_h, level, tails=True,
                                       window_lens=wls_h))
        if serial:
            cmp_rows("encode_hc", f"{what}, level {level}, serial walk",
                     *hck.encode_blocks_hc(*args[:2], level,
                                           window_lens=args[2]),
                     *hck.hc_scan_serial(rows_h, lens_h, level,
                                         window_lens=wls_h))

    cases = hc_prefix_cases(corpus)
    narrow = [k for k, (p_, s_) in cases.items() if len(p_ + s_) <= W]
    for names in (narrow, [k for k in cases if k not in narrow]):
        args_h = ds_rows([cases[k][1] for k in names],
                         [cases[k][0] for k in names], "cpu")
        what = (f"{len(names)} rows behind prefixes, "
                f"{hck.table_dtype(args_h[0].shape[1])} tables")
        for level in HC_PREFIX_SMALL_LEVELS:
            cmp_hc_prefixed(what, args_h, level)
        # rows that start at any byte of their storage
        for off in (1, 3):
            store = torch.zeros(args_h[0].numel() + 4, dtype=torch.uint8,
                                device=cuda)
            view = store[off:off + args_h[0].numel()].view(args_h[0].shape)
            view.copy_(args_h[0].to(cuda))
            cmp_rows("encode_hc", f"{what}, at storage offset {off}, "
                     "level 9", *hck.encode_blocks_hc(
                         view, args_h[1].to(cuda), 9,
                         window_lens=args_h[2].to(cuda)),
                     *hck.encode_blocks_hc(*args_h[:2], 9,
                                           window_lens=args_h[2]))
    # the corpus as 1,024 rows [64 KB | 64 KB]: sampled rows at each level,
    # the whole batch timed at level 9 beside the independent rows
    pre_args = hc_prefixed_batch(cuda)
    nrows = pre_args[0].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pre_tabs = hck.hc_sorted_tables(pre_args[0])
    torch.cuda.synchronize()
    stats["encode_hc"]["table_peak_bytes_prefixed"] = \
        torch.cuda.max_memory_allocated() - base
    stats["encode_hc"]["table_ms_prefixed"] = time_card(
        lambda: hck.hc_sorted_tables(pre_args[0]), reps=2)
    sample = [round(i * (nrows - 1) / (HC_PREFIX_ROWS - 1))
              for i in range(HC_PREFIX_ROWS)]
    idx = torch.tensor(sample, device=cuda)
    sampled = [t[idx].cpu().contiguous() for t in pre_args]
    for level in HC_PREFIX_LEVELS:
        cmp_hc_prefixed(f"corpus rows {sample} of {nrows} behind 64 KB "
                        "prefixes", sampled, level, serial=level == 9)
    k = hck.hc_scan(*pre_args[:2], pre_tabs, 9, window_lens=pre_args[2])
    pre_ms = time_rounds(lambda: hck.hc_scan(
        *pre_args[:2], pre_tabs, 9, window_lens=pre_args[2]))
    stats["encode_hc"].update(ms_prefixed=sorted(pre_ms)[1],
                              ms_prefixed_rounds=pre_ms,
                              ratio_prefixed=int(k[1].sum()) / (nrows * W))
    # rows, the 32-bit perm, slot at the source positions (the kernel
    # reads slot[q] only where it parses) and the lengths in; payloads and
    # lengths out
    pre_in = (pre_args[0].numel() + 4 * pre_tabs[0].numel()
              + 4 * int(pre_args[1].sum()) + 8 * nrows)
    pre_out = int(k[1].sum()) + 4 * nrows
    stats["encode_hc"].update(
        bytes_in_prefixed=pre_in, bytes_out_prefixed=pre_out,
        bound_ms_prefixed=(pre_in + pre_out) / HBM_BYTES_PER_S * 1e3)
    log(f"[time] encode_hc (kernel I), {nrows} rows [64 KB prefix | 64 KB "
        f"source], level 9: rounds {[round(t, 3) for t in pre_ms]} ms "
        f"({nrows * W / 1e3 / sorted(pre_ms)[1]:.1f} MB/s, bound "
        f"{stats['encode_hc']['bound_ms_prefixed']:.4f} ms), ratio of the "
        f"payloads {stats['encode_hc']['ratio_prefixed']:.6f}; tables "
        f"{stats['encode_hc']['table_ms_prefixed']:.3f} ms, "
        f"{stats['encode_hc']['table_peak_bytes_prefixed'] / 2**20:.1f} MiB "
        f"peak; the independent rows {stats['encode_hc']['ms']:.3f} ms")
    del pre_args, pre_tabs, sampled, k, cases

    # the mesh phase's rows, encoded by one unsharded call
    mesh_ref = enc.encode_blocks(*corpus_rows(corpus, cuda))

    def phase_counts(phase, need):
        """Read the counters after a phase: every kernel in ``need`` must
        have launched and no plain version may have run."""
        launches = {k: common.LAUNCHES.get(k, 0) for k in KERNELS}
        plain = dict(common.PLAIN_CALLS)
        log(f"[counts] {phase}: kernel launches {launches}; plain-version "
            f"calls {plain}")
        missing = [k for k in need if launches[k] <= 0]
        if missing or any(plain.values()):
            raise SmokeFailure(f"{phase} skipped kernels {missing} or ran "
                               f"plain versions {plain}")
        return launches

    # -- 4. main path at full size -----------------------------------------
    common.reset_counts()
    for mm, rs, checksum in MAIN_POINTS:
        prefs = FramePreferences(block_size_id=4, content_checksum=checksum)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = D.compress_frame_device(corpus, prefs, min_match=mm,
                                        reject_step=rs)
        t1 = time.perf_counter()
        out, used = D.decompress_frame_device(frame)
        t2 = time.perf_counter()
        what = f"mm={mm} rs={rs}" + (" content checksum" if checksum else "")
        if out != corpus or used != len(frame):
            raise SmokeFailure(f"64 MiB round trip differs at {what}")
        mb = len(corpus) / 1e6
        log(f"[main] {len(corpus) >> 20} MiB corpus {what}: ratio "
            f"{len(frame) / len(corpus):.6f} ({len(frame)} bytes), "
            f"compress {mb / (t1 - t0):.1f} MB/s ({t1 - t0:.3f} s), "
            f"decompress {mb / (t2 - t1):.1f} MB/s ({t2 - t1:.3f} s), "
            f"round trip byte-exact")
        del out
    counts = {"main": phase_counts(
        "main path", [k for k, v in KERNELS.items() if v[3] == "main"])}

    # -- 5. the other entry points -------------------------------------------
    common.reset_counts()
    cases = (
        ("4 MB one-shot linked", corpus[:4 << 20],
         FramePreferences(block_size_id=4)),
        ("60 KB (kernel B)", corpus[:60_000],
         FramePreferences(block_size_id=4)),
        ("3 MB independent + checksums", corpus[:3 << 20],
         FramePreferences(block_size_id=4, block_independent=True,
                          block_checksum=True, content_checksum=True,
                          content_size=3 << 20)),
        ("2 MB independent, packed", corpus[:2 << 20],
         FramePreferences(block_size_id=4, block_independent=True)),
    )
    for what, data, pr in cases:
        frame = D.compress_frame_device(data, pr, min_match=8)
        out, used = D.decompress_frame_device(frame)
        if out != data or used != len(frame):
            raise SmokeFailure(f"round trip differs: {what}")
        log(f"[entry] {what}: ratio {len(frame) / len(data):.6f}, "
            f"round trip byte-exact")
    # the corpus as a -B4 frame: 1,024 rows in one launch of batch D
    frame = b4_frame(corpus, cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, used = D.decompress_frame_device(frame)
    wall = time.perf_counter() - t0
    if out != corpus or used != len(frame):
        raise SmokeFailure("the 64 MiB -B4 frame does not round-trip")
    log(f"[entry] {len(corpus) >> 20} MiB -B4 frame (io.compress_stream -1 "
        f"-B4): ratio {len(frame) / len(corpus):.6f}, decompress "
        f"{len(corpus) / 1e6 / wall:.1f} MB/s ({wall:.3f} s), byte-exact")
    del out, frame
    counts["entry"] = phase_counts(
        "entry points",
        [k for k, v in KERNELS.items() if v[3] in ("main", "entry")])

    # -- 6. the stream path at full size -------------------------------------
    common.reset_counts()
    stream_phase(files, corpus, cuda, REPO / "tests" / "fixtures",
                 REPO / "build")
    counts["stream"] = phase_counts("stream path",
                                    ["decode_stream", "decode_linked"])
    b7_blocks = [p for p, _ in frame_payloads(files["b7"], 7)]
    api_frames = {"linked 64 KB-block (flushed)": (files["flushed"], corpus),
                  "-B7 independent": (files["b7"], corpus)}
    del files

    # -- 7. the scatter-gather path at full size ----------------------------
    common.reset_counts()
    sg_times = {}
    sg_phase(layouts, cuda, sg_times)
    counts["sg"] = phase_counts("sg path", ["sg_encode_chain", "decode_sg",
                                            "decode_stream"])
    sg_4k = layouts["4k"]
    del layouts

    # -- 8. the HC and file-compress path at full size -----------------------
    common.reset_counts()
    hc_times = hc_phase(corpus, cuda, REPO / "build", hc_phase_ms)
    counts["hc"] = phase_counts("hc path", [
        "encode_hc", "pack", "encode", "encode_linked", "decode_stream",
        "decode_linked", "decode_batch"])

    # -- 9. the destSize and checksum path at full size -----------------------
    common.reset_counts()
    ds_times = destsize_phase(corpus, cuda)
    counts["destsize"] = phase_counts("destsize path", [
        "encode_dest_size", "decode_dest_size", "decode_batch", "encode",
        "xxh32", "xxh64", "decode_stream"])

    # -- 10. legacy compress at full size ------------------------------------
    common.reset_counts()
    legacy_times = legacy_phase(corpus, cuda)
    counts["legacy"] = phase_counts("legacy compress", [
        "encode_linked", "encode_hc", "decode_stream"])

    # -- 11. the single-card envelope ------------------------------------------
    common.reset_counts()
    envelope_times = envelope_phase(corpus, b7_blocks, cuda, sg_4k)
    counts["envelope"] = phase_counts("envelope", [
        "decode_stream", "encode_dest_size", "sg_encode_chain", "decode_sg"])
    del b7_blocks, sg_4k

    # -- 12. the plain decoder reads a frame the kernels wrote ----------------
    data = corpus[8 << 20:9 << 20]
    frame = D.compress_frame_device(data, FramePreferences(block_size_id=4),
                                    min_match=8)
    if D.decompress_frame_device(frame, device="cpu") != (data, len(frame)):
        raise SmokeFailure("plain decoder disagrees on a kernel-written frame")
    log("[check] plain decoder reads a 1 MB frame written by the kernels")

    # -- 13-14. the mesh and multihost paths ---------------------------------
    mesh_counts, mesh_times = parallel_phases(corpus, mesh_ref, card_line)
    counts.update(mesh_counts)
    del mesh_ref

    # -- 15. the library API: block, stream and frame ------------------------
    common.reset_counts()
    api_results, api_walls = api_phase(corpus, api_frames, cuda)
    counts["api"] = phase_counts("api", [
        "encode", "encode_linked", "pack", "encode_dest_size",
        "decode_batch", "decode_dest_size", "decode_stream", "encode_hc"])
    api_plain_check(corpus, api_frames, api_results)
    del api_results, api_frames
    api_record = {"walls_s": api_walls, **api_times(corpus, cuda, card_line)}

    # -- 16. the HC API: hc.py and linked HC frames --------------------------
    common.reset_counts()
    hc_results, hc_walls = hc_api_phase(corpus, cuda)
    counts["hc_api"] = phase_counts("hc api", [
        "encode_hc", "decode_batch", "decode_linked", "decode_stream"])
    frames = hc_results[-2:]
    hc_api_plain_check(corpus, hc_results)
    del hc_results
    hc_api_record = {
        "card": card_line, "walls_s": hc_walls,
        "frames": {f"-B{b} linked level 9": {
            "ratio": len(f) / len(corpus), "frame_bytes": len(f)}
            for b, f in zip((4, 7), frames)},
        "calls": hc_api_times(corpus, cuda)}
    log("[hc-api] linked level-9 frames of the corpus: " + ", ".join(
        f"{k} ratio {v['ratio']:.6f}"
        for k, v in hc_api_record["frames"].items())
        + f" (compress_frame_device_hc, independent 64 KB blocks: "
        f"{hc_times['-9']['ratio']:.6f} as a file)")
    del frames

    # -- 17. kernel A's adaptive mode: a min_match per block ----------------
    # the main path's chunk behind its window, mm_rows cycling (4, 6, 8, 12)
    host = adaptive_stream(corpus, 4 << 20)
    card = tuple(t.to(cuda) for t in host)
    nb = host[1].shape[1]

    def mm_all(v):
        return torch.full((1, nb), v, dtype=torch.int32)

    tabs = {}
    for what, mmr in (("mixed", adaptive_mm(nb)), ("all 8", mm_all(8)),
                      ("all 4", mm_all(4))):
        d_c, j_c = enc.linked_tables(card[0], nb, 4, None, mmr.to(cuda))
        d_p, j_p = enc.linked_tables(host[0], nb, 4, None, mmr)
        if not (torch.equal(d_c.cpu(), d_p) and torch.equal(j_c.cpu(), j_p)):
            raise SmokeFailure(f"kernel A's per-block tables ({what}) on the "
                               f"card differ from the CPU's")
        tabs[what] = (d_c, j_c, d_p, j_p, mmr.to(cuda), mmr)
    static = {v: enc.linked_tables(card[0], nb, v) for v in (4, 8, 12)}
    apart = int((static[8][0] != tabs["all 8"][0]).sum())
    log(f"[adaptive] per-block tables of {nb} blocks (mixed, all 8, all 4) "
        f"on the card equal the CPU's; all 8 against the static mm=8 "
        f"tables: {apart} lanes apart")
    d_c, j_c, d_p, j_p, mm_d, mm_h = tabs["mixed"]
    k = enc.scan_linked(*card, d_c, j_c, mm_rows=mm_d)
    p, plain_ms = time_host(
        lambda: enc.scan_linked(*host, d_p, j_p, mm_rows=mm_h))
    cmp_rows("encode_linked", f"{nb} blocks, mm_rows cycling "
             f"{ADAPTIVE_CYCLE} (adaptive)", *k, *p)
    mixed_out = int(k[1].sum())
    for v in (4, 8):
        u = enc.scan_linked(*card, *tabs[f"all {v}"][:2],
                            mm_rows=tabs[f"all {v}"][4])
        st = enc.scan_linked(*card, *static[v], 1, v)
        torch.cuda.synchronize()
        same = torch.equal(u[1], st[1]) and all(
            torch.equal(u[0][0, r, :n], st[0][0, r, :n])
            for r, n in enumerate(st[1][0].tolist()))
        log(f"[adaptive] mm_rows all {v} against static mm={v}: "
            f"{int(st[1].sum())} bytes, {'equal' if same else 'DIFFER'}")
        if not same:
            raise SmokeFailure(f"uniform mm_rows of {v} differ from the "
                               f"static kernel A at min_match={v}")
    # one call: the scan at static 4, 8 and 12, at mm_rows all 8 and mixed,
    # rounds alternating; the tables apart
    scans = {f"static mm={v}": functools.partial(
        enc.scan_linked, *card, *static[v], 1, v) for v in (4, 8, 12)}
    scans.update({
        "mm_rows all 8": lambda: enc.scan_linked(
            *card, *tabs["all 8"][:2], mm_rows=tabs["all 8"][4]),
        "mm_rows mixed": lambda: enc.scan_linked(*card, d_c, j_c,
                                                 mm_rows=mm_d)})
    scan_ms = {kname: [] for kname in scans}
    for order in (list(scans), list(scans)[::-1]):
        for kname in order:
            scan_ms[kname].append(time_card(scans[kname]))
    table_ms = {
        "static mm=8": time_card(lambda: enc.linked_tables(card[0], nb, 8)),
        "mm_rows all 8": time_card(lambda: enc.linked_tables(
            card[0], nb, 4, None, tabs["all 8"][4])),
        "mm_rows mixed": time_card(lambda: enc.linked_tables(
            card[0], nb, 4, None, mm_d))}
    rows_d = corpus_rows(corpus, cuda)[0]
    frac = enc.cand_frac8_rows(rows_d)
    pick = torch.linspace(0, rows_d.shape[0] - 1, 8).long()
    if not torch.equal(frac[pick.to(cuda)].cpu(),
                       enc.cand_frac8_rows(rows_d[pick.to(cuda)].cpu())):
        raise SmokeFailure("cand_frac8_rows on the card differs from the "
                           "CPU's")
    frac_ms = time_card(lambda: enc.cand_frac8_rows(rows_d))
    fq = torch.quantile(frac.float().cpu(), torch.tensor([0, .5, 1.])).tolist()
    bound_in = card[0].numel() + 4 * (d_c.numel() + j_c.numel()
                                      + card[1].numel() + 1 + mm_d.numel())
    adaptive = {
        "card": card_line, "blocks": nb, "cycle": list(ADAPTIVE_CYCLE),
        "scan_ms": scan_ms, "table_ms": table_ms, "plain_ms": plain_ms,
        "bound_ms": (bound_in + mixed_out) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "mixed_payload_bytes": mixed_out,
        "lanes_apart_all8_static8": apart,
        "cand_frac8_ms": frac_ms, "cand_frac8_rows": rows_d.shape[0],
        "cand_frac8_min_median_max": fq}
    del tabs, static, rows_d, frac, card, host, k, p, scans
    log(f"[time] adaptive kernel A, {nb} blocks: scan ms "
        + ", ".join(f"{kn} {v}" for kn, v in scan_ms.items())
        + "; tables ms " + ", ".join(f"{kn} {v:.3f}"
                                     for kn, v in table_ms.items())
        + f"; plain {plain_ms:.1f} ms; bound {adaptive['bound_ms']:.4f} ms; "
        f"cand_frac8_rows on {adaptive['cand_frac8_rows']} rows "
        f"{frac_ms:.3f} ms (min, median, max {fq})")
    # the counted run: the whole corpus in 16 chunks, kernel A adaptive,
    # kernel D linked back
    common.reset_counts()
    adaptive["round_trip"] = adaptive_round_trip(enc, dec, corpus, cuda)
    counts["adaptive"] = phase_counts("adaptive", ["encode_linked",
                                                   "decode_linked"])
    rt = adaptive["round_trip"]
    log(f"[adaptive] {len(corpus) >> 20} MiB corpus, mm_rows cycling "
        f"{ADAPTIVE_CYCLE}: ratio {rt['ratio']:.6f}, encode_blocks_linked "
        f"{rt['encode_s']:.3f} s, decode_blocks_linked {rt['decode_s']:.3f} "
        f"s, byte-exact")
    stats["encode_linked"]["adaptive"] = adaptive

    # -- 18. fullbench_torch.py on the card ----------------------------------
    common.reset_counts()
    t0 = time.perf_counter()
    if load_script(REPO / "fullbench_torch.py").main(
            ["--mb", str(FULLBENCH_MB)]) != 0:
        raise SmokeFailure("fullbench_torch.py failed")
    fullbench_s = time.perf_counter() - t0
    counts["fullbench"] = phase_counts("fullbench", [
        k for k in KERNELS if k != "sg_encode_chain_batch"])
    log(f"[fullbench] fullbench_torch.py --mb {FULLBENCH_MB}: "
        f"{fullbench_s:.1f} s, every round trip byte-exact")

    # -- 19. the example twins, without --device -----------------------------
    for script in EXAMPLE_TWINS:
        if load_script(REPO / "examples" / "torch_port" / script).main(
                []) != 0:
            raise SmokeFailure(f"examples/torch_port/{script} failed")

    # -- 20. the decompress landing -----------------------------------------
    common.reset_counts()
    landing_record = landing_phase(corpus, cuda)
    counts["landing"] = phase_counts("landing", ["decode_batch",
                                                 "decode_linked",
                                                 "decode_stream"])

    unbound = [k for k in KERNELS if "bound_ms" not in stats[k]]
    if unbound:
        raise SmokeFailure(f"no bound computed for {unbound}")
    report = {"kernels": [
        {"name": k, "route": route, "source": src, "replaces": rep,
         "launches": counts[phase][k], "counted_in": phase,
         "launches_by_phase": {p: c[k] for p, c in counts.items()},
         **stats[k]}
        for k, (route, src, rep, phase) in KERNELS.items()],
        "sg_phase": sg_times, "hc_phase": hc_times,
        "destsize_phase": ds_times, "legacy_phase": legacy_times,
        "envelope_phase": envelope_times, "mesh_phase": mesh_times,
        "api_phase": api_record, "hc_api_phase": hc_api_record,
        "fullbench_s": fullbench_s, "landing_phase": landing_record}
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--encode-times"] and len(sys.argv) == 3:
        sys.exit(encode_times(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--destsize-times"] and len(sys.argv) == 3:
        sys.exit(destsize_times(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--decode-times"] and len(sys.argv) == 3:
        sys.exit(decode_times(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--hc-times"] and len(sys.argv) == 3:
        sys.exit(hc_times(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--xxh-times"] and len(sys.argv) == 3:
        sys.exit(xxh_times(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--parallel-only"] and len(sys.argv) == 2:
        sys.exit(parallel_only())
    if sys.argv[1:2] == ["--landing-only"] and len(sys.argv) == 2:
        sys.exit(landing_only())
    if sys.argv[1:2] == ["--multihost-worker"] and len(sys.argv) == 7:
        sys.exit(multihost_worker(int(sys.argv[2]), int(sys.argv[3]),
                                  *sys.argv[4:7]))
    sys.exit(main())
