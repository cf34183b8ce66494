#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lz4_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

1. Checks for a card and prints its name and power limit.
2. Builds the kernels from lz4_tpu_torch/csrc (nvcc, sm_90a).
3. Holds every kernel against its plain PyTorch/Python version on the same
   inputs, byte for byte (tolerance 0: a codec's outputs are integers), at
   the main path's shapes, and times both.  Kernel E (the stream decoder)
   is held against its plain version at every launch step 6 makes (the
   whole -B7, -B5 linked, legacy and flushed files) and on small inputs (a
   4 MB block, stored blocks, a flushed chain with short mid-stream blocks,
   corrupted payloads, noise) in both modes, and timed on a 4 MB block in
   three alternating rounds of the two modes and on the 64 MiB -B7 frame.
   Kernels G (the SG chain encoder) and F (the SG chain decoder) are held
   against their plain versions on small lists (4 KB, 64 KB and ragged
   iovecs, min_match 8, acceleration 2, small caps that force capacity
   stops and zero-pads, mixed bytes; corrupted payloads and noise as SG
   chains) and at every launch step 7 makes, and timed on the '4k' walk
   and its chain in three rounds each.
4. Runs the main path at full size: a 64 MiB real-text corpus (the Python
   stdlib sources, built the way bench.py builds its corpus) through
   compress_frame_device and decompress_frame_device, at min_match=8 /
   reject_step=1 (the bench point), at the default min_match=4, and at
   mm=8 with a content checksum (the lz4 CLI's default frame).  The launch
   counters are reset just before and read just after: kernels A, C and
   linked D must have launched and no plain version may have run.
5. Resets the counters again and runs the smaller entry points: a 4 MB
   one-shot linked frame, a 60 KB input (kernel B), and independent frames
   with and without block and content checksums.  Kernels A to D, B and
   batch D included, must launch here, and no plain version may run.
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
8. Decodes a 1 MB frame written by the kernels with the plain versions.

Prints a JSON line of the kernels (each with the launch count of the phase
that drives it, every phase's counts, its time on the card, its plain
version's, and its bound: the bytes the timed call must read and write at
3.35 TB/s), then, as its last line, {"ok": true, "device": {...}}.  Exits non-zero on any failure, and when no
card is present.  Writes nothing outside build/ (the kernel library and
the temporary directory of step 6).
"""

import json
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
# step 6, "sg" = step 7)
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


# -- building 4 MB and 8 MB blocks from independent 256 KB payloads ----------
# Kernel B encodes rows of at most 256 KB, and the card host has no LZ4
# compressor that writes larger blocks.  An independent block's offsets
# never leave the block, so consecutive independent payloads become one
# block when each payload's terminal literal-only sequence is folded into
# the first sequence of the next: the new token takes the sum of both
# literal runs, with the second token's match nibble, offset and extension.
# Only the merged block's end keeps the end-of-block rules, as it must.

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


def _ext(payload: bytes, ip: int, run: int):
    """Add a length extension at ``ip`` to ``run``: (run, next ip)."""
    while True:
        b = payload[ip]
        ip += 1
        run += b
        if b != 255:
            return run, ip


def literal_head(n: int, match_nibble: int = 0) -> bytes:
    """Token and literal-length extension of a sequence with ``n``
    literals."""
    head = bytearray([min(n, 15) << 4 | match_nibble])
    if n >= 15:
        rest = n - 15
        head += b"\xff" * (rest // 255) + bytes([rest % 255])
    return bytes(head)


def terminal_literals(payload: bytes) -> int:
    """Offset of the token of a block's last (literal-only) sequence."""
    ip, n = 0, len(payload)
    while True:
        at = ip
        token = payload[ip]
        run, ip = token >> 4, ip + 1
        if run == 15:
            run, ip = _ext(payload, ip, run)
        ip += run
        if ip >= n:
            return at
        ip += 2
        if token & 15 == 15:
            _, ip = _ext(payload, ip, 0)


def merge_payloads(payloads) -> bytes:
    """One LZ4 block decoding to the concatenation of the contents of
    independent blocks ``payloads`` (compressed, in order)."""
    out = bytearray()
    carry = b""                 # literals of the previous terminal sequence
    for p in payloads:
        token = p[0]
        run, ip = token >> 4, 1
        if run == 15:
            run, ip = _ext(p, ip, run)
        lits = carry + p[ip:ip + run]
        if ip + run == len(p):                  # one literal-only sequence
            carry = lits
            continue
        t = terminal_literals(p)
        out += literal_head(len(lits), token & 15) + lits + p[ip + run:t]
        run, ip = p[t] >> 4, t + 1
        if run == 15:
            run, ip = _ext(p, ip, run)
        carry = p[ip:ip + run]
    out += literal_head(len(carry)) + carry
    return bytes(out)


def merged_blocks(records, group: int):
    """Merge every ``group`` consecutive 256 KB records (payload, stored)
    into one block; a stored record takes part as a literal-only block."""
    payloads = [literal_head(len(p)) + p if st else p for p, st in records]
    return [merge_payloads(payloads[i:i + group])
            for i in range(0, len(payloads), group)]


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
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import spec
    from lz4_tpu_torch.frame import FramePreferences, encode_frame_header
    from lz4_tpu_torch.ops.xxhash import xxh32

    b5 = D.compress_frame_device(
        corpus, FramePreferences(block_size_id=5, block_independent=True),
        block_size=256 << 10, device=dev)
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
            scripted = sg._sg_device_scripted(ins, caps, None, None, 1, dev)
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
    from lz4_tpu_torch.kernels.pack_kernel import pack_frame_payloads

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi: {smi.stderr.strip()}")
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

    t0 = time.perf_counter()
    corpus = real_text_corpus(CORPUS_BYTES)
    log(f"[corpus] {len(corpus)} bytes of stdlib text in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 3a. kernel A: 8 blocks + a partial, mm 4/8, prefix 0/64 KB ---------
    def linked_case(data, prefix, mm, rs=1, zero=False, acc=1):
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
        delta, jump = enc.linked_tables(
            host.to(cuda), nb, mm, pre.to(cuda) if zero else None)
        args_card = (host.to(cuda), lens.to(cuda), pre.to(cuda), delta,
                     jump, acc, mm, rs)
        args_cpu = (host, lens, pre, delta.cpu(), jump.cpu(), acc, mm, rs)
        return args_card, args_cpu

    small = corpus[3 * W:3 * W + 8 * W + 20_011]
    for mm in (4, 8):
        for prefix in (b"", corpus[2 * W:3 * W]):
            card, cpu = linked_case(small, prefix, mm)
            k = enc.scan_linked(*card)
            p = enc.scan_linked(*cpu)
            cmp_rows("encode_linked", f"9 blocks mm={mm} prefix="
                     f"{len(prefix)}", *k, *p)

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

    # -- 3b. kernel C on kernel A's output ----------------------------------
    blocks_d = stream_d[0, W:65 * W].view(64, W)
    lens64 = torch.full((64,), W, dtype=torch.int32)
    stats["pack"]["ms"] = time_card(lambda: pack_frame_payloads(
        a_out.reshape(64, -1), a_olen.reshape(64), blocks_d, lens64.to(cuda)))
    k_flat, k_total, k_stored = pack_frame_payloads(
        a_out.reshape(64, -1), a_olen.reshape(64), blocks_d, lens64.to(cuda))
    (p_flat, p_total, p_stored), stats["pack"]["plain_ms"] = time_host(
        lambda: pack_frame_payloads(a_out.reshape(64, -1).cpu(),
                                    a_olen.reshape(64).cpu(),
                                    blocks_d.cpu(), lens64))
    set_bound("pack", int(a_olen.sum()) + 2 * 4 * 64, int(k_total))
    # a stored block and a padding row, too
    olen_mix = a_olen.reshape(64).clone()
    olen_mix[3] = W + 5
    lens_mix = lens64.clone()
    lens_mix[63] = 0
    k2 = pack_frame_payloads(a_out.reshape(64, -1), olen_mix, blocks_d,
                             lens_mix.to(cuda))
    p2 = pack_frame_payloads(a_out.reshape(64, -1).cpu(), olen_mix.cpu(),
                             blocks_d.cpu(), lens_mix)
    for what, (kf, kt, ks), (pf, pt, ps) in (
            ("64 blocks (main-path chunk)", (k_flat, k_total, k_stored),
             (p_flat, p_total, p_stored)),
            ("stored block + padding row", k2, p2)):
        if int(kt) != int(pt) or not torch.equal(ks.cpu(), ps):
            raise SmokeFailure(f"pack totals or stored flags differ ({what})")
        cmp_rows("pack", what, kf[:int(kt)].reshape(1, -1), kt.reshape(1),
                 pf[:int(pt)].reshape(1, -1), pt.reshape(1))

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

    # -- 3d. kernel B, then kernel D batch mode on its output -----------------
    rows_h = torch.frombuffer(bytearray(corpus[:64 * W]),
                              dtype=torch.uint8).reshape(64, W).clone()
    blens = torch.full((64,), W, dtype=torch.int32)
    blens[5], blens[6], blens[7] = 60_000, 13, 0
    rows_h[5, 60_000:] = 0
    rows_h[6, 13:] = 0
    rows_h[7] = 0
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
        cmp_rows("encode", f"64 rows of <= 64 KB mm={mm}", *k, *p)
    b_out, b_olen = k
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
    # every launch the stream phase makes (step 6), on the whole file
    launches = stream_launches(files)
    plain_full = {}
    for fname, (what, flat, st, cl, sd, bs, linked, caps) in \
            launches.items():
        flat_h = torch.frombuffer(bytearray(flat), dtype=torch.uint8)
        args = (st, cl, sd, bs, 0, linked, caps)
        k = dec.decode_stream_raw(flat_h.to(cuda), *args)
        p, plain_full[fname] = time_host(
            lambda: dec.decode_stream_raw(flat_h, *args))
        cmp_stream(f"{what} (the stream phase's launch)", k, p)
        del k, p
    s7, n7, d7 = _records(files["b7"], 7)
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
    t16 = time_card(lambda: dec.decode_stream_raw(
        b7_d, s7, n7, d7, MB4, 0, linked=False))
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

    mixed_sg = mixed_bytes(600_000, corpus[:1 << 20], 77)
    for what, ins, caps, acc, mm in sg_chain_cases(corpus, mixed_sg):
        card, cpu = chain_args(ins, caps, acc, mm)
        cmp_chain(what, dsk.sg_encode_chain(*card), dsk.sg_encode_chain(*cpu))
        if (acc, mm) == (1, 4):         # the frames sg_compress writes
            kf, pf = sg_decode_args(*sg_chain_of(ins, caps))
            cmp_sg(what, dec.decode_blocks_sg_raw(*kf),
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
    counts["entry"] = phase_counts(
        "entry points",
        [k for k, v in KERNELS.items() if v[3] in ("main", "entry")])

    # -- 6. the stream path at full size -------------------------------------
    common.reset_counts()
    stream_phase(files, corpus, cuda, REPO / "tests" / "fixtures",
                 REPO / "build")
    counts["stream"] = phase_counts("stream path",
                                    ["decode_stream", "decode_linked"])
    del files

    # -- 7. the scatter-gather path at full size ----------------------------
    common.reset_counts()
    sg_times = {}
    sg_phase(layouts, cuda, sg_times)
    counts["sg"] = phase_counts("sg path", ["sg_encode_chain", "decode_sg",
                                            "decode_stream"])
    del layouts

    # -- 8. the plain decoder reads a frame the kernels wrote -----------------
    data = corpus[8 << 20:9 << 20]
    frame = D.compress_frame_device(data, FramePreferences(block_size_id=4),
                                    min_match=8)
    if D.decompress_frame_device(frame, device="cpu") != (data, len(frame)):
        raise SmokeFailure("plain decoder disagrees on a kernel-written frame")
    log("[check] plain decoder reads a 1 MB frame written by the kernels")

    unbound = [k for k in KERNELS if "bound_ms" not in stats[k]]
    if unbound:
        raise SmokeFailure(f"no bound computed for {unbound}")
    report = {"kernels": [
        {"name": k, "route": route, "source": src, "replaces": rep,
         "launches": counts[phase][k], "counted_in": phase,
         "launches_by_phase": {p: c[k] for p, c in counts.items()},
         **stats[k]}
        for k, (route, src, rep, phase) in KERNELS.items()],
        "sg_phase": sg_times}
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
