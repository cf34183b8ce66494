"""lz4-compatible command line interface over the CUDA kernels.

Counterpart of ``lz4_tpu/cli.py`` (parity with the reference CLI,
``programs/lz4cli.c``): levels ``-1..-16``, ``-d/-z/-t/-f/-c/-m/-k``, block
knobs ``-B4..-B7 -BD -BX``, ``--content-size``, ``--[no-]frame-crc``,
``--[no-]sparse``, ``--rm``, ``-b`` benchmark mode (programs/bench.c),
stdin/stdout via ``-``, console-safety refusals (lz4cli.c:493-497), output
name derivation (lz4cli.c:508-540), and the ``lz4cat``/``unlz4`` argv[0]
personalities (lz4cli.c:301-302), and legacy frames (``-l``: 8 MB blocks,
compressed on the card at every level).

Every operation runs on the card.  ``LZ4TPU_FORCE_CPU=1`` asks for the CPU
instead (the kernels' plain versions); without a card and without that
request the CLI exits with a message.

Run as ``python -m lz4_tpu_torch.cli``.
"""

from __future__ import annotations

import os
import sys
import time

from . import __version__, spec
from .io import (
    IoPrefs,
    LZ4_EXTENSION,
    compress_filename,
    compress_multiple,
    decompress_filename,
    decompress_multiple,
)

USAGE = f"""\
*** lz4_tpu_torch v{__version__}, LZ4 CLI on CUDA ***
Usage: python -m lz4_tpu_torch.cli [arg] [input] [output]

input/output  : files or `-` for stdin/stdout
Arguments:
 -1..-2       : fast compression (default: -1)
 -3..-16      : high compression (HC levels)
 -d           : decompression
 -z           : force compression
 -t           : test compressed file integrity
 -f           : overwrite output without prompting
 -c           : force write to stdout
 -m           : compress multiple input files (output: file.lz4)
 -k           : keep source files (default)
 --rm         : remove source files after success
 -l           : use legacy frame format (0x184C2102, 8 MB blocks)
 -B4..-B7     : block size 64KB / 256KB / 1MB / 4MB (default: -B7)
 -BD          : block dependency (improves small-block ratio)
 -BX          : add block checksums
 --content-size   : embed the uncompressed size in the frame header
 --[no-]frame-crc : content checksum (default: enabled)
 --[no-]sparse    : sparse file support on decode (default: enabled)
 --min-match=N    : drop matches shorter than N bytes (N>=4; larger output,
                    faster decode)
 -b#          : benchmark file(s) at level #
 -i#          : iterations for benchmark (default: 3)
 -q / -v      : quieter / more verbose
 -h / -H      : this help
 -V / --version : show version

Runs on the CUDA card; LZ4TPU_FORCE_CPU=1 runs on the CPU instead.
"""


def _die(msg: str, code: int = 1):
    print(f"lz4tt: {msg}", file=sys.stderr)
    sys.exit(code)


def _device() -> str:
    """"cuda", or "cpu" when LZ4TPU_FORCE_CPU=1; exits without a card."""
    if os.environ.get("LZ4TPU_FORCE_CPU", "0") == "1":
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        _die("no CUDA device (torch.cuda.is_available() is False); set "
             "LZ4TPU_FORCE_CPU=1 to run on the CPU")
    return "cuda"


def _derive_output(input_name: str, decompress: bool) -> str:
    """Output-name derivation (lz4cli.c:508-540)."""
    if input_name == "-":
        return "-"
    if decompress:
        if input_name.endswith(LZ4_EXTENSION):
            return input_name[:-len(LZ4_EXTENSION)]
        _die(f"cannot determine output name for {input_name} "
             "(no .lz4 suffix); specify one")
    return input_name + LZ4_EXTENSION


def _timed_rate(fn, nbytes: int, iterations: int, min_seconds: float):
    """Reference bench protocol (programs/bench.c:99-100, 358-408): each
    measurement loops ``fn`` until at least ``min_seconds`` of wall time
    have elapsed, rate = bytes processed / elapsed; best rate over
    ``iterations`` measurements.  ``fn`` must end by fetching a result to
    the host, so the time covers the device work.  Returns
    (best_bytes_per_second, last_result)."""
    best = 0.0
    result = fn()          # warm: kernel builds stay out of the windows
    for _ in range(max(1, iterations)):
        loops = 0
        t0 = time.perf_counter()
        while True:
            result = fn()
            loops += 1
            el = time.perf_counter() - t0
            if el >= min_seconds:
                break
        best = max(best, nbytes * loops / max(el, 1e-9))
    return best, result


def _bench_hc(data: bytes, level: int, iterations: int, min_s: float, dev):
    """HC levels: kernel I over independent 64 KB rows, then kernel D in
    batch mode over the compressed ones.  Returns (rate_c, rate_d, compressed
    size, rebuilt content)."""
    from .device import byte_rows, decode_batch
    from .kernels.common import to_host
    from .kernels.hc_kernel import encode_blocks_hc

    bs = 65536
    blocks = [data[i:i + bs] for i in range(0, len(data), bs)] or [b""]
    rows, lens = byte_rows(blocks, bs, dev)

    def enc_once():
        out, olen = encode_blocks_hc(rows, lens, level)
        return out, to_host(olen)

    rate_c, (out_d, comp_lens) = _timed_rate(enc_once, len(data), iterations,
                                             min_s)
    comp_rows = to_host(out_d)
    comp = [comp_rows[i, :comp_lens[i]].tobytes()
            if comp_lens[i] < len(blocks[i]) else None
            for i in range(len(blocks))]
    comp_size = sum(len(c) if c is not None else len(b)
                    for c, b in zip(comp, blocks))
    todo = [c for c in comp if c is not None]
    rate_d, out = _timed_rate(lambda: decode_batch(todo, bs, device=dev)
                              if todo else [], len(data), iterations, min_s)
    it = iter(out)
    rebuilt = b"".join(next(it) if c is not None else b
                       for c, b in zip(comp, blocks))
    return rate_c, rate_d, comp_size, rebuilt


def _bench_fast(data: bytes, prefs: IoPrefs, iterations: int, min_s: float,
                dev):
    """Fast levels: kernel A over one linked stream of 64 KB blocks, then
    kernel D in linked mode over its payloads.  Returns (rate_c, rate_d,
    compressed size, rebuilt content)."""
    import torch

    from .device import byte_rows, linked_stream
    from .kernels.common import to_host
    from .kernels.decode_kernel import decode_blocks_linked
    from .kernels.encode_kernel import encode_blocks_linked

    bs = 65536
    stream, lens = linked_stream(data, device=dev)
    lens_d = torch.from_numpy(lens).to(dev)
    nb = lens.shape[1]
    mm = max(4, prefs.min_match)

    def enc_once():
        comp, clen = encode_blocks_linked(stream, lens_d, 1, min_match=mm)
        return comp, to_host(clen[0])

    rate_c, (comp_d, clen) = _timed_rate(enc_once, len(data), iterations,
                                         min_s)
    outb = to_host(comp_d[0])
    payloads = [outb[k, :clen[k]].tobytes() for k in range(nb)]
    rows_d, clens_d = byte_rows(payloads, max(map(len, payloads)), dev)

    def dec_once():
        out, dlen = decode_blocks_linked(rows_d, clens_d, bs)
        return out, to_host(dlen)

    rate_d, (out_d, dlen) = _timed_rate(dec_once, len(data), iterations,
                                        min_s)
    outb2 = to_host(out_d)
    rebuilt = b"".join(outb2[k, :dlen[k]].tobytes() for k in range(nb))
    return rate_c, rate_d, int(clen.sum()), rebuilt


def _bench(paths, prefs: IoPrefs, level: int, iterations: int, dev) -> int:
    """-b mode (parity: BMK_benchFiles, programs/bench.c:240-434): >=2 s
    timed windows per measurement, best of N (bench.c:99-100, 358-408), and
    an XXH32 round-trip verification (bench.c:346, 406-407).
    LZ4T_BENCH_SECONDS shortens the window."""
    from .ops.xxhash import xxh32

    min_s = float(os.environ.get("LZ4T_BENCH_SECONDS", "2.0"))
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        if level >= 3:
            rate_c, rate_d, comp_size, rebuilt = _bench_hc(
                data, level, iterations, min_s, dev)
        else:
            rate_c, rate_d, comp_size, rebuilt = _bench_fast(
                data, prefs, iterations, min_s, dev)
        if xxh32(rebuilt) != xxh32(data):
            _die(f"{path}: benchmark round-trip corruption!")
        n = max(1, len(data))
        print(f"{os.path.basename(path):<20}:{len(data):>9} ->"
              f"{comp_size:>9} ({100.0 * comp_size / n:6.2f}%),"
              f"{rate_c / 1e6:8.1f} MB/s,"
              f"{rate_d / 1e6:8.1f} MB/s")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0]) if argv else "lz4tt"
    args = argv[1:]

    prefs = IoPrefs()
    decompress = False
    force_stdout = False
    multiple = False
    bench_mode = False
    level = 1
    iterations = 3
    files: list[str] = []

    # argv[0] personalities (lz4cli.c:301-302)
    if "lz4cat" in prog:
        decompress = True
        force_stdout = True
        prefs.overwrite = True
    elif "unlz4" in prog:
        decompress = True

    i = 0
    while i < len(args):
        a = args[i]
        i += 1
        if a == "--":
            files += args[i:]
            break
        if a in ("-h", "-H", "--help"):
            print(USAGE)
            return 0
        if a in ("-V", "--version"):
            print(f"lz4_tpu_torch v{__version__} (LZ4 frame spec v1.5.1)")
            return 0
        if a == "--content-size":
            prefs.content_size = True
            continue
        if a == "--frame-crc":
            prefs.content_checksum = True
            continue
        if a == "--no-frame-crc":
            prefs.content_checksum = False
            continue
        if a == "--sparse":
            prefs.sparse = True
            continue
        if a == "--no-sparse":
            prefs.sparse = False
            continue
        if a.startswith("--min-match"):
            try:
                prefs.min_match = max(4, int(a.split("=", 1)[1]))
            except (IndexError, ValueError):
                _die("--min-match=N expects an integer >= 4")
            continue
        if a == "--rm":
            prefs.remove_src = True
            continue
        if a == "--keep":
            prefs.remove_src = False
            continue
        if a == "-":
            files.append("-")
            continue
        if a.startswith("--"):
            _die(f"unknown option {a}")
        if a.startswith("-") and len(a) > 1:
            j = 1
            while j < len(a):
                c = a[j]
                if c.isdigit():
                    # compression level, possibly multi-digit
                    k = j
                    while k < len(a) and a[k].isdigit():
                        k += 1
                    level = min(int(a[j:k]), 16)
                    prefs.level = level
                    j = k
                    continue
                if c == "z":
                    decompress = False
                elif c == "d":
                    decompress = True
                elif c == "t":
                    prefs.test_mode = True
                    decompress = True
                elif c == "f":
                    prefs.overwrite = True
                elif c == "c":
                    force_stdout = True
                    prefs.overwrite = True
                elif c == "m":
                    multiple = True
                elif c == "k":
                    prefs.remove_src = False
                elif c == "l":
                    prefs.legacy = True
                elif c == "q":
                    prefs.verbosity = max(0, prefs.verbosity - 1)
                elif c == "v":
                    prefs.verbosity += 1
                elif c == "b":
                    bench_mode = True
                    if j + 1 < len(a) and a[j + 1].isdigit():
                        k = j + 1
                        while k < len(a) and a[k].isdigit():
                            k += 1
                        level = int(a[j + 1:k])
                        prefs.level = level
                        j = k - 1
                elif c == "i":
                    if j + 1 < len(a) and a[j + 1].isdigit():
                        iterations = int(a[j + 1])
                        j += 1
                elif c == "B":
                    if j + 1 < len(a) and a[j + 1] in "4567":
                        prefs.block_size_id = int(a[j + 1])
                        j += 1
                    elif j + 1 < len(a) and a[j + 1] == "D":
                        prefs.block_linked = True
                        j += 1
                    elif j + 1 < len(a) and a[j + 1] == "X":
                        prefs.block_checksum = True
                        j += 1
                    else:
                        _die("-B expects 4..7, D or X")
                else:
                    _die(f"unknown option -{c}")
                j += 1
            continue
        files.append(a)

    if bench_mode:
        if not files:
            _die("benchmark mode needs at least one file")
        return _bench(files, prefs, level, iterations, _device())

    if not files:
        if sys.stdin.isatty():
            print(USAGE)
            return 0
        files = ["-"]

    dev = _device()
    if multiple:
        if decompress:
            return decompress_multiple(files, prefs, dev)
        return compress_multiple(files, prefs, dev)

    src = files[0]
    dst = files[1] if len(files) > 1 else None
    if dst is None:
        if force_stdout or src == "-":
            dst = "-"
        else:
            dst = _derive_output(src, decompress)

    # console-safety refusals (lz4cli.c:493-497, 543-547)
    if dst == "-" and sys.stdout.isatty() and not decompress \
            and not prefs.test_mode and not force_stdout:
        _die("refusing to write compressed data to a terminal; use -c or -f")

    # pass-through: forced decompression of non-LZ4 input copies it verbatim
    # (reference lz4io.c:946-952 gated on g_overwrite; lz4cat sets it too)
    prefs.pass_through = decompress and prefs.overwrite

    try:
        if decompress:
            r, w = decompress_filename(src, dst, prefs, dev)
            if prefs.test_mode and prefs.verbosity >= 2:
                print(f"{src:<30}: decoded {w} bytes OK", file=sys.stderr)
            elif prefs.verbosity >= 2 and dst != "-":
                print(f"{src:<30}: decoded {w} bytes", file=sys.stderr)
        else:
            r, w = compress_filename(src, dst, prefs, dev)
            if prefs.verbosity >= 2 and dst != "-":
                pct = 100.0 * w / max(1, r)
                print(f"Compressed {r} bytes into {w} bytes ==> {pct:.2f}%",
                      file=sys.stderr)
    except Exception as e:
        _die(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
