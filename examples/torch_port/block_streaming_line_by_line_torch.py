"""Line-granularity streaming, with lz4_tpu_torch.

    python examples/torch_port/block_streaming_line_by_line_torch.py [--device cuda|cpu]

The twin of ``examples/block_streaming_line_by_line.py``: one block per
text line, [LE16 block length | block] on the wire, the 64 KB window
carried across lines (on the device) so that repeated words match into
earlier lines; lines compressed one by one without it are compared.  The
default device is the card, and the example raises without one;
``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import struct
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.block import compress_default
from lz4_tpu_torch.kernels.common import resolve_device
from lz4_tpu_torch.stream import BlockCompressStream, BlockDecompressStream


def compress_lines(lines, dev) -> bytes:
    enc = BlockCompressStream(device=dev)
    out = bytearray()
    for ln in lines:
        blk = enc.compress_continue(ln)
        out += struct.pack("<H", len(blk)) + blk
    return bytes(out)


def decompress_lines(blob, dev):
    dec = BlockDecompressStream(device=dev)
    pos, lines = 0, []
    while pos < len(blob):
        (n,) = struct.unpack_from("<H", blob, pos)
        lines.append(dec.decompress_continue(blob[pos + 2:pos + 2 + n],
                                             1 << 16))
        pos += 2 + n
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    lines = [(f"2026-08-17T12:{i % 60:02d}:{(7 * i) % 60:02d} host-{i % 8} "
              f"lz4_tpu[worker]: request {i} served in {i % 97} ms "
              f"status=OK route=/api/v1/blocks\n").encode()
             for i in range(200)]
    blob = compress_lines(lines, dev)
    if decompress_lines(blob, dev) != lines:
        raise RuntimeError("the line stream does not round-trip")
    indep = sum(len(compress_default(ln, device=dev)) + 2 for ln in lines)
    print(f"{len(lines)} lines on {dev}, {sum(map(len, lines))} B raw -> "
          f"{len(blob)} B streamed (vs {indep} B line-independent); window "
          f"carry wins {indep / len(blob):.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
