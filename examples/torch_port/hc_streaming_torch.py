"""HC compression of chained blocks, with lz4_tpu_torch.

    python examples/torch_port/hc_streaming_torch.py [--device cuda|cpu]

The twin of ``examples/hc_streaming.py`` (the reference's
``HCStreaming_ringBuffer.c``): 16 KB chunks go through an
``HcCompressStream`` at level 9 (kernel I, each chunk behind the stream's
64 KB window, which stays on the device between calls), and a mirrored
``BlockDecompressStream`` (kernel D with the window as its dictionary row)
reads them back.  The default device is the card, and the example raises
without one; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.hc import HcCompressStream, compress_hc_block
from lz4_tpu_torch.kernels.common import resolve_device
from lz4_tpu_torch.stream import BlockDecompressStream
from lz4_tpu_torch.utils.datagen import gen_buffer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    data = gen_buffer(80_000, 0.7, 3)
    chunk = 16384
    enc = HcCompressStream(level=9, device=dev)
    dec = BlockDecompressStream(device=dev)
    out = bytearray()
    total = independent = 0
    for i in range(0, len(data), chunk):
        piece = data[i:i + chunk]
        block = enc.compress_continue(piece)
        total += len(block)
        independent += len(compress_hc_block(piece, 9, device=dev))
        out += dec.decompress_continue(block, len(piece))
    if bytes(out) != data:
        raise RuntimeError("the HC stream does not round-trip")
    print(f"HC streaming on {dev}: {len(data)} -> {total} bytes "
          f"({100 * total / len(data):.1f}%; independent blocks "
          f"{independent}), round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
