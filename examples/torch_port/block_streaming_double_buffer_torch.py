"""Double-buffer streaming, with lz4_tpu_torch.

    python examples/torch_port/block_streaming_double_buffer_torch.py [--device cuda|cpu]

The twin of ``examples/block_streaming_double_buffer.py``: two alternating
64 KB input slots feed a chained ``BlockCompressStream`` (kernel A behind
the 64 KB window, which stays on the device between calls), written as
[LE32 size | block] records, and a mirrored ``BlockDecompressStream``
(kernel D with the window as its dictionary row) reads them back.  The
default device is the card, and the example raises without one;
``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.kernels.common import resolve_device
from lz4_tpu_torch.stream import BlockCompressStream, BlockDecompressStream
from lz4_tpu_torch.utils.datagen import gen_buffer

SLOT = 65536


def compress_file(src, dst, dev) -> None:
    slots = [bytearray(SLOT), bytearray(SLOT)]
    enc = BlockCompressStream(device=dev)
    i = 0
    while True:
        chunk = src.read(SLOT)
        if not chunk:
            break
        slots[i % 2][:len(chunk)] = chunk          # reuse alternating slots
        block = enc.compress_continue(bytes(slots[i % 2][:len(chunk)]))
        dst.write(len(block).to_bytes(4, "little") + block)
        i += 1
    dst.write((0).to_bytes(4, "little"))


def decompress_file(src, dst, dev) -> None:
    dec = BlockDecompressStream(device=dev)
    while True:
        size = int.from_bytes(src.read(4), "little")
        if size == 0:
            break
        dst.write(dec.decompress_continue(src.read(size), SLOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    data = gen_buffer(300_000, 0.7, 1)
    comp, out = io.BytesIO(), io.BytesIO()
    compress_file(io.BytesIO(data), comp, dev)
    comp.seek(0)
    decompress_file(comp, out, dev)
    if out.getvalue() != data:
        raise RuntimeError("the round trip differs from the input")
    print(f"double-buffer on {dev}: {len(data)} -> {comp.tell()} bytes, "
          "round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
