"""Ring-buffer streaming, with lz4_tpu_torch.

    python examples/torch_port/block_streaming_ring_buffer_torch.py [--device cuda|cpu]

The twin of ``examples/block_streaming_ring_buffer.py``: messages of up to
1 KB flow through an 8 KB ring that wraps around; a ``BlockCompressStream``
and a ``BlockDecompressStream`` stay in step, each holding its own copy of
the last 64 KB on the device, so the ring's reuse of its bytes does not
matter.  The default device is the card, and the example raises without
one; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.kernels.common import resolve_device
from lz4_tpu_torch.stream import BlockCompressStream, BlockDecompressStream
from lz4_tpu_torch.utils.datagen import gen_buffer

RING_SIZE = 8192
MSG_MAX = 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    data = gen_buffer(60_000, 0.7, 2)
    ring = bytearray(RING_SIZE)
    enc = BlockCompressStream(device=dev)
    dec = BlockDecompressStream(device=dev)
    wire, out = io.BytesIO(), bytearray()
    pos = off = 0
    while off < len(data):
        n = min(MSG_MAX, len(data) - off)
        if pos + n > RING_SIZE:
            pos = 0                       # wrap
        ring[pos:pos + n] = data[off:off + n]
        block = enc.compress_continue(bytes(ring[pos:pos + n]))
        wire.write(len(block).to_bytes(2, "little") + block)
        out += dec.decompress_continue(block, n)
        pos += n
        off += n
    if bytes(out) != data:
        raise RuntimeError("the ring stream does not round-trip")
    print(f"ring-buffer on {dev}: {len(data)} -> {wire.tell()} bytes, "
          "round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
