"""Scatter-gather compression on the card: a list of 4 KB buffers into
one LZ4F frame spread over output buffers, and back.

    python examples/torch_port/scatter_gather_torch.py [--device cuda|cpu]

The twin of ``examples/scatter_gather.py``: ``sg.sg_compress`` of 16 x 4 KB
into 17 buffers of 4,224 bytes (kernel G walks the whole list in one
launch), ``sg.sg_decompress`` back into the mirrored list (kernel F), and
the joined output buffers decoded as one ordinary LZ4F frame.  The default
device is the card, and the example raises without one; ``--device cpu``
runs the kernels' plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.frame import decompress_frame  # noqa: E402
from lz4_tpu_torch.kernels.common import resolve_device  # noqa: E402
from lz4_tpu_torch.sg import (sg_compress, sg_compress_bound,  # noqa: E402
                              sg_decompress)
from lz4_tpu_torch.utils.datagen import gen_buffer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    data = gen_buffer(65536, 0.7, 5)
    ins = [data[i:i + 4096] for i in range(0, len(data), 4096)]
    caps = [4096 + 128] * 17

    total, consumed, outs = sg_compress(ins, caps, device=dev)
    if consumed != len(data):
        raise RuntimeError(f"consumed {consumed} of {len(data)} bytes")
    print(f"SG on {dev}: {len(ins)}x4KB -> {total} bytes "
          f"(bound {sg_compress_bound(len(data), len(ins), len(caps))})")

    # 1) mirrored scatter-gather decode
    comp_bufs, rem = [], total
    for b, c in zip(outs, caps):
        if rem <= 0:
            break
        comp_bufs.append(b[:min(c, rem)])
        rem -= min(c, rem)
    _, decoded = sg_decompress(comp_bufs, [len(b) for b in ins], device=dev)
    if b"".join(decoded) != data:
        raise RuntimeError("the SG decode differs from the input")

    # 2) the same bytes are one ordinary LZ4F frame
    out, _ = decompress_frame(b"".join(comp_bufs), device=dev)
    if out != data:
        raise RuntimeError("the frame decode differs from the input")
    print("SG round-trip + plain-LZ4F decode OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
