"""In-memory block compression round trip, with lz4_tpu_torch.

    python examples/torch_port/simple_buffer_torch.py [--device cuda|cpu]

The twin of ``examples/simple_buffer.py``: one buffer through
``block.compress_default`` (kernel B on a row of one) and
``block.decompress_safe`` (kernel D, the row sized by a walk over the
block's lengths).  The default device is the card, and the example raises
without one; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.block import compress_default, decompress_safe
from lz4_tpu_torch.kernels.common import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    src = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit. "
           * 40)
    comp = compress_default(src, device=dev)
    if decompress_safe(comp, len(src), device=dev) != src:
        raise RuntimeError("the round trip differs from the input")
    print(f"compressed {len(src)} -> {len(comp)} bytes "
          f"({100 * len(comp) / len(src):.1f}%) on {dev}, round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
