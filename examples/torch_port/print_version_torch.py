"""Print the library version (examples/printVersion.c analog).

    python examples/torch_port/print_version_torch.py [--device cuda|cpu]

The twin of ``examples/print_version.py``: ``lz4_tpu_torch.__version__`` and
the wire formats it reads and writes, and the device the library would run
on.  The default device is the card, and the example raises without one.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import lz4_tpu_torch  # noqa: E402
from lz4_tpu_torch.kernels.common import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"lz4_tpu_torch library version {lz4_tpu_torch.__version__} "
          f"(wire-compatible with LZ4 r132 / frame spec v1.5.1), on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
