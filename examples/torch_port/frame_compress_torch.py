"""LZ4F frame file round trip, with lz4_tpu_torch.

    python examples/torch_port/frame_compress_torch.py [--device cuda|cpu]

The twin of ``examples/frame_compress.py``: a file compressed by
``frame.compress_frame`` (64 KB linked blocks: kernel A, each block behind
the 64 KB before it) with a content checksum and content size, written,
read back, and decoded by ``frame.decompress_frame`` (kernel D's linked
mode, each block behind the one before).  The default device is the card, and the example
raises without one; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.frame import (FramePreferences, compress_frame,
                                 decompress_frame)
from lz4_tpu_torch.kernels.common import resolve_device
from lz4_tpu_torch.utils.datagen import gen_buffer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    data = gen_buffer(200_000, 0.7, 4)
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "file.bin"
        src.write_bytes(data)
        prefs = FramePreferences(block_size_id=4, content_checksum=True,
                                 content_size=len(data))
        frame = compress_frame(src.read_bytes(), prefs, device=dev)
        dst = Path(td) / "file.bin.lz4"
        dst.write_bytes(frame)
        out, used = decompress_frame(dst.read_bytes(), device=dev)
    if out != data or used != len(frame):
        raise RuntimeError("the frame does not round-trip")
    print(f"frame on {dev}: {len(data)} -> {len(frame)} bytes, "
          "round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
