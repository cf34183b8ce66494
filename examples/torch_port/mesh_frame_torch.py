"""One linked LZ4F frame, compressed data-parallel over a mesh of cards.

    python examples/torch_port/mesh_frame_torch.py [--device cuda|cpu]

The twin of ``examples/mesh_frame.py``: ``compress_frame_mesh`` shards one
stream's 64 KB blocks over the mesh (every visible card), each shard's
first block behind the 64 KB of input before it, so the frame is the
single stream's, byte for byte, with no traffic between cards; the frame
decoder ``frame.decompress_frame`` reads it back.  The default device is
the card, and the example raises without one; ``--device cpu`` runs on a
mesh of one CPU position, through the kernels' plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.frame import decompress_frame  # noqa: E402
from lz4_tpu_torch.kernels.common import resolve_device  # noqa: E402
from lz4_tpu_torch.parallel.mesh import compress_frame_mesh, default_mesh  # noqa: E402
from lz4_tpu_torch.utils.datagen import gen_buffer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    mesh = default_mesh(device=dev)
    data = b"".join(gen_buffer(50_000, 0.7, seed=i) for i in range(12))
    frame = compress_frame_mesh(mesh, data)
    out, used = decompress_frame(frame, device=dev)
    if out != data or used != len(frame):
        raise RuntimeError("the frame does not decode to its input")
    print(f"{len(data)} bytes -> {len(frame)} bytes "
          f"({len(frame) / len(data):.1%}) as ONE linked frame across "
          f"{mesh.size} position(s) on {dev}; the frame decoder verified "
          f"the bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
