"""Batch-compress blocks on the card, sharded over a mesh of cards.

    python examples/torch_port/tpu_batch_torch.py [--device cuda|cpu]

The twin of ``examples/tpu_batch.py``: ``parallel.mesh.default_mesh``
(every visible card), ``shard_rows`` and one ``roundtrip_step`` (kernel B,
then kernel D's batch mode, on each card's rows) over uint8 rows of 4 KB;
no row may come back different.  The default device is the card, and the
example raises without one; ``--device cpu`` runs on a mesh of one CPU
position, through the kernels' plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from lz4_tpu_torch.kernels.common import resolve_device  # noqa: E402
from lz4_tpu_torch.parallel.mesh import (default_mesh, roundtrip_step,  # noqa: E402
                                         shard_rows)
from lz4_tpu_torch.utils.datagen import gen_buffer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    mesh = default_mesh(device=dev)
    block_bytes = 4096
    B = mesh.size * 4
    rows = torch.zeros((B, block_bytes), dtype=torch.uint8)
    for i in range(B):
        rows[i] = torch.frombuffer(bytearray(gen_buffer(block_bytes, 0.7, i)),
                                   dtype=torch.uint8)
    lens = torch.full((B,), block_bytes, dtype=torch.int32)
    clens, _, bad = roundtrip_step(mesh, shard_rows(mesh, rows),
                                   shard_rows(mesh, lens), block_bytes)
    if bad != 0:
        raise RuntimeError(f"{bad} rows did not round-trip")
    total_comp = sum(int(c.sum()) for c in clens)
    print(f"{mesh.size}-position mesh on {dev}: {B} blocks, "
          f"{int(lens.sum())} -> {total_comp} bytes, all round-tripped "
          f"(mismatches {bad})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
