"""Resumable destSize decoding on the device, with lz4_tpu_torch.

    python examples/torch_port/dest_size_resume_torch.py [--device cuda|cpu]

The twin of part 3 of ``examples/dest_size_resume.py``, carried to the end:
one LZ4 block is decoded in 16 KB pieces by ``decode_blocks_dest_size``.  Every
round stops at a token boundary when its 16 KB are full and reports the
bytes it produced and the source bytes it consumed; the next round is fed
``comp[cons:]`` with the last 64 KB produced so far as its dictionary row,
until the source is used up.  The pieces joined are the input.

The default device is the card, and the example raises without one;
``--device cpu`` runs the kernels' plain versions.  (It lives in a folder of
its own because every script directly under ``examples/`` must run clean on
a host without a card.)
"""
import argparse
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from lz4_tpu_torch.block import compress_batch
from lz4_tpu_torch.device import byte_rows
from lz4_tpu_torch.kernels.common import resolve_device, to_host
from lz4_tpu_torch.kernels.decode_kernel import decode_blocks_dest_size

PIECE = 16384
WINDOW = 65536


def sample_data(n: int, seed: int) -> bytes:
    """Compressible bytes from a seed: words of a small vocabulary with
    some noise between them."""
    rng = random.Random(seed)
    words = [bytes(rng.randrange(97, 123) for _ in range(rng.randint(2, 9)))
             for _ in range(300)]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words) + b" "
        if rng.random() < 0.05:
            out += rng.randbytes(rng.randint(1, 12))
    return bytes(out[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = sample_data(200_000, 12345)
    comp, = compress_batch([data], block_size=256 << 10, device=dev)
    print(f"block: {len(data)} -> {len(comp)} bytes, on {dev}")

    caps = torch.tensor([PIECE], dtype=torch.int32, device=dev)
    pos, produced, pieces = 0, b"", []
    while pos < len(comp):
        rows, lens = byte_rows([comp[pos:]], len(comp) - pos, dev)
        window = produced[-WINDOW:]
        dict_rows, dict_lens = byte_rows([window], max(len(window), 1), dev)
        out, olen, cons = decode_blocks_dest_size(
            rows, lens, caps, PIECE, dict_rows=dict_rows, dict_lens=dict_lens)
        olen, cons = int(olen[0]), int(cons[0])
        if olen < 0 or cons <= 0:
            raise RuntimeError(f"decode stopped at source byte {pos} "
                               f"(olen {olen}, cons {cons})")
        pieces.append(to_host(out[0, :olen]).tobytes())
        produced += pieces[-1]
        pos += cons
    if produced != data:
        raise RuntimeError("the joined pieces differ from the input")
    print(f"device destSize decode: {len(pieces)} pieces of at most {PIECE} "
          f"bytes, sizes {[len(p) for p in pieces[:4]]}..., each resumed "
          "with the produced bytes as its dictionary: equal to the input")
    return 0


if __name__ == "__main__":
    sys.exit(main())
