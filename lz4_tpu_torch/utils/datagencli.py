"""datagen CLI: seeded synthetic compressible data to stdout.

Counterpart of ``lz4_tpu/utils/datagencli.py``: ``python -m
lz4_tpu_torch.utils.datagencli -g1M -s3 -P70 > data.bin``.

Parity with the reference generator CLI (reference
``programs/datagencli.c``): ``-g<size>`` total bytes (K/M/G suffixes),
``-s<seed>``, ``-P<proba%>`` match probability.
"""

from __future__ import annotations

import sys

from .datagen import gen_buffer_np


def _parse_size(s: str) -> int:
    mult = 1
    if s and s[-1] in "kK":
        mult, s = 1 << 10, s[:-1]
    elif s and s[-1] in "mM":
        mult, s = 1 << 20, s[:-1]
    elif s and s[-1] in "gG":
        mult, s = 1 << 30, s[:-1]
    return int(s) * mult


def main(argv=None) -> int:
    args = (sys.argv if argv is None else argv)[1:]
    size = 65536
    seed = 0
    proba = 70
    for a in args:
        if a in ("-h", "--help"):
            print("usage: datagen [-g<size>] [-s<seed>] [-P<proba%>]")
            return 0
        if a.startswith("-g"):
            size = _parse_size(a[2:])
        elif a.startswith("-s"):
            seed = int(a[2:])
        elif a.startswith("-P"):
            proba = int(a[2:])
        else:
            print(f"datagen: unknown argument {a}", file=sys.stderr)
            return 1
    sys.stdout.buffer.write(gen_buffer_np(size, proba / 100.0, seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
