"""Tour of the compression entry points, with lz4_tpu_torch.

    python examples/torch_port/compress_functions_torch.py [--device cuda|cpu]

The twin of ``examples/compress_functions.py``: every compression entry
point of ``lz4_tpu_torch.block`` on one buffer (kernel B for
``compress_default`` and ``compress_fast``, kernel H for
``compress_dest_size``), each round-tripped through ``decompress_safe``
(kernel D), and ``hc.compress_hc_block`` at level 9 (kernel I).  The
default device is the card, and the example raises without one;
``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.block import (compress_default, compress_dest_size,
                                 compress_fast, decompress_safe,
                                 decompress_safe_partial)
from lz4_tpu_torch.hc import compress_hc_block
from lz4_tpu_torch.kernels.common import resolve_device


def run(name, fn, src):
    t0 = time.perf_counter()
    out = fn(src)
    dt = time.perf_counter() - t0
    print(f"  {name:28s} {len(src):6d} -> {len(out):6d} bytes  "
          f"({1e3 * dt:6.2f} ms)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    src = (b"Far out in the uncharted backwaters of the unfashionable "
           b"end of the western spiral arm of the Galaxy lies a small "
           b"unregarded yellow sun. " * 150)

    print(f"compression entry points on {dev}:")
    c_def = run("compress_default", lambda s: compress_default(
        s, device=dev), src)
    c_fast = run("compress_fast(accel=4)", lambda s: compress_fast(
        s, acceleration=4, device=dev), src)
    budget = max(64, len(c_def) // 2)
    c_ds, consumed = compress_dest_size(src, budget, device=dev)
    print(f"  {'compress_dest_size':28s} consumed {consumed} of "
          f"{len(src)} src bytes into {len(c_ds)} (budget {budget})")
    c_hc = run("compress_hc_block(level=9)", lambda s: compress_hc_block(
        s, level=9, device=dev), src)

    checks = (decompress_safe(c_def, len(src), device=dev) == src,
              decompress_safe(c_fast, len(src), device=dev) == src,
              decompress_safe(c_ds, consumed, device=dev) == src[:consumed],
              decompress_safe(c_hc, len(src), device=dev) == src,
              decompress_safe_partial(c_def, 100, device=dev) == src[:100])
    if not all(checks):
        raise RuntimeError(f"a round trip differs: {checks}")
    print("decoders:\n  decompress_safe round-trips every entry point; "
          "decompress_safe_partial(100) OK")
    print(f"  hc vs default size: {len(c_hc)} vs {len(c_def)} "
          f"({100 * len(c_hc) / len(c_def):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
