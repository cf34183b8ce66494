"""Runs one cell of the benchmark of ``lz4_tpu_torch`` once.

    python3 -m codecbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port.  Set-up finds the cell
in ``BENCHMARK.json`` and its files by name (``cells.py``), builds the
port's kernels (into ``build/lz4_tpu_torch/`` of the checkout, which the
port fixes), makes the pool of objects from the seed (the generator that
the traffic mix names, ``traffic/<generator>.py``) and warms up with one
call of each kind on each object.  The process's heap keeps glibc's
defaults, as a caller of the port gets them.  The window then runs for
``--seconds`` (``window.py``); with ``--trace 1`` it runs under
``torch.profiler``, and the per-layer metrics are read from the trace
(``trace.py``, ``metrics/``), else the cell's end-to-end metrics from the
host's clock.  After the window the sampled outputs are judged by the
plain reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``build_s`` (the part
of set-up that loaded the kernel library, and built it in a new checkout:
recorded apart, and counted in ``setup_s`` too) and, traced,
``breakdown``, with ``checks`` last: each number compared, beside its
limit.  The last lines of standard error give the same numbers.  Exits
non-zero with no result when there is no CUDA card or fewer than the cell
needs, or when a module of JAX or of the JAX package ``lz4_tpu`` was
loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "lz4_tpu")
NO_CARD = 3
FORBIDDEN_LOADED = 4


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc build is fixed at ``build/lz4_tpu_torch/``)."""
    base = ROOT / "build" / "codecbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi: not found"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi: {smi.stderr.strip()}"


def card_missing(chips: int):
    """Why the run cannot use ``chips`` CUDA cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < chips:
        return f"{chips} cards needed, {torch.cuda.device_count()} found"
    return None


def warm(system, objects, reads_per_write: int) -> None:
    """One call of each kind the window makes, on each object.  A call that
    raises is reported and left to fail again in the window, where it is
    counted."""
    try:
        for data in objects:
            frame = system.compress(data)
            if reads_per_write:
                system.decompress(frame)
    except Exception:
        print("codecbench: a warm-up call raised:", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)


class RunRecord:
    """What the metric readers read."""

    def __init__(self, calls, setup_s, trace=None):
        self.calls, self.setup_s, self.trace = calls, setup_s, trace


def measure(system, cell, objects, seconds: float, seed: int,
            traced: bool, on_card: bool, kernels=None):
    """The window, with or without the profiler; returns (window, view)."""
    from . import trace
    from .window import closed_loop

    reads = int(cell.traffic["reads_per_write"])
    if not traced:
        return closed_loop(system, objects, reads, seconds, seed), None
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        win = closed_loop(system, objects, reads, seconds, seed,
                          span=record_function)
    return win, trace.collect(prof, win.calls, kernels)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, wrap=None, root=None) -> int:
    """One run.  ``device`` other than None skips the look for a card
    (the tests pass ``"cpu"``: the port's plain versions); ``wrap`` wraps
    the system under test (the tests plant faults with it); ``root`` is
    where the cell's files are found (this folder by default)."""
    args = parse_args(argv)
    cache_dirs()
    from . import cells, trace
    from .check import Checker, verdict
    from .system import System

    root = Path(root) if root is not None else cells.HERE
    cell = cells.load_cell(args.workload, root)
    import torch
    if device is None:
        missing = card_missing(cell.chips)
        if missing:
            print(f"codecbench: {cell.name}: {missing}", file=sys.stderr)
            return NO_CARD
        device = "cuda"
    on_card = device != "cpu"
    system = System(cell.config, device)
    build_s = 0.0
    if on_card:
        from lz4_tpu_torch.kernels import build
        t0 = time.perf_counter()
        build.kernels_lib()
        build_s = time.perf_counter() - t0
        kind = torch.cuda.get_device_name(0)
        print(f"codecbench: {cell.name} seed {args.seed} on {card_name()}",
              file=sys.stderr)
    else:
        kind = "cpu"
    print(f"codecbench: kernel library loaded (in a new checkout, built) "
          f"in {build_s} s; xxh32 on the host: {system.xxh32_kind()}",
          file=sys.stderr, flush=True)
    kernels = trace.port_kernels(system.csrc()) if args.trace else None
    if wrap is not None:
        system = wrap(system)
    objects = cells.generator(cell.traffic, root)(cell.traffic, args.seed)
    warm(system, objects, int(cell.traffic["reads_per_write"]))
    if on_card:
        torch.cuda.synchronize()

    setup_s = time.perf_counter() - START
    win, view = measure(system, cell, objects, args.seconds, args.seed,
                        bool(args.trace), on_card, kernels)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()

    record = RunRecord(win.calls, setup_s, view)
    metrics = {}
    for name in cell.per_layer if args.trace else cell.end_to_end:
        value = cells.metric_reader(name, root)(record)
        if value is not None:          # nothing to read: left out
            metrics[name] = {"value": value, "unit": cell.units[name]}

    with Checker() as checker:
        pending = checker.submit(cell.config, objects, win)
        checks = verdict(pending.numbers())
    bad = forbidden_modules()
    if bad:
        print(f"codecbench: modules loaded that the benchmark forbids: "
              f"{', '.join(bad)}", file=sys.stderr)
        return FORBIDDEN_LOADED

    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": len(win.calls),
              "failed": sum(not c.ok for c in win.calls),
              "metrics": metrics, "device": dev}
    if view is not None:
        dev["busy_s"] = trace.busy_s(view)
        dev["window_s"] = trace.window_s(view)
        result["breakdown"] = trace.breakdown(view)
    result["build_s"] = build_s
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"],
                            "rule": c["rule"]} for k, c in checks.items()}
    print(json.dumps(result), flush=True)
    for note in pending.notes:
        print(f"codecbench: {note}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
