"""The readings that the limits of ``check.py`` are set from.

    python3 -m codecbench.control --workload <cell> --seconds 3 \
        --seeds <n> ... --control-seeds <n> ... [--out <file>]

In one process, on the cell's own sizes and load: for each of ``--seeds``,
a short window of the program as the configuration states it, judged as a
run judges it; for each of ``--control-seeds``, the same with the
configuration's control (``control`` in ``configs/<name>.json``: the
program's own switch that breaks one guarantee the configuration states).
Prints one line a window and, last, one JSON object: every window's
numbers, the largest reading of each number over the program's windows
(the lower reading) and the smallest over the control's (the upper
reading).  The benchmark's own runs never run the control.  The windows'
judging runs in worker processes while the next window runs, so the
timings of these windows mean nothing.
"""

import argparse
import json
import sys
from pathlib import Path

from .run import NO_CARD, cache_dirs, card_missing, warm


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    cache_dirs()
    from . import cells
    from .check import LIMITS, Checker, verdict
    from .system import System
    from .window import closed_loop

    root = Path(root) if root is not None else cells.HERE
    cell = cells.load_cell(args.workload, root)
    if device is None:
        missing = card_missing(cell.chips)
        if missing:
            print(f"codecbench: {cell.name}: {missing}", file=sys.stderr)
            return NO_CARD
        device = "cuda"
        from lz4_tpu_torch.kernels import build
        build.kernels_lib()
    reads = int(cell.traffic["reads_per_write"])
    make_objects = cells.generator(cell.traffic, root)
    systems = {"program": System(cell.config, device),
               "control": System(cell.config, device, control=True)}
    todo = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds]
    runs = []
    with Checker(workers=6) as checker:
        for i, (mode, seed) in enumerate(todo):
            objects = make_objects(cell.traffic, seed)
            if i == 0 or mode != todo[i - 1][0]:
                warm(systems[mode], objects, reads)
            win = closed_loop(systems[mode], objects, reads, args.seconds,
                              seed)
            runs.append((mode, seed, len(win.calls),
                         checker.submit(cell.config, objects, win)))
            del objects, win
        out = []
        for mode, seed, ncalls, pending in runs:
            checks = verdict(pending.numbers())
            numbers = {k: c["value"] for k, c in checks.items()}
            correct = all(c["ok"] for c in checks.values())
            out.append({"mode": mode, "seed": seed, "calls": ncalls,
                        "correct": correct, "numbers": numbers,
                        "notes": pending.notes})
            print(f"{cell.name} {mode} seed {seed}: {ncalls} calls, "
                  f"correct {correct}, {numbers}", flush=True)
    faults = [n for n, (_, rule) in LIMITS.items() if rule == "max"]
    summary = {
        "workload": cell.name, "runs": out,
        "lower": {n: max(r["numbers"].get(n, 0) for r in out
                         if r["mode"] == "program") for n in faults},
        "upper": {n: min(r["numbers"].get(n, 0) for r in out
                         if r["mode"] == "control") for n in faults},
        "program_correct": all(r["correct"] for r in out
                               if r["mode"] == "program"),
        "control_incorrect": all(not r["correct"] for r in out
                                 if r["mode"] == "control"),
    }
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
