"""The port's own spans, read against the device trace: each call's
device-idle time charged to the host step the port was in.

``lz4_tpu_torch.trace`` records, while the profiler runs, a root span
``call`` for each call of a frame entry point and, inside it, step spans
(``walk``, ``copy``, ``launch`` with ``tables`` inside it, ``link``,
``xxh32``), on the clock Kineto stamps host events with.  ``split(run)``
takes them once after the traced window (``take_spans``) and keeps the
result on the run record, because the module of each metric is loaded anew:

1. the root spans are paired, in order and by kind, with the benchmark's
   spans ``compress`` and ``decompress`` of the same calls;
2. each root span must lie inside its benchmark span within ``MISFIT_NS``
   at both ends, so that a clock mismatch cannot go unseen;
3. a call's device-idle time is its benchmark span less the union of the
   device intervals (as ``idle_frac.*`` computes it), and each idle instant
   goes to the innermost step span open then, ``tables`` counted under
   ``launch``; idle time inside no step is "unnamed".

Where the split cannot be made (no device intervals, as on the CPU; a port
without spans, as before they existed; no root spans; dropped spans; a
misfit), every reader of it returns None and the reason is printed on
standard error once.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace

MISFIT_NS = 1_000_000
STEPS = ("walk", "copy", "launch", "link", "xxh32")
UNDER = {"tables": "launch"}             # a step counted under another
KINDS = {"compress_frame_device": "compress",
         "compress_frame_device_hc": "compress",
         "decompress_frame_device": "decompress"}


@dataclasses.dataclass
class Split:
    idle: Dict[str, Dict[str, int]]      # kind -> step or "unnamed" -> ns
    idle_ns: Dict[str, int]              # kind -> all idle ns
    roots: Dict[str, list]               # kind -> the port's root spans
    tables_ms: Optional[float]           # Σ tables event ms, compress
    misfit_ns: int                       # the largest overhang of a root


def _take():
    """The port's spans and dropped count, or None for a port without
    them."""
    try:
        from lz4_tpu_torch.trace import take_spans
    except ImportError:
        return None
    return take_spans()


def _union(view: trace.TraceView) -> List[Tuple[int, int]]:
    """The device intervals merged into sorted disjoint (t0, t1)."""
    out: List[List[int]] = []
    for a, b in sorted((d.t0, d.t1) for d in view.device):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _idle(union, ends, a: int, b: int) -> List[Tuple[int, int]]:
    """[a, b) less the union: the idle intervals, in order."""
    out, t = [], a
    i = bisect.bisect_right(ends, a)
    while i < len(union) and union[i][0] < b:
        s, e = union[i]
        if s > t:
            out.append((t, s))
        t = max(t, e)
        i += 1
    if t < b:
        out.append((t, b))
    return out


def _segments(steps) -> List[Tuple[int, int, str]]:
    """Nested step spans -> (t0, t1, step) where that step is the innermost
    open, in order."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    t = None
    for s in sorted(steps, key=lambda s: (s.t0, -s.t1)):
        while stack and stack[-1][0] <= s.t0:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack and s.t0 > t:
            out.append((t, s.t0, stack[-1][1]))
        t = s.t0
        stack.append((s.t1, UNDER.get(s.name, s.name)))
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [seg for seg in out if seg[1] > seg[0]]


def _charge(idle, segs, into: Dict[str, int]) -> None:
    """Add the overlap of the idle intervals with each segment to its
    step."""
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                into[segs[k][2]] += hi - lo
            k += 1


def split_of(view: Optional[trace.TraceView], taken) -> "Split | str":
    """The split of a run's device-idle time, or why there is none."""
    if view is None or not view.device:
        return "no device intervals"
    if taken is None:
        return "the port records no spans"
    spans, dropped = taken
    if dropped:
        return f"{dropped} port spans dropped"
    roots = [s for s in spans if s.parent is None and s.name == "call"]
    if not roots:
        return "no root spans"
    steps = defaultdict(list)
    for s in spans:
        if s.parent is not None and s.call is not None:
            steps[s.call].append(s)
    union = _union(view)
    ends = [b for _, b in union]
    out = Split({}, {}, {}, None, 0)
    for kind in ("compress", "decompress"):
        bench = view.spans_of(kind)
        mine = sorted((r for r in roots
                       if KINDS.get(r.attrs.get("entry")) == kind),
                      key=lambda r: r.t0)
        if len(mine) != len(bench):
            return (f"{len(mine)} port {kind} calls for {len(bench)} "
                    "benchmark spans")
        idle = defaultdict(int)
        total = 0
        for b, r in zip(bench, mine):
            over = max(b.t0 - r.t0, r.t1 - b.t1)
            if over > MISFIT_NS:
                return (f"a {kind} root span lies {over} ns outside its "
                        "benchmark span")
            out.misfit_ns = max(out.misfit_ns, over)
            gaps = _idle(union, ends, b.t0, b.t1)
            total += sum(e - s for s, e in gaps)
            _charge(gaps, _segments(steps[r.id]), idle)
        idle["unnamed"] = total - sum(idle.values())
        out.idle[kind], out.idle_ns[kind], out.roots[kind] = \
            dict(idle), total, mine
    times = [s.attrs.get("event_ms") for r in out.roots["compress"]
             for s in steps[r.id] if s.name == "tables"]
    if times and None not in times:
        out.tables_ms = sum(times)
    return out


def split(run) -> Optional[Split]:
    """The run's split, computed once: None, with the reason on standard
    error, where there is none.  A test may set ``run.port_spans`` to the
    (spans, dropped) that ``take_spans`` would give."""
    got = getattr(run, "port_split", None)
    if got is None:
        taken = getattr(run, "port_spans", None)
        got = split_of(run.trace, taken if taken is not None else _take())
        run.port_split = got
        if isinstance(got, str):
            print(f"codecbench: port spans: {got}", file=sys.stderr)
        else:
            calls = {k: len(v) for k, v in got.roots.items()}
            print(f"codecbench: port spans: {calls} calls paired, largest "
                  f"misfit {got.misfit_ns} ns, idle ns {got.idle}",
                  file=sys.stderr)
    return got if isinstance(got, Split) else None


def idle_ms_per_mib(run, kind: str, step: str) -> Optional[float]:
    """Device-idle ms inside ``step`` per MiB of the ``kind`` calls'
    content."""
    s = split(run)
    if s is None or not s.roots.get(kind):
        return None
    return trace.per_mib(run.trace.spans_of(kind), s.idle[kind].get(step, 0))


def unnamed_frac(run, kind: str) -> Optional[float]:
    """The share of the ``kind`` calls' device-idle time inside no step."""
    s = split(run)
    if s is None or not s.idle_ns.get(kind):
        return None
    return s.idle[kind]["unnamed"] / s.idle_ns[kind]


def counts_per_byte(run, kind: str, *keys: str) -> Optional[float]:
    """The sum of the ``kind`` root spans' counts under ``keys`` over their
    content bytes; None where a root lacks one of the keys."""
    s = split(run)
    roots = s.roots.get(kind) if s is not None else None
    content = sum(r.attrs.get("content", 0) for r in roots or ())
    if not content:
        return None
    try:
        return sum(r.attrs["counts"][k] for r in roots for k in keys) \
            / content
    except KeyError as e:
        print(f"codecbench: port spans: no count {e}", file=sys.stderr)
        return None


def host_copy_per_byte(run, kind: str) -> Optional[float]:
    """Host copy bytes over content bytes, from the ``kind`` root spans'
    counts."""
    return counts_per_byte(run, kind, "host_copy_bytes")
