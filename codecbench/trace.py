"""The traced window: ``torch.profiler`` with CPU and CUDA activity, the
benchmark's own ``record_function`` spans around each call, and the
arithmetic that per-layer metrics share.

``TraceView`` holds the spans (one a call, with the call's content and frame
bytes), the device intervals (kernels, memcpys, memsets, as CUPTI reports
them), the host's operators (for naming idle gaps) and the names of the
port's own ``__global__`` functions, read from ``lz4_tpu_torch/csrc/``.
Device intervals are assigned to the spans they overlap, clipped to them.
No trace is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}
SPAN_NAMES = ("compress", "decompress")
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
MIB = 1 << 20


@dataclasses.dataclass
class Span:
    name: str
    t0: int            # ns
    t1: int
    content: int       # content bytes of the call
    frame: int         # frame bytes of the call


@dataclasses.dataclass
class Interval:
    kind: str          # "kernel", "memcpy" or "memset"
    name: str
    t0: int            # ns
    t1: int


@dataclasses.dataclass
class TraceView:
    spans: List[Span]
    device: List[Interval]                 # sorted by start
    host_ops: List[Tuple[int, int, str]]   # (t0, t1, name), sorted
    port_kernels: "re.Pattern"             # matches the port's kernels

    def spans_of(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def inside(self, name: str) -> List[Interval]:
        """The device intervals that overlap spans ``name``, clipped to
        them."""
        spans = self.spans_of(name)
        starts = [s.t0 for s in spans]
        out = []
        for d in self.device:
            i = bisect.bisect_right(starts, d.t1) - 1
            while i >= 0 and spans[i].t1 > d.t0:
                a, b = max(d.t0, spans[i].t0), min(d.t1, spans[i].t1)
                if b > a:
                    out.append(Interval(d.kind, d.name, a, b))
                i -= 1
        return out

    def is_port_kernel(self, name: str) -> bool:
        return self.port_kernels.search(name) is not None


def union_ns(intervals: Iterable[Interval]) -> int:
    """Total length of the union of the intervals."""
    busy, end = 0, None
    for a, b in sorted((d.t0, d.t1) for d in intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def total_ns(intervals: Iterable[Interval]) -> int:
    return sum(d.t1 - d.t0 for d in intervals)


def span_ns(spans: Sequence[Span]) -> int:
    return sum(s.t1 - s.t0 for s in spans)


def is_host_copy(d: Interval) -> bool:
    return d.kind == "memcpy" and ("HtoD" in d.name or "DtoH" in d.name)


def roofline_pct(spans: Sequence[Span], kernel_ns: int) -> Optional[float]:
    """The share of the least time the chip's memory bandwidth allows, in
    %: the calls' content bytes and frame bytes, each moved once, over the
    time of the device's kernels."""
    if not spans or kernel_ns <= 0:
        return None
    nbytes = sum(s.content + s.frame for s in spans)
    return 100.0 * nbytes / PEAK_BYTES_PER_S / (kernel_ns / 1e9)


def per_mib(spans: Sequence[Span], ns: int) -> Optional[float]:
    """Milliseconds per MiB of the calls' content."""
    content = sum(s.content for s in spans)
    return ns / 1e6 / (content / MIB) if spans and content else None


def port_kernels(csrc: Path) -> "re.Pattern":
    """A pattern that finds, in a device kernel's name, a ``__global__``
    function of the port's CUDA sources."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*[(<]")
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(path.read_text()))
    if not names:
        raise RuntimeError(f"no __global__ functions under {csrc}")
    return re.compile(r"\b(" + "|".join(sorted(map(re.escape, names)))
                      + r")\b")


def short_name(d: Interval) -> str:
    """A device interval's name without "void", namespaces and
    parameters."""
    if d.kind != "kernel":
        return d.name[:80]
    name = d.name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0].split("<")[0][:80]


def _activity(e, cuda) -> str:
    """The kind of a Kineto event, read from its device and its name."""
    name = e.name()
    if e.device_type() == cuda:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "gpu_user_annotation" if name in SPAN_NAMES else "kernel"
    return "user_annotation" if name in SPAN_NAMES else "cpu_op"


def _interval_ns(e) -> Tuple[int, int]:
    t0 = e.start_ns()
    return t0, t0 + e.duration_ns()


def collect(prof, calls, kernels: "re.Pattern") -> TraceView:
    """The ``TraceView`` of a finished ``torch.profiler.profile``;
    ``calls`` are the window's calls in order (``window.Call``)."""
    from torch.autograd import DeviceType

    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    device, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _activity(e, DeviceType.CUDA)
        if kind == "user_annotation" and e.name() in SPAN_NAMES:
            spans[e.name()].append(_interval_ns(e))
        elif kind in DEVICE_KINDS:
            device.append(Interval(DEVICE_KINDS[kind], e.name(),
                                   *_interval_ns(e)))
        elif kind == "cpu_op":
            host_ops.append((*_interval_ns(e), e.name()))
    out = []
    for name, ivs in spans.items():
        mine = [c for c in calls if c.kind == name]
        if len(mine) != len(ivs):
            raise RuntimeError(f"{len(ivs)} {name} spans for {len(mine)} "
                               "calls")
        out += [Span(name, a, b, c.content, c.frame)
                for (a, b), c in zip(sorted(ivs), mine)]
    out.sort(key=lambda s: s.t0)
    device.sort(key=lambda d: d.t0)
    host_ops.sort()
    return TraceView(out, device, host_ops, kernels)


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps inside the traced window, each named by the call the host was in
    and the innermost host operator running at the gap's middle."""
    by_name: Dict[str, float] = defaultdict(float)
    for d in view.device:
        by_name[short_name(d)] += (d.t1 - d.t0) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    if view.spans:
        lo, hi = window_ns(view)
        end = lo
        for d in view.device:
            if d.t0 > end:
                gaps.append((min(d.t0, hi) - end, end))
            end = max(end, d.t1)
            if end >= hi:
                break
        if end < hi:
            gaps.append((hi - end, end))
    gaps.sort(reverse=True)
    starts = [s.t0 for s in view.spans]
    named = []
    for length, at in gaps[:top]:
        mid = at + length // 2
        i = bisect.bisect_right(starts, mid) - 1
        where = view.spans[i].name if i >= 0 and view.spans[i].t1 > mid \
            else "between calls"
        op = "python"
        for a, b, name in view.host_ops:
            if a > mid:
                break
            if b > mid:
                op = name               # the latest started: the innermost
        named.append([f"{where}: {op}", length / 1e9])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def window_ns(view: TraceView) -> Tuple[int, int]:
    """From the first call's start to the last call's end."""
    if not view.spans:
        return 0, 0
    return view.spans[0].t0, max(s.t1 for s in view.spans)


def busy_s(view: TraceView) -> float:
    """Seconds in which an operation ran on the device in the window."""
    lo, hi = window_ns(view)
    return union_ns(Interval(d.kind, d.name, max(d.t0, lo), min(d.t1, hi))
                    for d in view.device if d.t1 > lo and d.t0 < hi) / 1e9


def window_s(view: TraceView) -> float:
    lo, hi = window_ns(view)
    return (hi - lo) / 1e9
