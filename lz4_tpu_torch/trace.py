"""The port's counters and spans.

Counters are always on:

* ``LAUNCHES`` (a ``collections.Counter``): one per launch of a kernel on
  the card, by kernel;
* ``PLAIN_CALLS`` (a ``Counter``): one per call of a kernel's plain
  PyTorch version;
* ``COUNTS``, a dict whose keys, ``COUNT_KEYS``, are always present (a
  dict bumps in a third of a ``Counter``'s time): ``h2d_bytes`` and
  ``d2h_bytes`` (the bytes ``kernels.common`` copies to and from the
  device), ``syncs`` (each wait of the host on the card: every blocking
  copy either way, since PyTorch's blocking host-to-device copy waits for
  the stream too, and every read of a card value), ``host_copy_bytes``
  (bytes the frame path writes on the host when it copies content or frame
  bytes; zero fills and objects handed back whole do not count),
  ``xxh32_bytes`` (bytes hashed on the host), ``pinned_d2h_bytes``
  (the part of ``d2h_bytes`` fetched into pinned host memory: decoded
  content on its way to one copy out, bumped where each fetch is
  issued) and ``merged_bytes`` (the bytes of the blocks the host joins
  from kernel payloads, ``device.join_block``, bumped where each join
  returns; each is a host copy too).  They count on the CPU too, where a "sync" is the wait the
  call would make on the card, and a fetch the one it would issue.

Spans are recorded only while a ``torch.profiler`` session records.
Otherwise ``span`` returns ``OFF``, one shared ``contextlib.nullcontext``:
no clock read, no allocation, no CUDA call.  A span holds its name, its
start and end in ns on the clock Kineto stamps host events with (Unix
time, ``time.time_ns``), the id of its parent span, and the id of the call
it belongs to.  A frame entry point wrapped in ``entry`` is one call: a
root span ``call`` that holds the entry's name, its content and frame
bytes, and the call's deltas of ``LAUNCHES`` and of every ``COUNTS`` key.
Inside it the innermost step span open names what the host is doing:
``walk`` (frame headers and block records), ``copy`` (host copies of
content and frame bytes), ``launch`` (work queued on the card: a call into
a kernel wrapper, or the tensor ops that stage a kernel's input there),
``tables`` (the candidate tables of kernels A and I in PyTorch ops, inside
``launch``), ``link`` (copies between host and card, and every wait on
the card), ``xxh32`` (the host XXH32) and ``merge`` (the host's join of
kernel payloads into one block).  On the card a ``tables`` span
also records a pair of CUDA events on the current stream; their time is
read in ``take_spans``, long after the call's last fetch has waited for
the stream, so no span makes the host wait.

Spans are kept in memory, at most ``MAX_SPANS``; later ones are counted as
dropped.  ``take_spans()`` hands them over and starts a new list.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import List, Tuple

import torch
from torch.autograd import profiler as _profiler

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()
COUNT_KEYS = ("h2d_bytes", "d2h_bytes", "syncs", "host_copy_bytes",
              "xxh32_bytes", "pinned_d2h_bytes", "merged_bytes")
COUNTS: dict = dict.fromkeys(COUNT_KEYS, 0)
STEPS = ("walk", "copy", "launch", "tables", "link", "xxh32", "merge")
MAX_SPANS = 1 << 18

_spans: List["Span"] = []
_dropped = 0
_last_id = 0
_local = threading.local()


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()
    COUNTS.update(dict.fromkeys(COUNT_KEYS, 0))


def copied(out, *sources):
    """Count ``out`` as a host copy of ``len(out)`` bytes, unless it is one of
    ``sources`` (CPython hands back the object itself for a whole slice, a
    join of one part, or ``bytes`` of bytes); returns ``out``."""
    for s in sources:
        if out is s:
            return out
    COUNTS["host_copy_bytes"] += len(out)
    return out


OFF = contextlib.nullcontext()          # every span while no profiler records


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(s: "Span") -> None:
    global _dropped
    if len(_spans) < MAX_SPANS:
        _spans.append(s)
    else:
        _dropped += 1


class Span:
    """One recorded span; times in ns on Kineto's host clock."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "call", "attrs",
                 "_events")

    def __init__(self, name: str):
        self.name, self.attrs, self._events = name, None, None
        self.t1 = 0

    def __enter__(self):
        global _last_id
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        self.call = up.call if up is not None else None
        _last_id += 1
        self.id = _last_id
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.time_ns()
        _stack().pop()
        _keep(self)
        return None


class _Timed(Span):
    """A span that also records a pair of CUDA events on the current stream
    of card ``dev``."""

    __slots__ = ("dev",)

    def __init__(self, name: str, dev):
        super().__init__(name)
        self.dev = dev

    def __enter__(self):
        stream = torch.cuda.current_stream(self.dev)
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        self._events[0].record(stream)
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb):
        self._events[1].record(torch.cuda.current_stream(self.dev))
        return super().__exit__(exc_type, exc, tb)


class _Call(Span):
    """A root span: one call of a frame entry point."""

    __slots__ = ("_before",)

    def __init__(self, entry: str):
        super().__init__("call")
        self.attrs = {"entry": entry}

    def __enter__(self):
        super().__enter__()
        self.call = self.id
        self._before = (dict(LAUNCHES), dict(COUNTS))
        return self

    def __exit__(self, exc_type, exc, tb):
        launches, counts = self._before
        by_name = {k: n - launches.get(k, 0) for k, n in LAUNCHES.items()
                   if n != launches.get(k, 0)}
        self.attrs.update(
            launches=sum(by_name.values()), launches_by_name=by_name,
            counts={k: COUNTS[k] - counts[k] for k in COUNT_KEYS})
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        return super().__exit__(exc_type, exc, tb)


def span(name: str):
    """A step span ``name`` while a profiler records, else ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name)


def timed(name: str):
    """A decorator: each call of the function, whose first argument is a
    tensor, is a span ``name``; on the card the span also records a pair of
    CUDA events around the work the call queues."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(t, *args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(t, *args, **kwargs)
            s = _Timed(name, t.device) if t.device.type == "cuda" \
                else Span(name)
            with s:
                return fn(t, *args, **kwargs)
        return run
    return wrap


def _nbytes(x) -> int:
    return len(x) if isinstance(x, (bytes, bytearray)) \
        else memoryview(x).nbytes


def entry(kind: str):
    """A decorator for a frame entry point of ``kind`` "compress" (bytes
    in, a frame out) or "decompress" (a frame in, (content, consumed)
    out): while a profiler records, each call is a root span ``call``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(data, *args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(data, *args, **kwargs)
            with _Call(fn.__name__) as root:
                out = fn(data, *args, **kwargs)
                if kind == "compress":
                    root.attrs.update(content=_nbytes(data), frame=len(out))
                else:
                    root.attrs.update(content=len(out[0]),
                                      frame=_nbytes(data))
            return out
        return run
    return wrap


def take_spans() -> Tuple[List[Span], int]:
    """The spans recorded since the last take, in order of their start, and
    the number dropped for want of room; starts a new list.  A ``tables``
    span's ``attrs["event_ms"]`` is its CUDA events' time (None where the
    events had not completed)."""
    global _dropped
    spans, dropped = list(_spans), _dropped
    _spans.clear()
    _dropped = 0
    for s in spans:
        if s._events is not None:
            start, end = s._events
            s.attrs = {"event_ms": start.elapsed_time(end)
                       if end.query() else None}
            s._events = None
    spans.sort(key=lambda s: (s.t0, s.id))
    return spans, dropped

