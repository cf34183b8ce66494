"""The measured window: one caller in a closed loop.

The caller takes the pool's objects in turn.  It compresses an object, then
decompresses the frame it got ``reads_per_write`` times; each call is sent
only after the one before it has returned, and goes from bytes in host
memory to bytes in host memory.  Each call is timed on the host's clock
from the call to its return.  No call starts once ``seconds`` have passed,
except that the first object's calls all run, so that every kind of call
is in the window.

What is judged after the window is a sample drawn from the seed: a
reservoir of frames and one of decompressed outputs, each of the window's
calls equally likely to be in it.  Every other output is dropped before the
next call, as a caller would drop it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import sys
import time
import traceback
from typing import Callable, List, Optional

KEEP = {"frame": 2, "output": 4}   # reservoir sizes


@dataclasses.dataclass
class Call:
    kind: str          # "compress" or "decompress"
    wall_s: float
    content: int       # content bytes
    frame: int         # frame bytes (0 where the call failed)
    ok: bool


@dataclasses.dataclass
class Window:
    calls: List[Call]
    seconds: float                       # from the first call to the last
    frames: list                         # sampled (frame, object index)
    outputs: list                        # sampled (content, consumed,
                                         #   frame length, object index)


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def closed_loop(system, objects: List[bytes], reads_per_write: int,
                seconds: float, seed: int,
                span: Optional[Callable[[str], object]] = None) -> Window:
    """Run the window; ``span(name)`` gives a context around each call."""
    span = span or (lambda name: contextlib.nullcontext())
    rng = random.Random(f"codecbench-sample-{seed}")
    frames = Reservoir(KEEP["frame"], rng)
    outputs = Reservoir(KEEP["output"], rng)
    calls: List[Call] = []
    shown = 0

    def failed(kind: str, size: int, wall: float) -> None:
        nonlocal shown
        calls.append(Call(kind, wall, size, 0, False))
        if shown < 3:
            shown += 1
            print(f"codecbench: a {kind} call raised:", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)

    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    while time.perf_counter() < deadline:
        index = k % len(objects)
        data = objects[index]
        k += 1
        t0 = time.perf_counter()
        try:
            with span("compress"):
                frame = system.compress(data)
        except Exception:
            failed("compress", len(data), time.perf_counter() - t0)
            continue
        calls.append(Call("compress", time.perf_counter() - t0, len(data),
                          len(frame), True))
        frames.offer((frame, index))
        for _ in range(reads_per_write):
            if k > 1 and time.perf_counter() >= deadline:
                break
            t0 = time.perf_counter()
            try:
                with span("decompress"):
                    content, consumed = system.decompress(frame)
            except Exception:
                failed("decompress", len(data), time.perf_counter() - t0)
                continue
            calls.append(Call("decompress", time.perf_counter() - t0,
                              len(data), len(frame), True))
            outputs.offer((content, consumed, len(frame), index))
            del content
        del frame
    return Window(calls, time.perf_counter() - start, frames.items,
                  outputs.items)
