"""Whether the window's calls were correct, judged by the plain reference.

After the window, and after the device's memory peak has been read:

* every sampled frame is parsed and checked by ``reference.lz4frame``
  against the configuration's frame settings and against the object it was
  made from (header and its checksum byte, every block, the end mark, no
  trailing bytes), and its stored content checksum against the reference's
  XXH32 of the object;
* every sampled decompressed output is compared byte for byte with its
  object, and the bytes the port says it consumed with the frame's length;
* no call may have raised.

The frames and the hashes are worked out in worker processes (``spawn``),
which import only ``codecbench.reference`` and NumPy.  Each number has its
limit: the reference's checks are exact, so every count of faults has the
limit 0, and at least one frame (and one output, where the cell
decompresses) has to have been checked.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

import numpy as np

from .reference.lz4frame import check_frame
from .reference.xxh32 import xxh32

WORKERS = 4

# name -> (limit, "max" or "min")
LIMITS = {
    "calls_failed": (0, "max"),
    "frames_checked": (1, "min"),
    "header_bad": (0, "max"),
    "blocks_bad": (0, "max"),
    "tail_bad": (0, "max"),
    "frame_bytes_wrong": (0, "max"),
    "outputs_checked": (1, "min"),
    "output_bytes_wrong": (0, "max"),
    "consumed_wrong": (0, "max"),
}


def _output_wrong(out: bytes, want: bytes) -> int:
    n = min(len(out), len(want))
    a = np.frombuffer(out, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(out) - len(want))


class Checker:
    """Judges windows; holds the worker processes between them."""

    def __init__(self, workers: int = WORKERS):
        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def submit(self, config: dict, objects: List[bytes], window) -> "Pending":
        """Start judging ``window``; ``Pending.numbers()`` waits."""
        expect = dict(config["frame"])
        frames = [self.pool.submit(check_frame, f, expect, objects[i])
                  for f, i in window.frames]
        need = sorted({i for _, i in window.frames}) \
            if expect["content_checksum"] else []
        hashes = {i: self.pool.submit(xxh32, objects[i]) for i in need}
        return Pending(window, objects, frames, hashes)


class Pending:
    def __init__(self, window, objects, frames, hashes):
        self.window, self.objects = window, objects
        self.frames, self.hashes = frames, hashes

    def numbers(self) -> Dict[str, int]:
        w = self.window
        n = dict.fromkeys(LIMITS, 0)
        n["calls_failed"] = sum(not c.ok for c in w.calls)
        notes = []
        for (_, index), fut in zip(w.frames, self.frames):
            c = fut.result()
            if index in self.hashes and c.checksum is not None and \
                    c.checksum != self.hashes[index].result():
                c.tail_bad += 1
                c.note("content checksum differs from the XXH32 of the "
                       "object")
            n["header_bad"] += c.header_bad
            n["blocks_bad"] += c.blocks_bad
            n["tail_bad"] += c.tail_bad
            n["frame_bytes_wrong"] += c.bytes_wrong
            n["frames_checked"] += 1
            notes += c.notes
        for content, consumed, frame_len, index in w.outputs:
            n["output_bytes_wrong"] += _output_wrong(content,
                                                     self.objects[index])
            n["consumed_wrong"] += consumed != frame_len
            n["outputs_checked"] += 1
        if not any(c.kind == "decompress" for c in w.calls):
            del n["outputs_checked"], n["output_bytes_wrong"], \
                n["consumed_wrong"]
        self.notes = notes[:8]
        return n


def verdict(numbers: Dict[str, int]) -> Dict[str, dict]:
    """Each number beside its limit, and whether it holds."""
    out = {}
    for name, value in numbers.items():
        limit, kind = LIMITS[name]
        ok = value <= limit if kind == "max" else value >= limit
        out[name] = {"value": value, "limit": limit, "rule": kind,
                     "ok": ok}
    return out
