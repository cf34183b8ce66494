#!/usr/bin/env python3
"""Where the port's time goes, on one NVIDIA card.

    python3 chip_profile.py [--mib 64] [--out chiprun_out]

Builds the kernels, makes the stdlib-text corpus the way chip_smoke.py
does, and warms up on 16 MiB.  Then, for each main-path cell (linked 64 KB
blocks at min_match=8, at min_match=4, and at min_match=8 with a content
checksum), it runs the corpus through compress_frame_device and
decompress_frame_device; for each stream cell (the files of chip_smoke.py's
stream phase: a -B7 independent frame with a content checksum, a -B5
linked frame, a legacy file, a 64 KB linked frame with flushed short
blocks) it decodes the file through decompress_frame_device or
decompress_legacy_device; for each scatter-gather cell (chip_smoke.py's sg
phase layouts over the first 16 MiB: 4 KB iovecs into 4 KB iovecs, and
ragged iovecs) it runs lz4_tpu_torch.sg.sg_compress, then sg_decompress
back into the input iovecs.  Each step runs twice: once untraced (wall time
only) and once under torch.profiler with CUDA activity.  From the traced
pass's Chrome trace it reports:

* device busy ms: the union of the intervals of every kernel, memcpy and
  memset on the card, so work that overlaps is counted once;
* idle share: 1 - busy / wall of the traced pass (tracing adds host time,
  so this share is an upper bound for the untraced pass);
* device ms per kernel or copy name, summed over the pass, largest first.

Writes each trace to ``<out>/trace_<cell>_<direction>.json`` and prints one
JSON line of the results.  Exits non-zero when no card is present or a
round trip differs.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent
CELLS = (("mm8", 8, False), ("mm4", 4, False), ("mm8_checksum", 8, True))
STREAM_CELLS = ("b7", "b5_linked", "legacy", "flushed")  # chip_smoke files
SG_CELLS = ("4k", "ragged")        # chip_smoke.sg_layouts
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_time(trace_path: Path) -> tuple:
    """(busy ms as the union of device intervals, {name: summed ms})."""
    trace = json.loads(trace_path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans, by_name = [], defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            name = e["name"]
            if e["cat"] == "kernel":     # drop "void", namespaces, params
                name = name.replace("(anonymous namespace)::", "")
                name = re.sub(r"^void ", "", name).split("(")[0]
            by_name[name[:80]] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, dict(by_name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=64, help="corpus size, MiB")
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for the Chrome traces")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import filled, real_text_corpus, sg_layouts, stream_files
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import sg
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}",
          flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    build.kernels_lib()
    corpus = real_text_corpus(args.mib << 20)
    warm = corpus[:16 << 20]
    prefs0 = FramePreferences(block_size_id=4)
    D.decompress_frame_device(D.compress_frame_device(warm, prefs0,
                                                      min_match=8))
    w_ins = [warm[i:i + 4096] for i in range(0, 1 << 20, 4096)]
    w_caps = [4096] * 272
    w_total, _, w_outs = sg.sg_compress(w_ins, w_caps)
    sg.sg_decompress(filled(w_outs, w_caps, w_total), [4096] * len(w_ins))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    results = {}

    def measure(key, fn, want=None, content=None):
        """Run ``fn`` untraced, then traced; record the step under ``key``
        and return its result (which must equal ``want`` when given).  MB/s
        counts ``content`` bytes (the corpus by default)."""
        mb = (len(corpus) if content is None else content) / 1e6
        res, wall = timed(fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res_t, wall_t = timed(fn)
        if res_t != res or (want is not None and res != want):
            raise RuntimeError(f"{key}: output differs")
        path = out_dir / f"trace_{key.replace('/', '_')}.json"
        prof.export_chrome_trace(str(path))
        busy, by_name = device_time(path)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        r = results[key] = {
            "wall_ms": wall, "mb_s": mb / (wall / 1e3),
            "traced_wall_ms": wall_t, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_t, "top_device_ms": dict(top)}
        print(f"[{key}] wall {wall:.1f} ms ({r['mb_s']:.1f} MB/s); traced "
              f"{wall_t:.1f} ms, device busy {busy:.1f} ms, idle "
              f"{r['idle_share']:.3f}", flush=True)
        for name, ms in top:
            print(f"    {ms:10.3f} ms  {name}", flush=True)
        return res

    for cell, mm, checksum in CELLS:
        prefs = FramePreferences(block_size_id=4, content_checksum=checksum)
        frame = measure(f"{cell}/compress", lambda: D.compress_frame_device(
            corpus, prefs, min_match=mm))
        results[f"{cell}/compress"]["ratio"] = len(frame) / len(corpus)
        measure(f"{cell}/decompress",
                lambda: D.decompress_frame_device(frame)[0], corpus)
    files = stream_files(corpus, "cuda")
    for name in STREAM_CELLS:
        decode = (D.decompress_legacy_device if name == "legacy"
                  else D.decompress_frame_device)
        measure(f"stream_{name}/decompress", lambda: decode(files[name])[0],
                corpus)
    del files
    layouts = sg_layouts(corpus)
    for name in SG_CELLS:
        _, ins, caps = layouts[name]
        content = sum(map(len, ins))
        total, _, outs = measure(f"sg_{name}/compress",
                                 lambda: sg.sg_compress(ins, caps),
                                 content=content)
        results[f"sg_{name}/compress"]["ratio"] = total / content
        comp = filled(outs, caps, total)
        measure(f"sg_{name}/decompress",
                lambda: sg.sg_decompress(comp, [len(b) for b in ins])[1],
                ins, content=content)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "corpus_bytes": len(corpus), "cells": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
