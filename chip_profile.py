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
decompress_legacy_device; for the -B4 cell it decodes the corpus as a -B4
frame written by io.compress_stream at -1 -B4 (independent 64 KB blocks,
kernel D's batch mode) through decompress_frame_device; for each
scatter-gather cell (chip_smoke.py's sg
phase layouts over the first 16 MiB: 4 KB iovecs into 4 KB iovecs, and
ragged iovecs) it runs lz4_tpu_torch.sg.sg_compress, then sg_decompress
back into the input iovecs; for the HC cell it runs the corpus through
compress_frame_device_hc at level 9 (kernel I, 64 KB independent blocks);
for each file cell (chip_smoke.py's hc phase: the lz4 CLI's -9, -1 and
-1 -BD) it compresses the corpus, written as a file under build/, through
io.compress_filename; for the destSize and checksum cells (chip_smoke.py's
destsize phase, on the corpus as rows of 64 KB) it runs kernel H at cap =
max(n // 2, 64), the first round of kernel D's resumable decode of kernel
B's payloads at out_caps = 32,768, xxh32_batch and xxh64_batch over the
rows, and the SG walk of 128 KB iovecs into 32 KB buffers with kernel H as
its destSize compressor; for the legacy cells it compresses the corpus
through compress_legacy_device at -1 (kernel A) and -9 (kernel I); for
the envelope cells (chip_smoke.py's envelope phase) it decodes a -B7
independent and a -B7 linked frame of just over 2 GiB through
decompress_frame_device (kernel E in runs) and runs the SG walk of a
partial source over kernel H.  Each step runs twice: once untraced (wall time
only) and once under torch.profiler with CUDA activity.  From the traced
pass's Chrome trace it reports:

* device busy ms: the union of the intervals of every kernel, memcpy and
  memset on the card, so work that overlaps is counted once;
* idle share: 1 - busy / wall of the traced pass (tracing adds host time,
  so this share is an upper bound for the untraced pass);
* device ms per kernel or copy name, summed over the pass, largest first;
* the split of the traced wall: kernels, the linked decoders'
  pointer-jumping rounds, device-to-host and host-to-device copies, other
  device work (summed device ms, so overlapping work counts twice), and
  host = traced wall minus device busy.

Writes each trace to ``<out>/trace_<cell>_<direction>.json`` and prints one
JSON line of the results.  Exits non-zero when no card is present or a
round trip differs.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent
CELLS = (("mm8", 8, False), ("mm4", 4, False), ("mm8_checksum", 8, True))
STREAM_CELLS = ("b7", "b5_linked", "legacy", "flushed")  # chip_smoke files
SG_CELLS = ("4k", "ragged")        # chip_smoke.sg_layouts
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def split_of(name: str, cat: str) -> str:
    """The part of a wall a device interval counts toward: "jump" (the
    linked decoders' pointer-jumping rounds), "kernel" (every other
    kernel), "d2h", "h2d" or "other" (other copies, memsets)."""
    if cat == "kernel":
        return "jump" if "jump_kernel" in name else "kernel"
    if "DtoH" in name or "Device -> Pageable" in name:
        return "d2h"
    return "h2d" if "HtoD" in name else "other"


def device_time(trace_path: Path) -> tuple:
    """(busy ms as the union of device intervals, {name: summed ms},
    {split_of part: summed ms})."""
    trace = json.loads(trace_path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans, by_name = [], defaultdict(float)
    split = dict.fromkeys(("kernel", "jump", "d2h", "h2d", "other"), 0.0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            name = e["name"]
            if e["cat"] == "kernel":     # drop "void", namespaces, params
                name = name.replace("(anonymous namespace)::", "")
                name = re.sub(r"^void ", "", name).split("(")[0]
            by_name[name[:80]] += e["dur"] / 1e3
            split[split_of(name, e["cat"])] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, dict(by_name), split


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

    from chip_smoke import (DS_DECODE_CAP, FILE_SETTINGS, LEGACY_SETTINGS,
                            SG_PARTIAL, b4_frame, corpus_rows,
                            envelope_frame, envelope_inputs, filled,
                            frame_payloads, kernel_b_payloads,
                            real_text_corpus, sg_h_layout, sg_layouts,
                            stream_files)
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch import io as tio
    from lz4_tpu_torch import sg
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.kernels import build
    from lz4_tpu_torch.kernels.common import to_host
    from lz4_tpu_torch.kernels.decode_kernel import decode_blocks_dest_size
    from lz4_tpu_torch.kernels.destsize_kernel import encode_blocks_dest_size
    from lz4_tpu_torch.kernels.xxh32_kernel import xxh32_batch
    from lz4_tpu_torch.kernels.xxh64_kernel import xxh64_batch

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
    hc_prefs = FramePreferences(block_independent=True)
    D.compress_frame_device_hc(warm[:1 << 20], hc_prefs, 9)
    w_rows, w_lens = corpus_rows(warm[:1 << 20], "cuda")
    w_out, w_olen, _ = encode_blocks_dest_size(w_rows, w_lens, w_lens // 2)
    decode_blocks_dest_size(w_out, w_olen, w_lens, 65536)
    xxh32_batch(w_rows, w_lens)
    xxh64_batch(w_rows, w_lens)

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
            # the tracer drops the first kernels launched after it starts,
            # which is all of a one-kernel cell: start it on a fill of one
            # element (about 2 us of device time when it is recorded)
            torch.empty((1,), device="cuda").zero_()
            res_t, wall_t = timed(fn)
        if res_t != res or (want is not None and res != want):
            raise RuntimeError(f"{key}: output differs")
        path = out_dir / f"trace_{key.replace('/', '_')}.json"
        prof.export_chrome_trace(str(path))
        busy, by_name, split = device_time(path)
        split["host"] = wall_t - busy
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        r = results[key] = {
            "wall_ms": wall, "mb_s": mb / (wall / 1e3),
            "traced_wall_ms": wall_t, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_t, "top_device_ms": dict(top),
            "split_ms": split}
        print(f"[{key}] wall {wall:.1f} ms ({r['mb_s']:.1f} MB/s); traced "
              f"{wall_t:.1f} ms, device busy {busy:.1f} ms, idle "
              f"{r['idle_share']:.3f}; split " + ", ".join(
                  f"{k} {v:.3f}" for k, v in split.items()), flush=True)
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
    b7_blocks = [p for p, _ in frame_payloads(files["b7"], 7)]
    del files
    for flags, level in LEGACY_SETTINGS:
        key = f"legacy{level}/compress"
        frame = measure(key, lambda: D.compress_legacy_device(corpus, level))
        results[key]["ratio"] = len(frame) / len(corpus)
    del frame
    # frames of just over 2 GiB (chip_smoke.envelope_frame)
    linked_blocks, texts, noise = envelope_inputs(corpus, "cuda")
    for key, blocks, linked in (("env_b7", b7_blocks, False),
                                ("env_b7_linked", linked_blocks, True)):
        frame, content, _ = envelope_frame(list(zip(blocks, texts)), linked,
                                           noise)
        measure(f"{key}/decompress",
                lambda: D.decompress_frame_device(frame)[0], content,
                content=len(content))
        results[f"{key}/decompress"]["frame_bytes"] = len(frame)
        del frame, content
    del noise
    frame = b4_frame(corpus, "cuda")
    measure("b4/decompress", lambda: D.decompress_frame_device(frame)[0],
            corpus)
    results["b4/decompress"]["ratio"] = len(frame) / len(corpus)
    del frame
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
    frame = measure("hc9/compress", lambda: D.compress_frame_device_hc(
        corpus, hc_prefs, 9))
    results["hc9/compress"]["ratio"] = len(frame) / len(corpus)
    del frame
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        src, dst = Path(d) / "corpus", str(Path(d) / "corpus.lz4")
        src.write_bytes(corpus)
        for flags, kw in FILE_SETTINGS:
            prefs = tio.IoPrefs(overwrite=True, verbosity=1, **kw)  # -q
            key = f"file{flags.replace(' ', '')}/compress"   # file-1-BD/...
            _, w = measure(key, lambda: tio.compress_filename(str(src), dst,
                                                              prefs))
            results[key]["ratio"] = w / len(corpus)
    # the destSize and checksum cells; each returns bytes so that the two
    # passes can be compared
    rows, lens = corpus_rows(corpus, "cuda")
    half = torch.clamp(lens // 2, min=64)
    measure("destsize_h/encode", lambda: to_host(
        encode_blocks_dest_size(rows, lens, half)[2]).tobytes())
    comp, clen = kernel_b_payloads(rows, lens)
    caps = torch.full_like(lens, DS_DECODE_CAP)
    measure("destsize_d/decode_round1", lambda: to_host(
        decode_blocks_dest_size(comp, clen, caps, DS_DECODE_CAP)[2]).tobytes(),
        content=len(lens) * DS_DECODE_CAP)
    del comp
    measure("xxh32/rows", lambda: xxh32_batch(rows, lens).tobytes())
    measure("xxh64/rows", lambda: xxh64_batch(rows, lens).tobytes())
    del rows
    ins, caps = sg_h_layout(corpus)
    total, _, _ = measure("sg_h/compress", lambda: sg.sg_compress(
        ins, caps, dest_size_compress=sg.dest_size_over_h("cuda")),
        content=sum(map(len, ins)))
    results["sg_h/compress"]["ratio"] = total / sum(map(len, ins))
    total, _, _ = measure("sg_partial_h/compress", lambda: sg.sg_compress(
        ins, caps, source_size=SG_PARTIAL), content=SG_PARTIAL)
    results["sg_partial_h/compress"]["ratio"] = total / SG_PARTIAL
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "corpus_bytes": len(corpus), "cells": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
