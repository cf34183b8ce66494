#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lz4_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

1. Checks for a card and prints its name and power limit.
2. Builds the kernels from lz4_tpu_torch/csrc (nvcc, sm_90a).
3. Holds every kernel against its plain PyTorch/Python version on the same
   inputs, byte for byte (tolerance 0: a codec's outputs are integers), at
   the main path's shapes, and times both.
4. Runs the main path at full size: a 64 MiB real-text corpus (the Python
   stdlib sources, built the way bench.py builds its corpus) through
   compress_frame_device and decompress_frame_device, at min_match=8 /
   reject_step=1 (the bench point), at the default min_match=4, and at
   mm=8 with a content checksum (the lz4 CLI's default frame).  The launch
   counters are reset just before and read just after: kernels A, C and
   linked D must have launched and no plain version may have run.
5. Resets the counters again and runs the smaller entry points: a 4 MB
   one-shot linked frame, a 60 KB input (kernel B), and independent frames
   with and without block and content checksums.  Every kernel, B and
   batch D included, must launch here, and no plain version may run.
6. Decodes a 1 MB frame written by the kernels with the plain versions.

Prints a JSON line of the kernels (each with the launch count of the phase
that drives it, and both phases' counts), then, as its last line,
{"ok": true, "device": {...}}.  Exits non-zero on any failure, and when no
card is present.  Writes nothing outside build/ (the kernel library).
"""

import json
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
W = 65536
CORPUS_BYTES = 64 << 20
# (min_match, reject_step, content checksum)
MAIN_POINTS = ((8, 1, False), (4, 1, False), (8, 1, True))

# name -> (route, source, the Pallas launch it replaces, the phase whose
# launch count it reports: "main" = step 4, "entry" = step 5)
KERNELS = {
    "encode_linked": ("cuda", "lz4_tpu_torch/csrc/encode.cu",
                      "lz4_tpu/kernels/encode_kernel.py:744", "main"),
    "encode": ("cuda", "lz4_tpu_torch/csrc/encode.cu",
               "lz4_tpu/kernels/encode_kernel.py:398", "entry"),
    "pack": ("cuda", "lz4_tpu_torch/csrc/pack.cu",
             "lz4_tpu/kernels/pack_kernel.py:161", "main"),
    "decode_linked": ("cuda", "lz4_tpu_torch/csrc/decode.cu",
                      "lz4_tpu/kernels/decode_kernel.py:834", "main"),
    "decode_batch": ("cuda", "lz4_tpu_torch/csrc/decode.cu",
                     "lz4_tpu/kernels/decode_kernel.py:834", "entry"),
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def real_text_corpus(nbytes: int) -> bytes:
    """The Python stdlib sources concatenated in sorted order (repeated if
    the stdlib is smaller), as bench.py builds its corpus."""
    parts, size = [], 0
    for p in sorted(Path(sysconfig.get_paths()["stdlib"]).rglob("*.py")):
        try:
            b = p.read_bytes()
        except OSError:
            continue
        parts.append(b)
        size += len(b)
        if size >= nbytes:
            break
    data = b"".join(parts)[:nbytes]
    if len(data) < nbytes:
        data = (data * (nbytes // max(len(data), 1) + 1))[:nbytes]
    return data


def mixed_bytes(n: int, text: bytes, seed: int) -> bytes:
    """Inputs unlike text, from a seed: zero runs, noise, short periods,
    text slices and far repeats of earlier output."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rint(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=g))

    def noise(k):
        return torch.randint(0, 256, (k,), generator=g,
                             dtype=torch.uint8).numpy().tobytes()

    out = bytearray()
    while len(out) < n:
        kind, size = rint(0, 5), rint(1, 20_000)
        if kind == 0:
            out += bytes(size)
        elif kind == 1:
            out += noise(size)
        elif kind == 2:
            period = rint(1, 40)
            out += (noise(period) * (size // period + 1))[:size]
        elif kind == 3:
            start = rint(0, len(text) - size)
            out += text[start:start + size]
        elif out:
            start = rint(0, len(out))
            out += out[start:start + size]
    return bytes(out[:n])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.frame import FramePreferences
    from lz4_tpu_torch.kernels import build, common
    from lz4_tpu_torch.kernels import decode_kernel as dec
    from lz4_tpu_torch.kernels import encode_kernel as enc
    from lz4_tpu_torch.kernels.pack_kernel import pack_frame_payloads

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name}")
    cuda = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.kernels_lib()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    stats = {k: {"max_abs_err": 0, "ms": None, "plain_ms": None}
             for k in KERNELS}

    def cmp_rows(kernel, what, k_out, k_olen, p_out, p_olen):
        """Exact comparison of out[:olen] rows and olen; records the max
        absolute difference (0 when equal) and fails on any difference."""
        torch.cuda.synchronize()
        k_olen = k_olen.cpu().reshape(-1)
        p_olen = p_olen.cpu().reshape(-1)
        k_out = k_out.cpu().reshape(len(k_olen), -1)
        p_out = p_out.cpu().reshape(len(p_olen), -1)
        err = int((k_olen.long() - p_olen.long()).abs().max())
        for i, n in enumerate(p_olen.tolist()):
            if n > 0:
                d = (k_out[i, :n].int() - p_out[i, :n].int()).abs().max()
                err = max(err, int(d))
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        log(f"[compare] {kernel:14s} {what}: rows={len(p_olen)} "
            f"bytes={int(p_olen.clamp(min=0).sum())} max_abs_err={err}")
        if err:
            raise SmokeFailure(f"{kernel} disagrees with its plain version "
                               f"on {what}")

    def time_card(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def time_host(fn):
        t = time.perf_counter()
        res = fn()
        return res, (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    corpus = real_text_corpus(CORPUS_BYTES)
    log(f"[corpus] {len(corpus)} bytes of stdlib text in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 3a. kernel A: 8 blocks + a partial, mm 4/8, prefix 0/64 KB ---------
    def linked_case(data, prefix, mm, rs=1, zero=False, acc=1):
        nb = -(-len(data) // W)
        host = torch.zeros((1, (nb + 1) * W), dtype=torch.uint8)
        if prefix:
            host[0, W - len(prefix):W] = torch.frombuffer(
                bytearray(prefix), dtype=torch.uint8)
        host[0, W:W + len(data)] = torch.frombuffer(bytearray(data),
                                                    dtype=torch.uint8)
        lens = torch.tensor([[min(W, len(data) - k * W) for k in range(nb)]],
                            dtype=torch.int32)
        pre = torch.tensor([len(prefix)], dtype=torch.int32)
        delta, jump = enc.linked_tables(
            host.to(cuda), nb, mm, pre.to(cuda) if zero else None)
        args_card = (host.to(cuda), lens.to(cuda), pre.to(cuda), delta,
                     jump, acc, mm, rs)
        args_cpu = (host, lens, pre, delta.cpu(), jump.cpu(), acc, mm, rs)
        return args_card, args_cpu

    small = corpus[3 * W:3 * W + 8 * W + 20_011]
    for mm in (4, 8):
        for prefix in (b"", corpus[2 * W:3 * W]):
            card, cpu = linked_case(small, prefix, mm)
            k = enc.scan_linked(*card)
            p = enc.scan_linked(*cpu)
            cmp_rows("encode_linked", f"9 blocks mm={mm} prefix="
                     f"{len(prefix)}", *k, *p)

    # main-path shape: one 4 MB chunk with its 64 KB window, bench point
    chunk = corpus[4 << 20:8 << 20]
    window = corpus[(4 << 20) - W:4 << 20]
    card, cpu = linked_case(chunk, window, 8, zero=True)
    stats["encode_linked"]["ms"] = time_card(lambda: enc.scan_linked(*card))
    p, stats["encode_linked"]["plain_ms"] = time_host(
        lambda: enc.scan_linked(*cpu))
    k = enc.scan_linked(*card)
    cmp_rows("encode_linked", "64 blocks mm=8 (main-path chunk)", *k, *p)
    stream_d = card[0]
    t_tab = time_card(lambda: enc.linked_tables(stream_d, 64, 8,
                                                card[2]))
    log(f"[time] linked candidate tables (torch.sort etc.), 64 blocks: "
        f"{t_tab:.3f} ms")
    a_out, a_olen = k

    # -- 3b. kernel C on kernel A's output ----------------------------------
    blocks_d = stream_d[0, W:65 * W].view(64, W)
    lens64 = torch.full((64,), W, dtype=torch.int32)
    stats["pack"]["ms"] = time_card(lambda: pack_frame_payloads(
        a_out.reshape(64, -1), a_olen.reshape(64), blocks_d, lens64.to(cuda)))
    k_flat, k_total, k_stored = pack_frame_payloads(
        a_out.reshape(64, -1), a_olen.reshape(64), blocks_d, lens64.to(cuda))
    (p_flat, p_total, p_stored), stats["pack"]["plain_ms"] = time_host(
        lambda: pack_frame_payloads(a_out.reshape(64, -1).cpu(),
                                    a_olen.reshape(64).cpu(),
                                    blocks_d.cpu(), lens64))
    # a stored block and a padding row, too
    olen_mix = a_olen.reshape(64).clone()
    olen_mix[3] = W + 5
    lens_mix = lens64.clone()
    lens_mix[63] = 0
    k2 = pack_frame_payloads(a_out.reshape(64, -1), olen_mix, blocks_d,
                             lens_mix.to(cuda))
    p2 = pack_frame_payloads(a_out.reshape(64, -1).cpu(), olen_mix.cpu(),
                             blocks_d.cpu(), lens_mix)
    for what, (kf, kt, ks), (pf, pt, ps) in (
            ("64 blocks (main-path chunk)", (k_flat, k_total, k_stored),
             (p_flat, p_total, p_stored)),
            ("stored block + padding row", k2, p2)):
        if int(kt) != int(pt) or not torch.equal(ks.cpu(), ps):
            raise SmokeFailure(f"pack totals or stored flags differ ({what})")
        cmp_rows("pack", what, kf[:int(kt)].reshape(1, -1), kt.reshape(1),
                 pf[:int(pt)].reshape(1, -1), pt.reshape(1))

    # -- 3c. kernel D, linked mode ------------------------------------------
    win_d = stream_d[0, :W]
    dl_args = (a_out.reshape(64, -1), a_olen.reshape(64), W, win_d, W)
    stats["decode_linked"]["ms"] = time_card(
        lambda: dec.decode_blocks_linked(*dl_args))
    k = dec.decode_blocks_linked(*dl_args)
    p, stats["decode_linked"]["plain_ms"] = time_host(
        lambda: dec.decode_blocks_linked(
            a_out.reshape(64, -1).cpu(), a_olen.reshape(64).cpu(), W,
            win_d.cpu(), W))
    cmp_rows("decode_linked", "64-block chain with init window", *k, *p)
    if k[0].cpu().reshape(-1).numpy().tobytes() != chunk:
        raise SmokeFailure("linked decode of kernel A's chunk is not the "
                           "chunk")
    k = dec.decode_blocks_linked(a_out.reshape(64, -1), a_olen.reshape(64),
                                 W)
    p = dec.decode_blocks_linked(a_out.reshape(64, -1).cpu(),
                                 a_olen.reshape(64).cpu(), W)
    cmp_rows("decode_linked", "64-block chain, no window", *k, *p)

    # -- 3d. kernel B, then kernel D batch mode on its output -----------------
    rows_h = torch.frombuffer(bytearray(corpus[:64 * W]),
                              dtype=torch.uint8).reshape(64, W).clone()
    blens = torch.full((64,), W, dtype=torch.int32)
    blens[5], blens[6], blens[7] = 60_000, 13, 0
    rows_h[5, 60_000:] = 0
    rows_h[6, 13:] = 0
    rows_h[7] = 0
    rows_d = rows_h.to(cuda)
    for mm in (4, 8):
        delta, jump = enc.independent_tables(rows_d, mm)
        card_b = (rows_d, blens.to(cuda), delta, jump, 1, mm, 1)
        cpu_b = (rows_h, blens, delta.cpu(), jump.cpu(), 1, mm, 1)
        if mm == 8:
            stats["encode"]["ms"] = time_card(
                lambda: enc.scan_blocks(*card_b))
            p, stats["encode"]["plain_ms"] = time_host(
                lambda: enc.scan_blocks(*cpu_b))
        else:
            p = enc.scan_blocks(*cpu_b)
        k = enc.scan_blocks(*card_b)
        cmp_rows("encode", f"64 rows of <= 64 KB mm={mm}", *k, *p)
    b_out, b_olen = k
    db_args = (b_out, b_olen, W)
    stats["decode_batch"]["ms"] = time_card(
        lambda: dec.decode_blocks(*db_args))
    k = dec.decode_blocks(*db_args)
    p, stats["decode_batch"]["plain_ms"] = time_host(
        lambda: dec.decode_blocks(b_out.cpu(), b_olen.cpu(), W))
    cmp_rows("decode_batch", "kernel B's 64 rows", *k, *p)

    # corrupted streams: truncations, bit flips, length bombs, bad offsets
    gen = torch.Generator().manual_seed(1234)
    comp_rows, comp_lens = [], []
    b_out_h, b_olen_h = b_out.cpu(), b_olen.cpu()
    for i in range(48):
        n = int(b_olen_h[i % 8])
        row = bytearray(b_out_h[i % 8, :n].numpy().tobytes())
        kind = i % 4
        if kind == 0:
            row = row[:int(torch.randint(1, max(n, 2), (1,),
                                         generator=gen))]
        elif kind == 1:
            for _ in range(int(torch.randint(1, 9, (1,), generator=gen))):
                pos = int(torch.randint(0, len(row), (1,), generator=gen))
                row[pos] = int(torch.randint(0, 256, (1,), generator=gen))
        elif kind == 2:
            row = bytearray([0xF0] + [255] * (i + 1)) + row
        else:
            row = bytearray([0x12, 0xAA, 0xFF, 0xFF]) + row
        comp_rows.append(bytes(row))
        comp_lens.append(len(row))
    M = max(comp_lens)
    bad = torch.zeros((len(comp_rows), M), dtype=torch.uint8)
    for i, r in enumerate(comp_rows):
        bad[i, :len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
    bad_lens = torch.tensor(comp_lens, dtype=torch.int32)
    k = dec.decode_blocks(bad.to(cuda), bad_lens.to(cuda), W)
    p = dec.decode_blocks(bad, bad_lens, W)
    cmp_rows("decode_batch", "48 corrupted streams", *k, *p)
    k = dec.decode_blocks_linked(bad.to(cuda), bad_lens.to(cuda), W)
    p = dec.decode_blocks_linked(bad, bad_lens, W)
    cmp_rows("decode_linked", "48 corrupted streams as a chain", *k, *p)
    nrej = int((p[1] < 0).sum())
    log(f"[compare] corrupted streams rejected: {nrej} of {len(comp_rows)}")

    # -- 3e. inputs unlike text: zero runs, noise, short periods, repeats ----
    mixed = mixed_bytes(9 * W - 7000, corpus[:1 << 20], 99)
    for mm, rs, acc in ((4, 1, 1), (8, 3, 1), (12, 1, 4)):
        prefix = corpus[:W] if mm == 8 else b""
        card, cpu = linked_case(mixed, prefix, mm, rs, acc=acc)
        k = enc.scan_linked(*card)
        p = enc.scan_linked(*cpu)
        what = f"mixed 9 blocks mm={mm} rs={rs} acc={acc} prefix={len(prefix)}"
        cmp_rows("encode_linked", what, *k, *p)
        win = card[0][0, :W]
        dk = dec.decode_blocks_linked(k[0][0], k[1][0], W, win, len(prefix))
        dp = dec.decode_blocks_linked(p[0][0], p[1][0], W, win.cpu(),
                                      len(prefix))
        cmp_rows("decode_linked", what, *dk, *dp)
        got = b"".join(dk[0][i, :n].cpu().numpy().tobytes()
                       for i, n in enumerate(dk[1].cpu().tolist()))
        if got != mixed:
            raise SmokeFailure(f"mixed chain does not round-trip ({what})")
    sizes = [W, 1, 12, 13, 100, 4096, 30_000, 65_535] * 2
    rows_h = torch.zeros((len(sizes), W), dtype=torch.uint8)
    for i, n in enumerate(sizes):
        rows_h[i, :n] = torch.frombuffer(
            bytearray(mixed[i * 20_011:i * 20_011 + n]), dtype=torch.uint8)
    blens = torch.tensor(sizes, dtype=torch.int32)
    for mm, acc in ((4, 2), (12, 1)):
        delta, jump = enc.independent_tables(rows_h.to(cuda), mm)
        k = enc.scan_blocks(rows_h.to(cuda), blens.to(cuda), delta, jump,
                            acc, mm, 1)
        p = enc.scan_blocks(rows_h, blens, delta.cpu(), jump.cpu(), acc, mm,
                            1)
        cmp_rows("encode", f"16 mixed rows mm={mm} acc={acc}", *k, *p)
        dk = dec.decode_blocks(k[0], k[1], W)
        dp = dec.decode_blocks(p[0], p[1], W)
        cmp_rows("decode_batch", f"16 mixed rows mm={mm}", *dk, *dp)
        if not torch.equal(dk[1].cpu(), blens):
            raise SmokeFailure("mixed rows do not round-trip")
    # noise as compressed input: every load and store stays in bounds
    noise = torch.randint(0, 256, (64, 4096), generator=gen,
                          dtype=torch.uint8)
    noise_lens = torch.randint(0, 4097, (64,), generator=gen,
                               dtype=torch.int32)
    for mode, fn in (("decode_batch", dec.decode_blocks),
                     ("decode_linked", dec.decode_blocks_linked)):
        k = fn(noise.to(cuda), noise_lens.to(cuda), W)
        p = fn(noise, noise_lens, W)
        cmp_rows(mode, "64 rows of noise", *k, *p)

    def phase_counts(phase, need):
        """Read the counters after a phase: every kernel in ``need`` must
        have launched and no plain version may have run."""
        launches = {k: common.LAUNCHES.get(k, 0) for k in KERNELS}
        plain = dict(common.PLAIN_CALLS)
        log(f"[counts] {phase}: kernel launches {launches}; plain-version "
            f"calls {plain}")
        missing = [k for k in need if launches[k] <= 0]
        if missing or any(plain.values()):
            raise SmokeFailure(f"{phase} skipped kernels {missing} or ran "
                               f"plain versions {plain}")
        return launches

    # -- 4. main path at full size -----------------------------------------
    common.reset_counts()
    for mm, rs, checksum in MAIN_POINTS:
        prefs = FramePreferences(block_size_id=4, content_checksum=checksum)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = D.compress_frame_device(corpus, prefs, min_match=mm,
                                        reject_step=rs)
        t1 = time.perf_counter()
        out, used = D.decompress_frame_device(frame)
        t2 = time.perf_counter()
        what = f"mm={mm} rs={rs}" + (" content checksum" if checksum else "")
        if out != corpus or used != len(frame):
            raise SmokeFailure(f"64 MiB round trip differs at {what}")
        mb = len(corpus) / 1e6
        log(f"[main] {len(corpus) >> 20} MiB corpus {what}: ratio "
            f"{len(frame) / len(corpus):.6f} ({len(frame)} bytes), "
            f"compress {mb / (t1 - t0):.1f} MB/s ({t1 - t0:.3f} s), "
            f"decompress {mb / (t2 - t1):.1f} MB/s ({t2 - t1:.3f} s), "
            f"round trip byte-exact")
        del out
    counts = {"main": phase_counts(
        "main path", [k for k, v in KERNELS.items() if v[3] == "main"])}

    # -- 5. the other entry points -------------------------------------------
    common.reset_counts()
    cases = (
        ("4 MB one-shot linked", corpus[:4 << 20],
         FramePreferences(block_size_id=4)),
        ("60 KB (kernel B)", corpus[:60_000],
         FramePreferences(block_size_id=4)),
        ("3 MB independent + checksums", corpus[:3 << 20],
         FramePreferences(block_size_id=4, block_independent=True,
                          block_checksum=True, content_checksum=True,
                          content_size=3 << 20)),
        ("2 MB independent, packed", corpus[:2 << 20],
         FramePreferences(block_size_id=4, block_independent=True)),
    )
    for what, data, pr in cases:
        frame = D.compress_frame_device(data, pr, min_match=8)
        out, used = D.decompress_frame_device(frame)
        if out != data or used != len(frame):
            raise SmokeFailure(f"round trip differs: {what}")
        log(f"[entry] {what}: ratio {len(frame) / len(data):.6f}, "
            f"round trip byte-exact")
    counts["entry"] = phase_counts("entry points", list(KERNELS))

    # -- 6. the plain decoder reads a frame the kernels wrote ------------------
    data = corpus[8 << 20:9 << 20]
    frame = D.compress_frame_device(data, FramePreferences(block_size_id=4),
                                    min_match=8)
    if D.decompress_frame_device(frame, device="cpu") != (data, len(frame)):
        raise SmokeFailure("plain decoder disagrees on a kernel-written frame")
    log("[check] plain decoder reads a 1 MB frame written by the kernels")

    report = {"kernels": [
        {"name": k, "route": route, "source": src, "replaces": rep,
         "launches": counts[phase][k], "counted_in": phase,
         "launches_by_phase": {p: c[k] for p, c in counts.items()},
         **stats[k]}
        for k, (route, src, rep, phase) in KERNELS.items()]}
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
