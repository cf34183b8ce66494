#!/usr/bin/env python3
"""Per-entry-point MB/s of the PyTorch/CUDA port (lz4_tpu_torch): the twin of
``fullbench.py`` (the reference's programs/fullbench.c analog).

    python3 fullbench_torch.py [--mb N | --kb N] [--device cuda|cpu]

One line per cell, ``name`` then MB/s, in ``fullbench.py``'s format, on the
corpus ``gen_buffer_np(size, 0.7, 42)`` (``fullbench.py:47``), 16 MB unless
``--mb`` or ``--kb`` says otherwise.  Every cell checks its round trip (or
its digests) before its rate is printed, and a difference raises.  Device
calls are timed on the host clock with ``torch.cuda.synchronize()`` before
and after each call.  The default device is the card; without one the
script exits non-zero.  ``--device cpu`` runs the kernels' plain versions,
which is what the CPU test does at a small ``--kb``.  It imports only
``lz4_tpu_torch`` and writes nothing.

Each ``fullbench.py`` line and its counterpart here:

- ``:54-87``, the host codec (``block_np``, ``hc``, ``frame``, ``stream``,
  ``sg``): the port has no host codec on purpose, so the "library API"
  section times the port's API, every block on the kernels, on the same
  blocks: ``block.compress_default``/``decompress_safe`` over the 64 KB
  blocks (``:55``, ``:57``), ``hc.compress_hc_block`` at level 9 (``:60``),
  ``frame.compress_frame``/``decompress_frame`` (``:63``, ``:65``),
  ``stream.BlockCompressStream.compress_continue`` on a 16 KB chain
  (``:68``), ``sg.sg_compress``/``sg_decompress`` on 16 x 4 KB (``:73``,
  ``:86``).
- ``:90`` ``xxhash_native.xxh32``: ``ops.xxhash.xxh32`` (the port's host
  XXH32, native through ``cc``).  ``:91`` ``xxhash_native.xxh64`` and
  ``:92`` ``xxhash_np.xxh32``: none; the port's frames hash with XXH32 on
  the host, its XXH64 is kernel K (whose numpy plain version checks the
  card's digests here), and it keeps no second, pure-numpy XXH32.
- ``:121`` ``encode_blocks``, ``:127`` ``decode_blocks``, ``:150``
  ``decode_blocks_linked`` (the same independent payloads), ``:136``
  ``xxh32_batch``, ``:143`` ``xxh64_batch``, ``:161`` ``decode_blocks_sg``,
  ``:173`` ``encode_dest_size`` at cap n/2, ``:184`` its resumable decode
  (``decode_blocks_dest_size`` at n/2), ``:195`` ``sg.sg_compress`` on the
  device (64 KB iovecs, kernel G), ``:206`` ``encode_blocks_hc`` at level 9
  on at most 8 blocks, ``:223`` ``decode_stream`` on 256 KB blocks (kernel
  B's payloads, independent), ``:228``/``:230``
  ``compress_frame_device``/``decompress_frame_device``, ``:239``
  ``compress_frame_device_hc`` at level 9 on at most 2 blocks: the port's
  kernel-level and pipeline entry points of the same names.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

CHUNK = 65536


def report(name, nbytes, secs):
    print(f"{name:<44}{nbytes / 1e6 / max(secs, 1e-12):>10.1f} MB/s",
          flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, dev, iters=3):
    """Best wall time of ``iters`` calls, each between two synchronizes."""
    best = float("inf")
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def expect(ok, what):
    if not ok:
        raise RuntimeError(f"fullbench_torch: {what} does not round-trip")


def rows_equal(out, olen, chunks) -> bool:
    out, olen = out.cpu(), olen.cpu().tolist()
    return olen == [len(c) for c in chunks] and all(
        out[i, :n].numpy().tobytes() == c
        for i, (n, c) in enumerate(zip(olen, chunks)))


def sg_join(total, outs, caps):
    """The compressed bytes of an SG walk, buffer by buffer (as
    ``fullbench.py:75-85`` gathers them for ``sg_decompress``)."""
    bufs, rem = [], total
    for b, c in zip(outs, caps):
        if rem <= 0:
            break
        bufs.append(b[:min(c, rem)])
        rem -= min(c, rem)
    if len(bufs) > 1 and len(bufs[-1]) < 2:
        bufs[-2] += bufs.pop()      # an end mark's tail of under 2 bytes
    return bufs


def library_api(data, small, chunks, dev):
    from lz4_tpu_torch import block, frame, hc, sg, stream
    from lz4_tpu_torch.ops import xxhash

    n = len(data)
    print(f"== library API ({n} B corpus, 64KB blocks; the port has no "
          f"host codec) ==", flush=True)
    comp = [block.compress_default(c, device=dev) for c in chunks]
    expect([block.decompress_safe(x, CHUNK, device=dev) for x in comp]
           == chunks, "block.compress_default")
    report("block.compress_default", n, timeit(
        lambda: [block.compress_default(c, device=dev) for c in chunks], dev,
        1))
    report("block.decompress_safe", n, timeit(
        lambda: [block.decompress_safe(x, CHUNK, device=dev) for x in comp],
        dev, 1))
    hcb = hc.compress_hc_block(small, 9, device=dev)
    expect(block.decompress_safe(hcb, len(small), device=dev) == small,
           "hc.compress_hc_block")
    report("hc.compress_hc_block level 9 (64KB)", len(small),
           timeit(lambda: hc.compress_hc_block(small, 9, device=dev), dev, 1))
    f = frame.compress_frame(small, device=dev)
    expect(frame.decompress_frame(f, device=dev) == (small, len(f)),
           "frame.compress_frame")
    report("frame.compress_frame (64KB)", len(small), timeit(
        lambda: frame.compress_frame(small, device=dev), dev, 1))
    report("frame.decompress_frame (64KB)", len(small), timeit(
        lambda: frame.decompress_frame(f, device=dev), dev, 1))
    pieces = [small[i:i + 16384] for i in range(0, len(small), 16384)]
    st = stream.BlockCompressStream(device=dev)
    chain = [st.compress_continue(p) for p in pieces]
    ds = stream.BlockDecompressStream(device=dev)
    expect(b"".join(ds.decompress_continue(x, 16384) for x in chain)
           == small, "stream.compress_continue")
    report("stream.compress_continue (16KB chain)", len(small), timeit(
        lambda: [st.compress_continue(p) for p in pieces], dev, 1))
    ins = [small[i:i + 4096] for i in range(0, len(small), 4096)]
    caps = [4096 + 128] * (len(ins) + 1)
    total, consumed, outs = sg.sg_compress(ins, caps, device=dev)
    bufs = sg_join(total, outs, caps)
    got = sg.sg_decompress(bufs, [len(b) for b in ins], device=dev)[1]
    expect(consumed == len(small) and b"".join(got) == small,
           "sg.sg_compress")
    report(f"sg.sg_compress ({len(ins)}x4KB)", len(small), timeit(
        lambda: sg.sg_compress(ins, caps, device=dev), dev, 1))
    report(f"sg.sg_decompress ({len(ins)}x4KB)", len(small), timeit(
        lambda: sg.sg_decompress(bufs, [len(b) for b in ins], device=dev),
        dev, 1))
    print("== checksums ==", flush=True)
    report("ops.xxhash.xxh32", n, timeit(lambda: xxhash.xxh32(data), dev))


def kernels(data, chunks, dev):
    from lz4_tpu_torch.device import byte_rows
    from lz4_tpu_torch.kernels import decode_kernel as dec
    from lz4_tpu_torch.kernels import destsize_kernel as dsk
    from lz4_tpu_torch.kernels import encode_kernel as enc
    from lz4_tpu_torch.kernels.hc_kernel import encode_blocks_hc
    from lz4_tpu_torch.kernels.xxh32_kernel import xxh32_batch
    from lz4_tpu_torch.kernels.xxh64_kernel import (xxh64_batch,
                                                    xxh64_rows_plain)
    from lz4_tpu_torch.ops import xxhash

    n = len(data)
    print(f"== kernels ({dev}, device-resident, 64KB blocks) ==", flush=True)
    rows, lens = byte_rows(chunks, CHUNK, dev)

    def encode():
        return enc.encode_blocks(rows, lens)

    comp, clen = encode()
    expect(rows_equal(*dec.decode_blocks(comp, clen, CHUNK), chunks),
           "kernels.encode_blocks")
    report("kernels.encode_blocks", n, timeit(encode, dev))
    report("kernels.decode_blocks", n, timeit(
        lambda: dec.decode_blocks(comp, clen, CHUNK), dev))
    sums = xxh32_batch(rows, lens)
    expect([int(x) for x in sums] == [xxhash.xxh32(c) for c in chunks],
           "kernels.xxh32_batch digests")
    report("kernels.xxh32_batch", n, timeit(lambda: xxh32_batch(rows, lens),
                                            dev))
    few = min(4, len(chunks))
    expect((xxh64_batch(rows, lens)[:few] == xxh64_rows_plain(
        rows[:few].cpu().numpy(), lens[:few].cpu().numpy(), 0)).all(),
           "kernels.xxh64_batch digests")
    report("kernels.xxh64_batch", n, timeit(lambda: xxh64_batch(rows, lens),
                                            dev))
    expect(rows_equal(*dec.decode_blocks_linked(comp, clen, CHUNK), chunks),
           "kernels.decode_blocks_linked")
    report("kernels.decode_blocks_linked", n, timeit(
        lambda: dec.decode_blocks_linked(comp, clen, CHUNK), dev))
    sizes = [len(c) for c in chunks]
    out, _ = dec.decode_blocks_sg(comp, clen, sizes)
    expect(out.cpu().numpy().tobytes() == data, "kernels.decode_blocks_sg")
    report("kernels.decode_blocks_sg", n, timeit(
        lambda: dec.decode_blocks_sg(comp, clen, sizes), dev))

    caps = torch.clamp(lens // 2, min=64)
    ds, dlen, cons = dsk.encode_blocks_dest_size(rows, lens, caps)
    cons_l = cons.cpu().tolist()
    expect(all(0 < x <= c for x, c in zip(dlen.cpu().tolist(),
                                          caps.cpu().tolist()))
           and rows_equal(*dec.decode_blocks(ds, dlen, CHUNK),
                          [c[:k] for c, k in zip(chunks, cons_l)]),
           "kernels.encode_blocks_dest_size")
    report("kernels.encode_dest_size (cap=n/2)", n, timeit(
        lambda: dsk.encode_blocks_dest_size(rows, lens, caps), dev))
    half = torch.full((len(chunks),), CHUNK // 2, dtype=torch.int32,
                      device=dev)
    hout, holen, _ = dec.decode_blocks_dest_size(comp, clen, half,
                                                 CHUNK // 2)
    holen_l = holen.cpu().tolist()
    expect(all(0 <= k <= min(CHUNK // 2, len(c))
               and hout[i, :k].cpu().numpy().tobytes() == c[:k]
               for i, (k, c) in enumerate(zip(holen_l, chunks))),
           "kernels.decode_blocks_dest_size")
    report("kernels.decode_dest_size (cap=n/2, resumable)", n // 2, timeit(
        lambda: dec.decode_blocks_dest_size(comp, clen, half, CHUNK // 2),
        dev))

    from lz4_tpu_torch import sg
    sg_caps = [CHUNK + 4096] * (len(chunks) + 1)
    total, consumed, outs = sg.sg_compress(chunks, sg_caps, device=dev)
    got = sg.sg_decompress(sg_join(total, outs, sg_caps), sizes,
                           device=dev)[1]
    expect(consumed == n and b"".join(got) == data, "sg.sg_compress")
    report(f"sg.sg_compress(device={dev.type!r})", n, timeit(
        lambda: sg.sg_compress(chunks, sg_caps, device=dev), dev, 1))

    nh = min(len(chunks), 8)          # HC is chain-bound: bench a slice
    hrows, hlens = rows[:nh].contiguous(), lens[:nh].contiguous()
    hcomp, hclen = encode_blocks_hc(hrows, hlens, 9)
    expect(rows_equal(*dec.decode_blocks(hcomp, hclen, CHUNK), chunks[:nh]),
           "kernels.encode_blocks_hc")
    report("kernels.encode_blocks_hc (HC9)", sum(sizes[:nh]), timeit(
        lambda: encode_blocks_hc(hrows, hlens, 9), dev, 1))

    big = 256 << 10
    bchunks = [data[i:i + big] for i in range(0, n, big)]
    brows, blens = byte_rows(bchunks, big, dev)
    bcomp, bclen = enc.encode_blocks(brows, blens)
    bclen_l = bclen.cpu().tolist()
    payloads = [bcomp[i, :k].cpu().numpy().tobytes()
                for i, k in enumerate(bclen_l)]
    sout, solen = dec.decode_stream(payloads, big, n, linked=False,
                                    device=dev)
    expect(solen.cpu().tolist() == [len(c) for c in bchunks]
           and sout[:n].cpu().numpy().tobytes() == data,
           "kernels.decode_stream")
    report("kernels.decode_stream (256KB blocks)", n, timeit(
        lambda: dec.decode_stream(payloads, big, n, linked=False,
                                  device=dev), dev, 1))


def pipeline(data, dev):
    from lz4_tpu_torch import device as D
    from lz4_tpu_torch.frame import FramePreferences

    n = len(data)
    print("== device frame pipeline (incl. host assembly + transfers) ==",
          flush=True)
    fr = D.compress_frame_device(data, device=dev)
    expect(D.decompress_frame_device(fr, device=dev) == (data, len(fr)),
           "device.compress_frame_device")
    report("device.compress_frame_device", n, timeit(
        lambda: D.compress_frame_device(data, device=dev), dev, 1))
    report("device.decompress_frame_device", n, timeit(
        lambda: D.decompress_frame_device(fr, device=dev), dev, 1))
    hc_data = data[:2 * CHUNK]
    indep = FramePreferences(block_independent=True)   # as device HC writes
    hfr = D.compress_frame_device_hc(hc_data, indep, level=9, device=dev)
    expect(D.decompress_frame_device(hfr, device=dev) == (hc_data, len(hfr)),
           "device.compress_frame_device_hc")
    report("device.compress_frame_device_hc (HC9)", len(hc_data), timeit(
        lambda: D.compress_frame_device_hc(hc_data, indep, level=9,
                                           device=dev),
        dev, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--kb", type=int, default=None,
                    help="corpus size in KB (overrides --mb)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lz4_tpu_torch.kernels.common import resolve_device
    from lz4_tpu_torch.utils.datagen import gen_buffer_np

    dev = resolve_device(args.device)
    size = (args.kb << 10) if args.kb is not None else (args.mb << 20)
    data = gen_buffer_np(size, 0.7, 42)
    chunks = [data[i:i + CHUNK] for i in range(0, len(data), CHUNK)]
    small = data[:CHUNK]
    library_api(data, small, chunks, dev)
    kernels(data, chunks, dev)
    pipeline(data, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
