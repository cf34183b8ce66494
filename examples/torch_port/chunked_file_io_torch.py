"""Chunked frame compression and decompression with bounded host memory,
with lz4_tpu_torch.

    python examples/torch_port/chunked_file_io_torch.py [--device cuda|cpu]

The twin of ``examples/chunked_file_io.py``: a ``FrameCompressor`` is fed
150 KB reads (its 64 KB window carried on the device, the blocks of each
read coded together by kernel A), and a ``FrameDecompressor`` is fed the
frame in 50 KB reads, decoding every block a read completes in one launch
of kernel D (linked mode, behind the last 64 KB).  The frame is compared with one-shot ``compress_frame``.  The
default device is the card, and the example raises without one;
``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lz4_tpu_torch.frame import (FrameCompressor, FrameDecompressor,
                                 FramePreferences, compress_frame)
from lz4_tpu_torch.kernels.common import resolve_device
from lz4_tpu_torch.utils.datagen import gen_buffer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    data = gen_buffer(700_000, 0.8, 2024)
    prefs = FramePreferences(block_size_id=4, content_checksum=True)

    comp = FrameCompressor(prefs, device=dev)
    parts, src = [comp.begin()], io.BytesIO(data)
    while chunk := src.read(150_000):        # any chunking works
        parts.append(comp.update(chunk))
    parts.append(comp.end())
    frame = b"".join(parts)

    dec, src, out = FrameDecompressor(device=dev), io.BytesIO(frame), []
    while not dec.finished:
        piece = src.read(50_000)
        if not piece:
            raise RuntimeError("the frame ended early")
        used, produced = dec.feed(piece)
        src.seek(used - len(piece), io.SEEK_CUR)
        out.append(produced)
    if b"".join(out) != data:
        raise RuntimeError("the chunked round trip differs from the input")
    whole = compress_frame(data, prefs, device=dev)
    print(f"chunked on {dev}: {len(frame)} bytes, whole-buffer: "
          f"{len(whole)} bytes, round-trip OK")
    if frame != whole:
        raise RuntimeError("the chunked frame differs from the one-shot one")
    return 0


if __name__ == "__main__":
    sys.exit(main())
