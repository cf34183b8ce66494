"""Data parallelism over several devices in one process.

Counterpart of ``lz4_tpu/parallel/mesh.py``.  Frames and independent
blocks are embarrassingly parallel with variable-length outputs: a batch of
blocks is split into contiguous row blocks, one per mesh position, each
position's kernels run on its own device, and the compressed lengths come
back with the rows so the host can assemble frames in order.  In one
process there is no collective: the JAX package's ``psum`` of mismatches
becomes a sum over the shards' counts.  ``multihost.py`` runs one process
per card over ``torch.distributed``.

A ``Mesh`` is a tuple of ``torch.device``s.  ``default_mesh`` gives the
first ``n`` cards, each once (or ``n`` entries of the CPU, where every
kernel runs its plain version: the tests mirror the JAX package's 8-device
virtual CPU mesh so).  A mesh built by hand may repeat a device: shards on
one device run one after another on its stream.  Every function launches
all its shards' kernels (an SG bucket's, for the SG functions) before it
reads any of their results.

Where the TPU design does not carry over: the JAX package walks a device's
SG lists one after another (``lax.map``), and kernel G walks one list on one
SM; here each device walks all its lists of a bucket in one launch of G
with a list axis (``sg_encode_chain_batch``, a CTA per list).  A list that
leaves G's records, or a chain with blocks over 64 KB, takes the port's own
route over kernel H, or E and D (``sg.py``), where the JAX package uses its
host codec; the JAX package pads a bucket with copies of its list 0, which
the port does not need.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import sg
from ..device import (BLOCK, CHUNK, _fetch_body, _frame, dispatch_linked)
from ..frame import FramePreferences
from ..kernels import destsize_kernel as dsk
from ..kernels.common import resolve_device, to_device, to_host
from ..kernels.decode_kernel import (SG_BLOCK_CAP, decode_blocks,
                                     decode_blocks_sg_raw, join_payloads)
from ..kernels.encode_kernel import encode_blocks, encode_blocks_linked

AXIS = "blocks"
# compress_frame_mesh refuses streams this long (the linked kernel's int32
# positions), as the JAX package does
MAX_STREAM = (1 << 31) - (1 << 17)

Shards = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each position along AXIS."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The first ``n_devices`` cards (every visible card by default), each
    once; more than ``torch.cuda.device_count()`` raises, and no CPU takes
    a card's place.  ``device="cpu"`` gives ``n_devices`` (default 1)
    entries of the CPU."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1))
    have = torch.cuda.device_count()
    n = n_devices or have
    if n > have:
        raise ValueError(f"{n} cards asked for, {have} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def pad_batch(n_rows: int, mesh: Mesh) -> int:
    """Rows must divide evenly over the mesh; callers pad with empty rows."""
    per = mesh.shape[AXIS]
    return -(-n_rows // per) * per


def shard_rows(mesh: Mesh, t: torch.Tensor) -> Shards:
    """Split a [B, ...] tensor into contiguous row blocks, one per mesh
    position, each on its device.  B must divide evenly over the mesh."""
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not divide over a mesh of "
                         f"{mesh.size}; pad with pad_batch")
    per = t.shape[0] // mesh.size
    return tuple(t[i * per:(i + 1) * per].to(dev).contiguous()
                 for i, dev in enumerate(mesh.devices))


def gather_rows(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """Join row blocks in order on the first shard's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards])


def _sharded(mesh: Mesh, x) -> Shards:
    """``x`` as one row block per mesh position: a tensor is split with
    ``shard_rows``; a sequence of blocks is taken as it is."""
    if isinstance(x, torch.Tensor):
        return shard_rows(mesh, x)
    if len(x) != mesh.size:
        raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
    return tuple(x)


def encode_blocks_sharded(mesh: Mesh, rows, lens, acceleration: int = 1,
                          min_match: int = 4) -> Tuple[Shards, Shards]:
    """Kernel B over the mesh: ``rows`` [B, NS] uint8 and ``lens`` [B] int32
    (tensors, split here, or their shards).  Returns (comp, comp_lens),
    one [B / n, M] and one [B / n] block per position, on its device."""
    rows, lens = _sharded(mesh, rows), _sharded(mesh, lens)
    outs = [encode_blocks(r, ln, acceleration, min_match=min_match)
            for r, ln in zip(rows, lens)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def decode_blocks_sharded(mesh: Mesh, comp, lens, out_cap: int,
                          dict_rows=None, dict_lens=None
                          ) -> Tuple[Shards, Shards]:
    """Kernel D's batch mode over the mesh, dictionaries sharded with their
    rows.  Returns (out, olen) blocks as ``encode_blocks_sharded`` does."""
    comp, lens = _sharded(mesh, comp), _sharded(mesh, lens)
    if (dict_rows is None) != (dict_lens is None):
        raise ValueError("dict_rows and dict_lens go together")
    dicts = (zip(_sharded(mesh, dict_rows), _sharded(mesh, dict_lens))
             if dict_rows is not None else [(None, None)] * mesh.size)
    outs = [decode_blocks(c, ln, out_cap, dict_rows=dr, dict_lens=dl)
            for c, ln, (dr, dl) in zip(comp, lens, dicts)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def roundtrip_step(mesh: Mesh, rows, lens, block_bytes: int,
                   acceleration: int = 1) -> Tuple[Shards, Shards, int]:
    """One data-parallel codec step: encode (kernel B) then decode (batch
    D) every row on its device.  ``rows`` are [B, block_bytes] uint8 (the
    JAX package takes packed words).  Returns (comp_lens, decoded_lens,
    bad): ``bad`` counts the rows that did not come back, by length or by
    byte, summed over the shards."""
    rows, lens = _sharded(mesh, rows), _sharded(mesh, lens)
    if any(r.dim() != 2 or r.shape[1] != block_bytes for r in rows):
        raise ValueError(f"rows must be [B, {block_bytes}]")
    bads, clens, olens = [], [], []
    for r, ln in zip(rows, lens):
        comp, clen = encode_blocks(r, ln, acceleration)
        out, olen = decode_blocks(comp, clen, block_bytes)
        cols = torch.arange(block_bytes, device=r.device)
        differs = ((out != r) & (cols[None, :] < ln[:, None])).any(1)
        bads.append(((olen != ln) | differs).sum())
        clens.append(clen)
        olens.append(olen)
    return tuple(clens), tuple(olens), sum(int(b) for b in bads)


def encode_linked_sharded(mesh: Mesh, streams, lens, prefix,
                          acceleration: int = 1, min_match: int = 4
                          ) -> Tuple[Shards, Shards]:
    """Kernel A over the mesh, the stream axis split: ``streams`` [S, L]
    uint8 (row s ``[64 KB window | NB blocks | zeros]``, as
    ``device.linked_stream`` builds it), ``lens`` [S, NB] int32 and
    ``prefix`` [S] int32 (each stream's window length).  Block 0's window
    lanes below the prefix are not zeroed, as in the JAX package's mesh.
    Returns (out [S / n, NB, M], olen [S / n, NB]) blocks."""
    streams, lens = _sharded(mesh, streams), _sharded(mesh, lens)
    prefix = _sharded(mesh, prefix)
    outs = [encode_blocks_linked(s, ln, acceleration, prefix_lens=pf,
                                 min_match=min_match)
            for s, ln, pf in zip(streams, lens, prefix)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def compress_frame_mesh(mesh: Mesh, data: bytes,
                        content_checksum: bool = True,
                        acceleration: int = 1,
                        min_match: int = 4) -> bytes:
    """Compress one blob into one linked LZ4F frame of 64 KB blocks, the
    blocks split over the mesh.

    Shard s takes blocks [s * NB, (s + 1) * NB), NB = ceil(blocks / n), in
    streams of at most CHUNK bytes (4 MB: the candidate tables take about
    82 bytes of device memory per input byte), each behind the 64 KB of
    input before it as its prefix (none before the first byte).  A block's
    payload depends only on its window and itself, so the frame is the
    single stream's, byte for byte: kernel A parses, kernel C packs each
    stream's records, and the host joins them in order behind the header,
    then the endmark and the content checksum.
    """
    data = bytes(data)
    if len(data) >= MAX_STREAM:
        raise ValueError("stream exceeds the linked kernel's 2GB int32 "
                         "position envelope; split into multiple frames")
    nb_total = max(1, -(-len(data) // BLOCK))
    shard_bytes = -(-nb_total // mesh.size) * BLOCK
    pending = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = s * shard_bytes, min((s + 1) * shard_bytes, len(data))
        for a in range(lo, hi, CHUNK):
            pending.append(dispatch_linked(
                data[a:min(a + CHUNK, hi)], data[max(a - BLOCK, 0):a],
                acceleration, min_match, 1, dev))
    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=content_checksum,
                             content_size=len(data))
    body = b"".join(_fetch_body(flat, total, False)
                    for flat, total in pending)
    return _frame(prefs, data, body)


# ---------------------------------------------------------------------------
# scatter-gather lists over the mesh
# ---------------------------------------------------------------------------

def _caps_per(out_caps, n: int, what: str) -> List[List[int]]:
    """One cap list per list or frame: ``out_caps`` is one shared cap list
    or a cap list for each."""
    if out_caps and isinstance(out_caps[0], (list, tuple)):
        caps = [list(map(int, c)) for c in out_caps]
        if len(caps) != n:
            raise ValueError(f"per-{what} out_caps must match the {what}s")
        return caps
    return [list(map(int, out_caps))] * n


def _deal(n: int, mesh: Mesh) -> List[Tuple[torch.device, List[int]]]:
    """Items 0..n-1 dealt over the mesh in contiguous runs of
    ceil(n / mesh size): (device, its items) for each position with any."""
    per = -(-n // mesh.size)
    return [(dev, list(range(i * per, min((i + 1) * per, n))))
            for i, dev in enumerate(mesh.devices) if i * per < n]


def sg_compress_mesh(mesh: Mesh, lists, out_caps, acceleration: int = 1):
    """Compress many independent SG lists, data-parallel over the mesh.

    The lists are bucketed by (buffer-length layout, caps) and each
    bucket's lists are dealt over the mesh; each device walks all its lists
    of the bucket in one launch of kernel G (``sg_encode_chain_batch``),
    and the host replays each list's step records into its wire-exact SG
    frame (``sg.sg_compress``).  ``out_caps`` is one shared cap list or one
    per list.  Returns (total_out, consumed, out_bufs) per list.
    """
    if not lists:
        return []
    caps_per = _caps_per(out_caps, len(lists), "list")
    buckets: dict = {}
    for i, (lst, caps) in enumerate(zip(lists, caps_per)):
        key = (tuple(len(b) for b in lst), tuple(caps))
        buckets.setdefault(key, []).append(i)
    results: list = [None] * len(lists)
    for (_, caps), idxs in buckets.items():
        sub = _sg_compress_bucket(mesh, [lists[i] for i in idxs], list(caps),
                                  acceleration)
        for i, r in zip(idxs, sub):
            results[i] = r
    return results


def sg_bucket_rows(lists, device) -> Tuple[torch.Tensor, np.ndarray]:
    """Lists of one layout as kernel G's batch input: ([L, total + TAIL]
    uint8 rows on ``device``, each a list's content and zeros, and the
    shared input buffer ends).  Raises ValueError for an empty layout or
    content over the chain kernel's envelope, as the JAX package does."""
    layout = [len(b) for b in lists[0]]
    total = sum(layout)
    if total == 0 or total > dsk.MAX_TOTAL:
        raise ValueError("list layout outside the chain kernel envelope")
    rows = np.zeros((len(lists), total + dsk.TAIL), np.uint8)
    for r, lst in enumerate(lists):
        rows[r, :total] = np.frombuffer(b"".join(lst), np.uint8)
    return (to_device(rows, device).reshape(rows.shape),
            np.concatenate([[0], np.cumsum(layout)]))


def _sg_compress_bucket(mesh: Mesh, lists, caps: List[int],
                        acceleration: int):
    """One bucket of sg_compress_mesh: lists of one layout and caps."""
    pending = []
    for dev, idxs in _deal(len(lists), mesh):
        flat, in_ends = sg_bucket_rows([lists[i] for i in idxs], dev)
        pending.append((dev, idxs, dsk.sg_encode_chain_batch(
            flat, in_ends, caps, sum(caps), acceleration)))
    results: list = [None] * len(lists)
    for dev, idxs, (blocks, boff, *recs) in pending:
        # every list's records in one transfer, their blocks in one more
        boff, blen, cons, isz, osz = to_host(torch.stack(
            [boff] + [r.long() for r in recs]))
        live = (blen >= 0).sum(axis=1)
        ends = [int(boff[r, n - 1] + blen[r, n - 1]) if n else 0
                for r, n in enumerate(live)]
        block_rows = to_host(blocks[:, :max(ends)])
        over_h = sg.dest_size_over_h(dev)
        for r, i in enumerate(idxs):
            scripted = sg.sg_scripted_replay(
                block_rows[r, :ends[r]].tobytes(), boff[r], blen[r],
                cons[r], isz[r], osz[r], int(live[r]), over_h)
            results[i] = sg.sg_compress(lists[i], caps,
                                        acceleration=acceleration,
                                        dest_size_compress=scripted)
    return results


def sg_decompress_mesh(mesh: Mesh, comp_lists, out_caps):
    """Decompress many independent SG frames, data-parallel over the mesh.

    Each frame's chain is collected by one host walk (``sg.collect_chain``:
    headers, zero-pads, exact errors); the frames are bucketed by chain
    layout, each bucket dealt over the mesh, and each frame's chain decoded
    by kernel F on its device, all launched before any is read.  A chain
    with a block over 64 KB or content over ``sg.MAX_DEVICE_CONTENT``, or a
    frame whose blocks do not decode to their sizes, goes through
    ``sg.sg_decompress`` on its device (kernels E and D; a corrupt chain
    raises ``sg.SgChainError``).  ``out_caps`` is one shared cap list (the
    original buffer sizes) or one per frame.  Returns (total, out_bufs) per
    frame.
    """
    if not comp_lists:
        return []
    caps_per = _caps_per(out_caps, len(comp_lists), "frame")
    chains = [sg.collect_chain(bufs, caps)
              for bufs, caps in zip(comp_lists, caps_per)]
    buckets: dict = {}
    others = []
    for i, (total, _, sizes) in enumerate(chains):
        if sizes and max(sizes) <= SG_BLOCK_CAP \
                and total <= sg.MAX_DEVICE_CONTENT:
            buckets.setdefault(tuple(sizes), []).append(i)
        else:
            others.append(i)
    pending, placed = [], {}
    for group in buckets.values():
        for dev, ks in _deal(len(group), mesh):
            for k in ks:
                i = group[k]
                _, payloads, sizes = chains[i]
                flat, bstart, clen = join_payloads(payloads, dev)
                pending.append((i, decode_blocks_sg_raw(flat, bstart, clen,
                                                        sizes)))
                placed[i] = dev
    for dev, ks in _deal(len(others), mesh):
        for k in ks:
            placed[others[k]] = dev
    results: list = [None] * len(comp_lists)
    for i, (out, olen) in pending:
        total, _, sizes = chains[i]
        if (to_host(olen) == np.asarray(sizes)).all():
            results[i] = (total, sg.fill_buffers(
                to_host(out[:total]).tobytes(), total, caps_per[i]))
    for i, bufs in enumerate(comp_lists):
        if results[i] is None:
            results[i] = sg.sg_decompress(bufs, caps_per[i],
                                          device=placed[i])
    return results
