"""Distribution over processes: one process per card, on torch.distributed.

Counterpart of ``lz4_tpu/parallel/multihost.py``.  Every process calls
:func:`initialize` (NCCL on cards, gloo on the CPU), takes its contiguous
slice of the blocks (``process_block_range``), runs the kernels on its own
device, and the only traffic between processes is an all-gather of the
compressed (or decoded) lengths, so that every process knows where every
block lies in the frame: compressed sizes depend on the data, and ordered
assembly needs them.  Payload bytes never leave their process: each writes
its own segment of the frame (``frame_segment``), and the segments joined
in rank order, behind one header, are one block-independent frame.

A process's rows lie on its device as one tensor; ``global_blocks`` gives
their global offset.  The rows of each process may differ in number: the
lengths are padded to the longest process's for the gather.

The rendezvous is whatever ``init_method`` names; the tests and
``chip_smoke.py`` use a ``file://`` store, which needs no network port.
"""

from __future__ import annotations

import struct
import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.common import resolve_device, to_host
from ..kernels.decode_kernel import decode_blocks
from ..kernels.encode_kernel import encode_blocks
from .mesh import Mesh

__all__ = [
    "initialize", "local_device", "global_mesh", "process_block_range",
    "global_blocks", "encode_blocks_multihost", "decode_blocks_multihost",
    "decoded_segment", "frame_segment",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(init_method: str, world_size: int, rank: int,
               backend=None, device="cuda") -> torch.device:
    """Join the process group; returns this process's device.

    The backend follows the device: NCCL for ``"cuda"`` (this process takes
    card ``rank % torch.cuda.device_count()`` first, so run one process per
    card: NCCL refuses two ranks on one card), gloo for ``"cpu"``.
    """
    dev = resolve_device(device)
    want = _BACKENDS[dev.type]
    if backend is not None and backend != want:
        raise ValueError(f"device {dev.type!r} runs on {want}, not "
                         f"{backend!r}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(want, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def local_device() -> torch.device:
    """This process's device: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh() -> Mesh:
    """The world as a mesh, one position per rank, each rank's device as
    its own process sees it (the card of its index on a host of one process
    per card)."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        count = torch.cuda.device_count()
        return Mesh(tuple(torch.device("cuda", r % count)
                          for r in range(world)))
    return Mesh((torch.device("cpu"),) * world)


def process_block_range(n_blocks: int) -> Tuple[int, int]:
    """The contiguous [lo, hi) slice of ``n_blocks`` that this process
    takes."""
    pc, pid = dist.get_world_size(), dist.get_rank()
    per = -(-n_blocks // pc)
    lo = min(pid * per, n_blocks)
    return lo, min(lo + per, n_blocks)


def _all_gather(out: torch.Tensor, local: torch.Tensor) -> None:
    with warnings.catch_warnings():
        # newer releases name it all_gather_single; the card host's may not
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, local)


def _gather_ints(local: torch.Tensor) -> np.ndarray:
    """Every rank's 1-D integer tensor, joined in rank order (int64 numpy):
    their sizes are gathered first, then the values padded to the longest,
    each gather on the backend's device."""
    world = dist.get_world_size()
    cdev = local_device()
    local = local.reshape(-1).to(cdev, torch.int64)
    counts = torch.empty((world,), dtype=torch.int64, device=cdev)
    _all_gather(counts, torch.tensor([local.numel()], dtype=torch.int64,
                                     device=cdev))
    counts = counts.tolist()
    width = max(max(counts), 1)
    padded = torch.zeros((width,), dtype=torch.int64, device=cdev)
    padded[:local.numel()] = local
    out = torch.empty((world * width,), dtype=torch.int64, device=cdev)
    _all_gather(out, padded)
    out = to_host(out).reshape(world, width)
    return np.concatenate([out[r, :c] for r, c in enumerate(counts)])


def global_blocks(mesh: Mesh, local_rows) -> Tuple[torch.Tensor, int]:
    """This process's rows (a tensor or numpy array [b, W]) on its device,
    and the global index of its first row: the rows of the ranks before
    it.  Every process must call it."""
    dev = mesh.devices[dist.get_rank()]
    if isinstance(local_rows, np.ndarray):     # a writable copy if need be
        local_rows = torch.from_numpy(np.require(local_rows,
                                                 requirements="CW"))
    rows = local_rows.to(dev).contiguous()
    sizes = _gather_ints(torch.tensor([rows.shape[0]]))
    return rows, int(sizes[:dist.get_rank()].sum())


def encode_blocks_multihost(mesh: Mesh, rows: torch.Tensor,
                            lens: torch.Tensor, acceleration: int = 1,
                            min_match: int = 4):
    """Kernel B on this process's rows ([b, NS] uint8, [b] int32 lengths,
    on its device); the compressed lengths are all-gathered.  Returns
    (comp rows [b, M] on this device, every rank's lengths as int64 numpy
    [B] in rank order)."""
    comp, clen = encode_blocks(rows, lens, acceleration, min_match=min_match)
    return comp, _gather_ints(clen)


def decode_blocks_multihost(mesh: Mesh, comp: torch.Tensor,
                            clens: torch.Tensor, out_cap: int):
    """Kernel D's batch mode on this process's blocks; the decoded lengths
    are all-gathered.  Returns (out rows [b, out_cap] on this device, every
    rank's lengths as int64 numpy [B], -1 for a malformed block)."""
    out, olen = decode_blocks(comp, clens, out_cap)
    return out, _gather_ints(olen)


def _check_range(rows: torch.Tensor, lo: int, hi: int) -> None:
    if rows.shape[0] != hi - lo:
        raise ValueError(f"rows hold {rows.shape[0]} blocks, not the "
                         f"{hi - lo} of [{lo}, {hi})")


def decoded_segment(out_rows: torch.Tensor, olen: np.ndarray, lo: int,
                    hi: int) -> bytes:
    """This process's decoded bytes for blocks [lo, hi) (row j of
    ``out_rows`` is block lo + j), in order: its segment of the content.
    Blocks with ``olen <= 0`` write nothing."""
    _check_range(out_rows, lo, hi)
    n = olen[lo:hi]
    if not (n > 0).any():
        return b""
    rows = to_host(out_rows[:, :int(n.max())])
    return b"".join(rows[j, :k].tobytes() for j, k in enumerate(n) if k > 0)


def frame_segment(comp_rows: torch.Tensor, lens: np.ndarray,
                  block_lens: Sequence[int], lo: int, hi: int) -> bytes:
    """This process's blocks [lo, hi) (row j of ``comp_rows`` is block
    lo + j) as frame bytes, block headers and payloads: its segment of the
    one block-independent frame.  Empty blocks write nothing; a block that
    does not shrink raises ValueError (the stored fallback needs the
    plaintext, which the caller holds)."""
    _check_range(comp_rows, lo, hi)
    parts: List[bytes] = []
    rows = None
    for j, g in enumerate(range(lo, hi)):
        if int(block_lens[g]) == 0:
            continue
        clen = int(lens[g])
        if clen >= int(block_lens[g]):
            raise ValueError("stored-block fallback needs plaintext; "
                             "caller handles incompressible rows")
        if rows is None:
            rows = to_host(comp_rows)
        parts.append(struct.pack("<I", clen) + rows[j, :clen].tobytes())
    return b"".join(parts)
