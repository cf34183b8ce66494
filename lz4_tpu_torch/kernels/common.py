"""Byte layer shared by the port's kernels.

Counterpart of ``lz4_tpu/kernels/common.py`` and the host<->device helpers
of ``lz4_tpu/tpu.py``.  The port keeps bytes as ``torch.uint8`` tensors
throughout; the JAX package's int32 byte lanes and val32 rows exist only at
the ``from_jax_lanes``/``to_jax_lanes`` boundary that the tests use.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one per launch on
the card) and the calls of its plain PyTorch version in ``PLAIN_CALLS``, so
a run can show which path it took.  The counters live in
``lz4_tpu_torch.trace`` beside ``COUNTS``; ``to_device``, ``ints_to_device``
and ``to_host`` count their bytes and waits there, each a ``link`` span.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..trace import (COUNTS, LAUNCHES, PLAIN_CALLS,  # noqa: F401
                     reset_counts, span)


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA device without a card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the card (launch the kernel), False
    when they lie on the CPU (take the plain version); mixed or other
    devices raise."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if len(devices) == 1 and kinds <= {"cuda", "cpu"}:
        return kinds == {"cuda"}
    raise ValueError(f"tensors on mixed or unsupported devices: {devices}")


def on_device(dev: torch.device):
    """Context in which card ``dev`` is the current CUDA device.  Every C
    entry point is called inside it, with its tensors' device: the entry
    points launch on the current device (with the stream of ``dev``) and
    read per-device attributes there, so tensors on ``cuda:1`` must not
    launch on card 0."""
    return torch.cuda.device(dev)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel argument: dtype, rank and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _copy_to(t: torch.Tensor, dev) -> torch.Tensor:
    """A blocking copy of host tensor ``t`` to ``dev``, counted: a blocking
    copy waits for the device's stream first."""
    COUNTS["h2d_bytes"] += t.numel() * t.element_size()
    COUNTS["syncs"] += 1
    return t.to(dev, copy=True)


def to_device(data, device) -> torch.Tensor:
    """bytes / uint8 numpy array -> 1-D uint8 tensor on ``device`` (always
    a copy, never a view of the caller's buffer)."""
    with span("link"):
        dev = resolve_device(device)
        with warnings.catch_warnings():
            # read-only buffers are copied right below, never written
            warnings.simplefilter("ignore", UserWarning)
            if isinstance(data, np.ndarray):
                view = torch.from_numpy(
                    np.ascontiguousarray(data, dtype=np.uint8).reshape(-1))
            elif len(data):
                view = torch.frombuffer(data, dtype=torch.uint8)
            else:
                view = torch.empty((0,), dtype=torch.uint8)
        return _copy_to(view, dev)


def ints_to_device(values, dev, dtype=torch.int32) -> torch.Tensor:
    """Host integers (nested lists or a numpy array) -> a ``dtype`` tensor
    on ``dev``, copied and counted as ``to_device`` copies."""
    with span("link"):
        return _copy_to(torch.as_tensor(values, dtype=dtype), dev)


def to_host(t: torch.Tensor) -> np.ndarray:
    """uint8 tensor -> numpy array on the host."""
    with span("link"):
        COUNTS["d2h_bytes"] += t.numel() * t.element_size()
        COUNTS["syncs"] += 1
        return t.detach().to("cpu").numpy()


def le32_lanes(u8: torch.Tensor) -> torch.Tensor:
    """[..., L] uint8 -> [..., L-3] int32 LE32 words: lane p is the
    little-endian word of bytes p..p+3 (the JAX package's val32 lane)."""
    x = u8.to(torch.int64)
    w = (x[..., :-3] | (x[..., 1:-2] << 8) | (x[..., 2:-1] << 16)
         | (x[..., 3:] << 24))
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def from_jax_lanes(a) -> torch.Tensor:
    """numpy int32 byte lanes or val32 rows -> uint8 tensor (on the CPU):
    the low byte of each lane is its byte."""
    return torch.from_numpy(np.asarray(a).astype(np.uint8))


def to_jax_lanes(t: torch.Tensor) -> np.ndarray:
    """uint8 tensor -> numpy int32 byte lanes (one byte per lane)."""
    return to_host(t).astype(np.int32)
