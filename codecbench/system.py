"""The system under test: the port's frame entry points, as a configuration
names them.

A configuration (``configs/<name>.json``) gives the frame settings
(``frame``: block size id, block independence, checksums, content size),
the compress and decompress entry points of ``lz4_tpu_torch.device`` with
their keyword arguments, and a ``control``: the frame settings that break
one guarantee the configuration states, for the control runs of
``control.py``.  Each call takes bytes in host memory and returns bytes in
host memory.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple


class System:
    """The port's entry points for one configuration on one device."""

    def __init__(self, config: dict, device: str, control: bool = False):
        from lz4_tpu_torch import device as port
        from lz4_tpu_torch.frame import FramePreferences

        frame = dict(config["frame"])
        if control:
            frame.update(config["control"]["frame"])
        self.prefs = FramePreferences(
            block_size_id=frame["block_size_id"],
            block_independent=frame["block_independent"],
            block_checksum=frame["block_checksum"],
            content_checksum=frame["content_checksum"])
        self.device = device
        self._compress = getattr(port, config["compress"]["entry"])
        self._compress_kw = dict(config["compress"]["kwargs"])
        self._decompress = getattr(port, config["decompress"]["entry"])
        self._decompress_kw = dict(config["decompress"]["kwargs"])

    def compress(self, data: bytes) -> bytes:
        return self._compress(data, dataclasses.replace(self.prefs),
                              device=self.device, **self._compress_kw)

    def decompress(self, frame: bytes) -> Tuple[bytes, int]:
        """(content, bytes of ``frame`` consumed)."""
        return self._decompress(frame, device=self.device,
                                **self._decompress_kw)

    def csrc(self) -> Path:
        """The port's CUDA sources, for the names of its kernels."""
        import lz4_tpu_torch
        return Path(lz4_tpu_torch.__file__).resolve().parent / "csrc"

    def xxh32_kind(self) -> str:
        """Which XXH32 the port's frame layer runs on the host."""
        from lz4_tpu_torch.ops import xxhash
        return "native" if xxhash._load_native() is not None \
            else "pure Python"
