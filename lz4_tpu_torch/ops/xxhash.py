"""Host XXH32 for the frame layer: header checksum byte, block and content
checksums.

Counterpart of ``lz4_tpu/ops/xxhash_np.py`` and ``xxhash_native.py``.  The
one-shot hash and the stripe rounds of the streaming state come from the
port's own ``csrc/xxh32_stream.c``, compiled with ``cc`` into a library in
the port's build directory at first use; without a compiler both fall back
to the pure-Python code below.
"""

from __future__ import annotations

import ctypes
import shutil

from ..kernels import build

M32 = 0xFFFFFFFF
P32_1 = 2654435761
P32_2 = 2246822519
P32_3 = 3266489917
P32_4 = 668265263
P32_5 = 374761393

_NATIVE_SRCS = [build.CSRC / "xxh32_stream.c"]
_native = None
_native_tried = False


def _load_native():
    global _native, _native_tried
    if not _native_tried:
        _native_tried = True
        cc = shutil.which("cc")
        if cc is not None and all(p.exists() for p in _NATIVE_SRCS):
            flags = ["-O3", "-fPIC", "-shared"]
            try:
                path = build.build_shared(
                    "lz4tt_xxh32", _NATIVE_SRCS, flags,
                    lambda out: [[cc, *flags, *map(str, _NATIVE_SRCS), "-o",
                                  str(out)]])
                lib = ctypes.CDLL(str(path))
            except (build.BuildError, OSError):
                return None
            lib.lz4tt_xxh32.restype = ctypes.c_uint32
            lib.lz4tt_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_uint32]
            lib.lz4tt_xxh32_stripes.restype = ctypes.c_size_t
            lib.lz4tt_xxh32_stripes.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
                ctypes.c_size_t]
            _native = lib
    return _native


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _round32(acc: int, lane: int) -> int:
    return (_rotl32((acc + lane * P32_2) & M32, 13) * P32_1) & M32


def _finish32(h: int, tail: bytes) -> int:
    i, n = 0, len(tail)
    while i + 4 <= n:
        word = int.from_bytes(tail[i:i + 4], "little")
        h = (_rotl32((h + word * P32_3) & M32, 17) * P32_4) & M32
        i += 4
    while i < n:
        h = (_rotl32((h + tail[i] * P32_5) & M32, 11) * P32_1) & M32
        i += 1
    h ^= h >> 15
    h = (h * P32_2) & M32
    h ^= h >> 13
    h = (h * P32_3) & M32
    return h ^ (h >> 16)


class XXH32State:
    """Streaming XXH32 (reset/update/digest)."""

    def __init__(self, seed: int = 0):
        self.seed = seed & M32
        self.v = [(seed + P32_1 + P32_2) & M32, (seed + P32_2) & M32,
                  seed & M32, (seed - P32_1) & M32]
        self.buf = b""
        self.total = 0

    def update(self, data: bytes) -> None:
        data = self.buf + bytes(data) if self.buf else bytes(data)
        self.total += len(data) - len(self.buf)
        lib = _load_native()
        if lib is not None:
            v = (ctypes.c_uint32 * 4)(*self.v)
            i = lib.lz4tt_xxh32_stripes(v, data, len(data))
            self.v = list(v)
        else:
            v1, v2, v3, v4 = self.v
            i, lim = 0, len(data) - 16
            while i <= lim:
                v1 = _round32(v1, int.from_bytes(data[i:i + 4], "little"))
                v2 = _round32(v2, int.from_bytes(data[i + 4:i + 8], "little"))
                v3 = _round32(v3, int.from_bytes(data[i + 8:i + 12],
                                                 "little"))
                v4 = _round32(v4, int.from_bytes(data[i + 12:i + 16],
                                                 "little"))
                i += 16
            self.v = [v1, v2, v3, v4]
        self.buf = data[i:]

    def digest(self) -> int:
        if self.total >= 16:
            v1, v2, v3, v4 = self.v
            h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
                 + _rotl32(v4, 18)) & M32
        else:
            h = (self.seed + P32_5) & M32
        return _finish32((h + self.total) & M32, self.buf)


def xxh32(data: bytes, seed: int = 0) -> int:
    """One-shot XXH32 of ``data``."""
    data = bytes(data)
    lib = _load_native()
    if lib is not None:
        return lib.lz4tt_xxh32(data, len(data), seed & M32)
    st = XXH32State(seed)
    st.update(data)
    return st.digest()
