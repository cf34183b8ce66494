"""Builds the port's native code at first use and loads it with ctypes.

* The CUDA kernels: every ``lz4_tpu_torch/csrc/*.cu`` goes through one
  ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` call into one
  shared library with a plain C interface (no PyTorch headers, so the build
  takes seconds).  Each C entry point launches its kernel on the stream it
  is given and returns ``cudaGetLastError()``.
* Host helpers compiled with ``cc`` (the one-shot XXH32 of
  ``native/lz4t_native.c`` and the streaming rounds of
  ``csrc/xxh32_stream.c``).

Outputs go to ``build/lz4_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of their sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  A file lock keeps
concurrent processes from building the same library twice.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "lz4_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the kernel entry points (csrc/*.cu); all return cudaError_t
_SIGNATURES = {
    "lz4tt_encode_linked": [_P, _L, _P, _P, _P, _P, _P, _I, _P,
                            _I, _I, _I, _I, _I, _P],
    "lz4tt_encode": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "lz4tt_pack": [_P, _I, _P, _L, _P, _P, _P, _P, _P, _I, _P],
    "lz4tt_decode_linked": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P],
    "lz4tt_decode_batch": [_P, _I, _P, _P, _P, _I, _P, _I, _P],
}

_kernels = None


class BuildError(RuntimeError):
    pass


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _digest(paths: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_shared(stem: str, inputs: Sequence[Path], flags: Sequence[str],
                 command: Callable[[Path], List[str]]) -> Path:
    """Build ``command(out_path)`` into BUILD_DIR unless a library for the
    same ``inputs`` and ``flags`` exists; returns the library's path."""
    out = BUILD_DIR / f"{stem}_{_digest(inputs, flags)}.so"
    with _build_lock():
        if out.exists():
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = command(tmp)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"build of {stem} failed ({' '.join(cmd)}):\n"
                             f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    return out


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def kernels_lib() -> ctypes.CDLL:
    """The loaded kernel library, built from csrc/ on the first call."""
    global _kernels
    if _kernels is None:
        sources = sorted(CSRC.glob("*.cu"))
        inputs = sorted(CSRC.glob("*.cu*"))
        nvcc = find_nvcc()
        path = build_shared(
            "lz4tt_kernels", inputs, NVCC_FLAGS,
            lambda out: [nvcc, *NVCC_FLAGS, "-o", str(out),
                         *map(str, sources)])
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernels = lib
    return _kernels


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")
