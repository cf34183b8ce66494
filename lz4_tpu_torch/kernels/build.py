"""Builds the port's native code at first use and loads it with ctypes.

* The CUDA kernels: every ``lz4_tpu_torch/csrc/*.cu`` is compiled by its
  own ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c``, all started
  together, and one ``nvcc -shared`` links the objects into one shared
  library with a plain C interface (no PyTorch headers, so the build takes
  seconds).  Each C entry point launches its kernels on the stream it is
  given and returns ``cudaGetLastError()``.
* Host helpers compiled with ``cc`` (the one-shot XXH32 and the streaming
  rounds of ``csrc/xxh32_stream.c``).

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
import tempfile
from pathlib import Path
from typing import Callable, List, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "lz4_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
# C signatures of the kernel entry points (csrc/*.cu); all return cudaError_t
_SIGNATURES = {
    "lz4tt_encode_linked": [_P, _L, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                            _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I,
                            _P],
    "lz4tt_encode": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I,
                     _P, _I, _P, _I, _I, _I, _I, _P],
    "lz4tt_encode_hc": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I,
                        _I, _P],
    "lz4tt_pack": [_P, _I, _P, _L, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                   _P],
    "lz4tt_decode_linked": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I,
                            _P, _P],
    "lz4tt_decode_batch": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                           _I, _I, _P, _P, _P, _I, _P, _P],
    "lz4tt_decode_stream": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "lz4tt_decode_stream_spans": [_P, _P, _I, _P, _P, _I, _I, _L, _L, _P,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "lz4tt_decode_sg": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                        _P],
    "lz4tt_sg_encode_chain": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P],
    "lz4tt_sg_encode_chain_batch": [_P, _L, _I, _P, _I, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _P, _L, _P, _P, _P],
    "lz4tt_encode_dest_size": [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                               _I, _P],
    "lz4tt_xxh32_rows": [_P, _L, _P, _I, _U32, _P, _I, _P],
    "lz4tt_xxh64_rows": [_P, _L, _P, _I, _U64, _P, _I, _P],
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


def _run_together(stem: str, cmds: Sequence[List[str]]) -> None:
    """Start every command at once, wait for all, and raise with the
    output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise BuildError(f"build of {stem} failed ({' '.join(cmd)}):\n"
                             f"{out}\n{err}")


def build_shared(stem: str, inputs: Sequence[Path], flags: Sequence[str],
                 commands: Callable[[Path], List[List[str]]]) -> Path:
    """Build a library into BUILD_DIR unless one for the same ``inputs`` and
    ``flags`` exists; returns its path.  ``commands(tmp)`` lists the
    commands that write it to ``tmp``, in a scratch directory of their own:
    all but the last (one compile per source) start together, and the last
    (the link) runs once they have all succeeded."""
    out = BUILD_DIR / f"{stem}_{_digest(inputs, flags)}.so"
    with _build_lock():
        if out.exists():
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = Path(work) / out.name
            *compiles, link = commands(tmp)
            _run_together(stem, compiles)
            _run_together(stem, [link])
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

        def commands(out: Path) -> List[List[str]]:
            objs = [str(out.with_name(s.stem + ".o")) for s in sources]
            return [*([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                      for s, o in zip(sources, objs)),
                    [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *objs]]

        path = build_shared("lz4tt_kernels", inputs, NVCC_FLAGS, commands)
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
