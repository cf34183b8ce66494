"""Seeded synthetic compressible-data generator.

Counterpart of ``lz4_tpu/utils/datagen.py``, numpy only: the same bytes for
the same arguments.  Capability parity with the reference's test-data generator
(``programs/datagen.c:136-198``): reproducible from a seed, a tunable
match probability controlling compressibility, matches drawn from a
32 KB window, literals from a skewed alphabet.  The exact byte stream is
our own design (we only need determinism + realistic LZ structure; both
sides of every interop benchmark consume the same generated file).
"""

from __future__ import annotations

import numpy as np

WINDOW = 32 * 1024


class _Lcg:
    """Deterministic 32-bit LCG (same role as FUZ_rand, fuzzer.c:152-158)."""

    def __init__(self, seed: int):
        self.state = (seed * 2654435761 + 2246822519) & 0xFFFFFFFF

    def next(self) -> int:
        self.state = (self.state * 2654435761 + 2246822519) & 0xFFFFFFFF
        return (self.state >> 5) & 0x7FFFFFFF


def gen_buffer(size: int, proba: float = 0.70, seed: int = 42) -> bytes:
    """Generate ``size`` bytes; ``proba`` = probability a segment is a match.

    Higher proba => more matches => more compressible (reference datagen's
    ``-P`` knob, programs/datagencli.c).
    """
    rng = _Lcg(seed)
    out = bytearray()
    # skewed literal alphabet: 32 symbols, triangular-ish distribution
    alphabet = bytes((ord("a") + (i * i // 40)) % 256 for i in range(32))
    p_threshold = int(proba * 1024)
    while len(out) < size:
        if (rng.next() & 1023) < p_threshold and len(out) >= 4:
            # match segment
            length = 4 + (rng.next() & 31)
            offset = 1 + rng.next() % min(len(out), WINDOW)
            pos = len(out) - offset
            take = min(length, size - len(out))
            for _ in range(take):
                out.append(out[pos])
                pos += 1
        else:
            # literal segment
            length = 1 + (rng.next() & 15)
            take = min(length, size - len(out))
            for _ in range(take):
                out.append(alphabet[rng.next() & 31])
    return bytes(out)


def gen_buffer_np(size: int, proba: float = 0.70, seed: int = 42,
                  chunk: int = 1 << 20) -> bytes:
    """Large-buffer variant: stitches independently-seeded chunks.

    Chunks are generated by :func:`gen_buffer`; compressibility is
    equivalent, generation is O(size) python-loop per chunk but chunks can
    be cached/reused.  Used by bench for multi-MB corpora.
    """
    parts = []
    remaining = size
    i = 0
    while remaining > 0:
        n = min(chunk, remaining)
        parts.append(gen_buffer(n, proba, seed + i))
        remaining -= n
        i += 1
    return b"".join(parts)


def incompressible(size: int, seed: int = 7) -> bytes:
    """Pure-noise buffer (tests the stored/passthrough paths)."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size, dtype=np.uint8).tobytes()
