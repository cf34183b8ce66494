"""XXH32, as the xxHash specification (XXH32, version 0.1.1) defines it.

Plain Python integers over ``struct.iter_unpack``: about 8 s per 64 MiB on
one core, which is why the benchmark hashes its objects in worker processes
after the measured window.
"""

import struct

P1, P2, P3, P4, P5 = (2654435761, 2246822519, 3266489917, 668265263,
                      374761393)
M = 0xFFFFFFFF


def xxh32(data, seed: int = 0) -> int:
    """XXH32 of ``data`` (any buffer) with ``seed``."""
    view = memoryview(data).cast("B")
    n = len(view)
    seed &= M
    end = n - n % 16
    if n >= 16:
        v1, v2 = (seed + P1 + P2) & M, (seed + P2) & M
        v3, v4 = seed, (seed - P1) & M
        for a, b, c, d in struct.iter_unpack("<4I", view[:end]):
            v1 = (v1 + a * P2) & M
            v1 = (((v1 << 13) | (v1 >> 19)) * P1) & M
            v2 = (v2 + b * P2) & M
            v2 = (((v2 << 13) | (v2 >> 19)) * P1) & M
            v3 = (v3 + c * P2) & M
            v3 = (((v3 << 13) | (v3 >> 19)) * P1) & M
            v4 = (v4 + d * P2) & M
            v4 = (((v4 << 13) | (v4 >> 19)) * P1) & M
        h = (((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25))
             + ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14))) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    p = end
    while p + 4 <= n:
        (k,) = struct.unpack_from("<I", view, p)
        h = (h + k * P3) & M
        h = ((((h << 17) | (h >> 15)) & M) * P4) & M
        p += 4
    while p < n:
        h = (h + view[p] * P5) & M
        h = ((((h << 11) | (h >> 21)) & M) * P1) & M
        p += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h
