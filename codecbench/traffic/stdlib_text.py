"""A traffic generator: a cell's pool of objects of stdlib text, with a
share of seeded noise, from a traffic mix that names it
(``"generator": "stdlib_text"`` in ``traffic/<mix>.json``) and the run's
seed.

The mix's parameters:

* ``object_MiB``: the size of each object;
* ``pool``: how many distinct objects the window cycles through, so that two
  calls in a row never see the same bytes;
* ``segment_MiB`` and ``noise_share``: each object is made of segments of
  this size, and exactly this share of them (rounded) are seeded random
  bytes, which stand for data that is already compressed; the others are
  text.  Every seed gets the same number of noise segments, in another
  order;
* ``reads_per_write`` (read by the window, not here): how many times the
  window decompresses each frame after it has compressed the object (0:
  compress only).

Text is the CPython standard library's ``.py`` sources on the run's host,
each object's in a file order of its own drawn from the seed, concatenated
and repeated as needed; each text segment is a slice of it at a seeded
offset.  LZ4's window is 64 KB, so a repeat far back does not change the
parse.  The work of a decode depends a little on how the files fall into
the kernels' groups of blocks, so a pool of several objects, each in its
own order, averages that out within a run.
"""

from __future__ import annotations

import sysconfig
from pathlib import Path
from typing import List

import numpy as np

MIB = 1 << 20


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream label."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def stdlib_sources() -> List[Path]:
    root = Path(sysconfig.get_paths()["stdlib"])
    return sorted(root.rglob("*.py"))


def stdlib_texts() -> List[bytes]:
    """The stdlib's sources, in sorted order of their paths."""
    texts = []
    for path in stdlib_sources():
        try:
            texts.append(path.read_bytes())
        except OSError:
            continue
    if not any(texts):
        raise RuntimeError("no stdlib sources to make text from")
    return texts


def make_objects(params: dict, seed: int) -> List[bytes]:
    """The pool of objects of a traffic mix for ``seed``."""
    size = int(params["object_MiB"] * MIB)
    seg = int(params.get("segment_MiB", params["object_MiB"]) * MIB)
    if seg <= 0 or size % seg:
        raise ValueError("object_MiB must be a multiple of segment_MiB")
    nseg = size // seg
    nnoise = round(params.get("noise_share", 0.0) * nseg)
    texts = stdlib_texts()
    objects = []
    for k in range(int(params["pool"])):
        rng = rng_for(seed, 2, k)
        corpus = b"".join(texts[i] for i in rng.permutation(len(texts)))
        # repeated far enough that a segment may start anywhere in it
        looped = corpus * -(-(len(corpus) + seg) // len(corpus))
        noise = np.zeros(nseg, dtype=bool)
        noise[rng.permutation(nseg)[:nnoise]] = True
        parts = []
        for is_noise in noise:
            if is_noise:
                parts.append(rng.bytes(seg))
            else:
                start = int(rng.integers(len(corpus)))
                parts.append(looped[start:start + seg])
        objects.append(b"".join(parts))
    return objects
