"""The traffic generators: the same seed gives the same bytes, another
seed other bytes, and every seed the same sizes."""

import json

import numpy as np
import pytest

from codecbench.cells import HERE, generator

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def make_objects(params: dict, seed: int) -> list:
    return generator(params)(params, seed)


def small(mix: str) -> dict:
    """The mix at 1/32 of its object size, segments scaled alike."""
    t = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    return dict(t, object_MiB=t["object_MiB"] / 32,
                segment_MiB=t["segment_MiB"] / 32)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_bytes(mix):
    t = small(mix)
    a = make_objects(t, 2**31 + 11)
    assert a == make_objects(t, 2**31 + 11)
    assert len(a) == t["pool"] >= 2
    assert all(len(o) == int(t["object_MiB"] * 2**20) for o in a)
    assert a[0] != a[1]


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_bytes(mix):
    t = small(mix)
    assert make_objects(t, 5) != make_objects(t, 6)


def test_seeds_past_32_bits_and_negative():
    t = small("text64m.rw")
    assert make_objects(t, 2**40 + 3) != make_objects(t, 3)
    assert make_objects(t, -7) == make_objects(t, -7)


def test_noise_share_is_exact_for_every_seed():
    t = {"generator": "stdlib_text", "object_MiB": 1, "pool": 2,
         "segment_MiB": 1 / 16, "noise_share": 0.5, "reads_per_write": 1}
    seg = 1 << 16
    for seed in (1, 2, 3, 2**33):
        for obj in make_objects(t, seed):
            arr = np.frombuffer(obj, np.uint8).reshape(16, seg)
            # text is 7-bit ASCII in the main; noise has high bytes
            noisy = (arr >= 128).mean(axis=1) > 0.3
            assert noisy.sum() == 8
