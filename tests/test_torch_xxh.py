"""The port's batched checksums (kernels J and K) against lz4_tpu's, on the
CPU: ``xxh32_batch`` and ``xxh64_batch`` on CPU tensors (the numpy plain
versions) against the JAX functions (their stripe kernels in interpret
mode) and against the reference one-shot hashes, every digest equal; and
the models of the card's staging (``xxh32_rows_tiled_plain``,
``xxh64_rows_tiled_plain``: rows copied in tiles from the 16-byte granule
of their first byte) against both, at every start offset in a granule.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.xxh32_kernel import xxh32_batch as jax_xxh32_batch
from lz4_tpu.kernels.xxh64_kernel import xxh64_batch as jax_xxh64_batch
from lz4_tpu.ops.xxhash_np import xxh32 as xxh32_np
from lz4_tpu.ops.xxhash_np import xxh64 as xxh64_np
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch.kernels.xxh32_kernel import (NARROW, NSTAGE, ROOM, TILE,
                                                narrow_rows, xxh32_batch,
                                                xxh32_rows_narrow_plain,
                                                xxh32_rows_plain,
                                                xxh32_rows_tiled_plain)
from lz4_tpu_torch.kernels.xxh64_kernel import (xxh64_batch,
                                                xxh64_rows_narrow_plain,
                                                xxh64_rows_plain,
                                                xxh64_rows_tiled_plain)
from lz4_tpu_torch.ops.xxhash import xxh32 as port_host_xxh32

LENGTHS = [0, 1, 3, 4, 5, 15, 16, 17, 31, 32, 63, 64, 100, 1000, 4096,
           65536, 65537, 100001]
SEEDS32 = [0, 1, 0x9E3779B1, (1 << 63) + 12345]
SEEDS64 = [0, 1, 0xDEADBEEF, 0x9E3779B1, (1 << 63) + 12345]
REPO = Path(__file__).resolve().parent.parent
TILES = (64, TILE)          # a small tile, and the kernels' own
# kernel -> (its staging model, its plain version, lz4_tpu's batch, seed
# mask, the model of its narrow path)
MODELS = {"xxh32": (xxh32_rows_tiled_plain, xxh32_rows_plain,
                    jax_xxh32_batch, 0xFFFFFFFF, xxh32_rows_narrow_plain),
          "xxh64": (xxh64_rows_tiled_plain, xxh64_rows_plain,
                    jax_xxh64_batch, (1 << 64) - 1, xxh64_rows_narrow_plain)}


def rows_of(bufs, pad=0):
    """([B, N] uint8 tensor, [B] int32 tensor) for the port; ``pad`` widens
    the rows past the longest buffer."""
    N = max((len(b) for b in bufs), default=0) + pad
    arr = np.zeros((len(bufs), N), np.uint8)
    for i, b in enumerate(bufs):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(arr), torch.tensor([len(b) for b in bufs],
                                               dtype=torch.int32)


def jax_digests(fn, bufs, seed):
    W = max(-(-max((len(b) for b in bufs), default=1) // 4), 1) * 4
    packed, lens = np_pack_rows(bufs, W)
    return fn(packed, lens, seed)


def check32(bufs, seed, pad=0):
    got = xxh32_batch(*rows_of(bufs, pad), seed)
    assert got.dtype == np.uint32 and got.shape == (len(bufs),)
    # lz4_tpu's kernel takes a 32-bit seed
    np.testing.assert_array_equal(
        got, jax_digests(jax_xxh32_batch, bufs, seed & 0xFFFFFFFF))
    for b, g in zip(bufs, got):
        assert int(g) == xxh32_np(b, seed & 0xFFFFFFFF), len(b)
    return got


def check64(bufs, seed, pad=0):
    got = xxh64_batch(*rows_of(bufs, pad), seed)
    assert got.dtype == np.uint64 and got.shape == (len(bufs),)
    np.testing.assert_array_equal(got, jax_digests(jax_xxh64_batch, bufs,
                                                   seed))
    for b, g in zip(bufs, got):
        assert int(g) == xxh64_np(b, seed), len(b)
    return got


@pytest.mark.parametrize("seed", SEEDS32)
def test_xxh32_lengths_match_jax(seed):
    bufs = [gen_buffer(n, 0.6, n + 1) if n else b"" for n in LENGTHS]
    bufs += [incompressible(n) for n in (7, 50, 5000)]
    check32(bufs, seed)


@pytest.mark.parametrize("seed", SEEDS64)
def test_xxh64_lengths_match_jax(seed):
    bufs = [gen_buffer(n, 0.6, n + 1) if n else b"" for n in LENGTHS]
    bufs += [incompressible(n) for n in (7, 50, 5000)]
    check64(bufs, seed)


@pytest.mark.parametrize("pad", [0, 5])
def test_xxh32_every_tail_length_matches_jax(pad):
    base = gen_buffer(200, 0.5, 1)
    check32([base[:n] for n in range(0, 70)], 0, pad)
    check32([base[:n] for n in range(0, 70)], 0x9E3779B1, pad)


@pytest.mark.parametrize("pad", [0, 5])
def test_xxh64_every_tail_length_matches_jax(pad):
    base = gen_buffer(200, 0.5, 1)
    check64([base[:n] for n in range(0, 70)], 0, pad)
    check64([base[:n] for n in range(0, 70)], (1 << 63) + 12345, pad)


def test_xxh32_large_batch_matches_jax():
    check32([gen_buffer(512 + 13 * i, 0.7, i) for i in range(200)], 0)


def test_xxh64_large_batch_matches_jax():
    check64([gen_buffer(512 + 13 * i, 0.7, i) for i in range(200)], 0)


@pytest.mark.parametrize("seed", SEEDS64)
def test_ragged_batches_match_jax(seed):
    rng = random.Random(7)
    bufs = [gen_buffer(rng.randint(0, 5000), rng.uniform(0.3, 0.9), i)
            for i in range(40)]
    check32(bufs, seed)
    check64(bufs, seed)


def test_xxh32_equals_the_ports_host_hash():
    """The batched digest of a row is the frame path's host XXH32 of it."""
    bufs = [gen_buffer(n, 0.7, n) for n in (0, 1, 15, 16, 4096, 65536)]
    for seed in (0, 0x9E3779B1):
        got = xxh32_batch(*rows_of(bufs), seed)
        assert [int(g) for g in got] == [port_host_xxh32(b, seed)
                                         for b in bufs]


def test_lengths_are_clamped_and_arguments_checked():
    rows, _ = rows_of([bytes(range(40))] * 3)
    lens = torch.tensor([-4, 40, 1000], dtype=torch.int32)
    assert [int(x) for x in xxh32_batch(rows, lens, 3)] == [
        xxh32_np(b"", 3), xxh32_np(bytes(range(40)), 3),
        xxh32_np(bytes(range(40)), 3)]
    assert [int(x) for x in xxh64_batch(rows, lens, 3)] == [
        xxh64_np(b"", 3), xxh64_np(bytes(range(40)), 3),
        xxh64_np(bytes(range(40)), 3)]
    empty = torch.zeros((0, 16), dtype=torch.uint8)
    none = torch.zeros((0,), dtype=torch.int32)
    assert xxh32_batch(empty, none).shape == (0,)
    assert xxh64_batch(empty, none).shape == (0,)
    zero_wide = torch.zeros((2, 0), dtype=torch.uint8)
    assert [int(x) for x in xxh64_batch(zero_wide, lens[:2])] == \
        [xxh64_np(b"")] * 2
    for fn in (xxh32_batch, xxh64_batch):
        with pytest.raises(TypeError):
            fn(rows.int(), lens)
        with pytest.raises(TypeError):
            fn(rows, lens.long())
        with pytest.raises(ValueError):
            fn(rows, lens[:2])
        with pytest.raises(ValueError):
            fn(rows[:, ::2], lens)


def check_tiled(kernel, bufs, seed, tile, starts_list):
    """The staging model at each ``starts`` (the rows' first bytes in their
    granules) equals the plain version and lz4_tpu on ``bufs``."""
    tiled, plain, jax_fn, mask, _ = MODELS[kernel]
    rows, lens = rows_of(bufs)
    rows, lens = rows.numpy(), lens.numpy()
    want = jax_digests(jax_fn, bufs, seed & mask)
    np.testing.assert_array_equal(plain(rows, lens, seed), want)
    for starts in starts_list:
        np.testing.assert_array_equal(
            tiled(rows, lens, seed, starts, tile), want,
            err_msg=f"starts {list(starts)}")


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kernel", sorted(MODELS))
def test_tiled_model_every_length_and_start(kernel, tile):
    base = gen_buffer(100, 0.5, 3)
    bufs = [base[:n] for n in range(71)]
    check_tiled(kernel, bufs, 0x9E3779B1, tile,
                [np.full(len(bufs), s) for s in range(16)])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kernel", sorted(MODELS))
def test_tiled_model_at_tile_edges(kernel, tile):
    bufs = [gen_buffer(n, 0.6, n) for n in
            (tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile, 2 * tile + 1)]
    check_tiled(kernel, bufs, (1 << 63) + 12345, tile,
                [np.full(len(bufs), s) for s in range(16)])


@pytest.mark.parametrize("seed", [0, (1 << 63) + 12345])
@pytest.mark.parametrize("kernel", sorted(MODELS))
def test_tiled_model_ragged(kernel, seed):
    rng = random.Random(11)
    bufs = [gen_buffer(rng.choice([0, rng.randint(1, 100),
                                   rng.randint(100, 9000)]),
                       rng.uniform(0.3, 0.9), i) for i in range(24)]
    for tile in TILES:
        check_tiled(kernel, bufs, seed, tile,
                    [np.array([rng.randrange(16) for _ in bufs])
                     for _ in range(3)])


@pytest.mark.parametrize("width", [1, 16, 77, NARROW])
@pytest.mark.parametrize("kernel", sorted(MODELS))
def test_narrow_model_matches_jax(kernel, width):
    """Rows of at most NARROW bytes: groups of narrow_rows(width) rows
    staged as one range, at every start of the storage in a granule."""
    _, plain, jax_fn, mask, narrow = MODELS[kernel]
    rng = random.Random(width)
    nrows = 2 * narrow_rows(width) + 9        # two whole groups and a part
    bufs = [gen_buffer(width, 0.6, 0)] + [
        gen_buffer(rng.randint(0, width), 0.6, i) for i in range(1, nrows)]
    rows, lens = rows_of(bufs)
    rows, lens = rows.numpy(), lens.numpy()
    seed = (1 << 63) + 12345
    want = jax_digests(jax_fn, bufs, seed & mask)
    np.testing.assert_array_equal(plain(rows, lens, seed), want)
    for start in (0, 3, 15):
        np.testing.assert_array_equal(narrow(rows, lens, seed, start), want,
                                      err_msg=f"start {start}")


@pytest.mark.parametrize("width", [72, 77, 4096])
@pytest.mark.parametrize("offset", [1, 2, 3, 15])
def test_views_at_storage_offsets_match_jax(offset, width):
    """Contiguous rows that start ``offset`` bytes into their storage."""
    rng = random.Random(offset * width)
    bufs = [gen_buffer(rng.randint(0, width), 0.6, i) for i in range(9)]
    rows, lens = rows_of(bufs, width - max(len(b) for b in bufs))
    flat = torch.zeros((offset + rows.numel(),), dtype=torch.uint8)
    flat[offset:] = rows.reshape(-1)
    view = flat[offset:offset + rows.numel()].view(len(bufs), width)
    assert view.storage_offset() == offset and view.is_contiguous()
    for seed in (0, 0x9E3779B1):
        np.testing.assert_array_equal(
            xxh32_batch(view, lens, seed),
            jax_digests(jax_xxh32_batch, bufs, seed))
        np.testing.assert_array_equal(
            xxh64_batch(view, lens, seed),
            jax_digests(jax_xxh64_batch, bufs, seed))


def test_models_use_the_kernels_tile():
    """The staging models take csrc/xxh.cu's tile, room and narrow path."""
    src = (REPO / "lz4_tpu_torch" / "csrc" / "xxh.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("TILE") == TILE and const("NARROW") == NARROW
    assert const("NSTAGE") == NSTAGE
    assert re.search(r"constexpr int PITCH = TILE \+ (\d+);", src).group(1) \
        == str(ROOM)
    assert narrow_rows(NARROW) == 8 and narrow_rows(77) == 48 \
        and narrow_rows(1) == const("RMAX")
