"""The port's scatter-gather layer (lz4_tpu_torch.sg) and the plain versions
of its kernels, the chain encoder G (``sg_encode_chain``, also with the
card's schedule of its parse, ``dest_size_block_rounds_plain``) and the
chain decoder F (``decode_blocks_sg``), held against lz4_tpu.

Both packages get the same bytes, made from seeds.  The JAX kernels run in
interpret mode, so the lists are small (at most 384 KB, and one long but
sparse list for the large-block route).  Codec outputs are integers: every
comparison is exact.  Nothing here needs the reference C library.

    python -m tests.test_torch_sg

prints what the round model counts (rounds, probes, the serial scan's
probes, extension ballots, sequences) on ``chip_smoke.py``'s '4k' and
'ragged' walks (the first 16 MiB of the stdlib corpus) and on 64 of its
1,024 rows of 64 KB at cap n/2 (kernel H's batch): the work kernels G and H
do on the card, per warp.
"""

import collections
import functools
import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import noise_bytes, slot_collisions
from lz4_tpu import sg as jsg
from lz4_tpu import spec as jspec
from lz4_tpu.frame import decompress_frame
from lz4_tpu.kernels import decode_kernel as jdec
from lz4_tpu.kernels import destsize_kernel as jdsk
from lz4_tpu.ops import block_np
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import sg as tsg
from lz4_tpu_torch import spec as tspec
from lz4_tpu_torch.kernels import common
from lz4_tpu_torch.kernels import decode_kernel as tdec
from lz4_tpu_torch.kernels import destsize_kernel as tdsk

from .test_torch_stream import sparse_data

CPU = "cpu"
DATA64K = gen_buffer(65536, 0.7, 200)


def split(data: bytes, sizes):
    out, pos = [], 0
    for s in sizes:
        out.append(data[pos:pos + s])
        pos += s
    assert pos == len(data)
    return out


def trim_to_filled(bufs, caps, total):
    """The filled prefix of an output list (what a caller sends on)."""
    out, rem = [], total
    for b, c in zip(bufs, caps):
        if rem <= 0:
            break
        out.append(b[:min(c, rem)])
        rem -= min(c, rem)
    return out


def ragged_list(seed: int, total: int, max_in: int, n_out: int,
                max_cap: int, proba: float = 0.7):
    """Input buffers of 1..max_in bytes over ``total`` bytes of datagen
    text, and ``n_out`` output caps in SG_MIN_OUT_BUF..max_cap (the first
    at least SG_MIN_FIRST_OUT): test_sg.py's fuzz distribution, scaled."""
    rng = random.Random(seed)
    data = gen_buffer(total, proba, seed)
    sizes, pos = [], 0
    while pos < total:
        sizes.append(min(rng.randint(1, max_in), total - pos))
        pos += sizes[-1]
    caps = [rng.randint(tspec.SG_MIN_OUT_BUF, max_cap) for _ in range(n_out)]
    caps[0] = max(caps[0], tspec.SG_MIN_FIRST_OUT)
    return split(data, sizes), caps


# ---------------------------------------------------------------------------
# kernel G: sg_encode_chain's plain version against lz4_tpu's chain kernel
# ---------------------------------------------------------------------------

def _inverse_16x4k():
    sizes = [65536 // 17] * 17
    sizes[-1] += 65536 - sum(sizes)
    return split(DATA64K, sizes), [4096 + 64] * 16


CHAIN_CASES = {
    # name: (lambda -> (in_bufs, caps), acceleration, min_match)
    "16x4k_to_17x4k": (lambda: (split(DATA64K, [4096] * 16), [4096] * 17),
                       1, 4),
    "17_to_16x4k": (_inverse_16x4k, 1, 4),
    "ragged": (lambda: ragged_list(5, 110_000, 30_000, 12, 20_000), 1, 4),
    # small caps: capacity stops, zero-pad blocks and straddled headers
    "stops_and_zero_pads": (lambda: ragged_list(7, 40_000, 9_000, 200, 400),
                            1, 4),
    "min_match_8": (lambda: (split(DATA64K, [4096] * 16), [4096] * 17), 1, 8),
    "acceleration_2": (lambda: (split(DATA64K, [8192] * 8), [5000] * 12),
                       2, 4),
    "one_byte_buffers": (lambda: (split(DATA64K[:300], [1] * 300),
                                  [64] * 40), 1, 4),
    # noise: long literal runs, blocks near their caps
    "noise": (lambda: (split(incompressible(20_000, 3), [5000] * 4),
                       [7000, 7000, 7000, 7000]), 1, 4),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_sg_encode_chain_matches_jax(case):
    make, acc, mm = CHAIN_CASES[case]
    in_bufs, caps = make()
    max_dest = sum(caps)
    vals, in_ends, _ = jsg.sg_chain_vals(in_bufs)
    j_out, *j_recs = jdsk.sg_encode_chain(vals, in_ends,
                                          np.asarray(caps, np.int32),
                                          max_dest, acc, mm)
    flat, t_ends = tdsk.sg_chain_input(in_bufs, CPU)
    assert (t_ends == in_ends).all()
    common.reset_counts()
    blocks, boff, *t_recs = tdsk.sg_encode_chain(flat, t_ends, caps,
                                                 max_dest, acc, mm)
    assert common.PLAIN_CALLS["sg_encode_chain"] == 1
    for j, t in zip(j_recs, t_recs):            # blen, consumed, isz, osz
        assert np.asarray(j).tolist() == t.tolist()
    j_out = np.asarray(j_out).astype(np.uint8)
    blen = t_recs[0].tolist()
    live = [t for t, n in enumerate(blen) if n >= 0]
    assert live == list(range(len(live))) and len(live) > 1
    for t in live:
        b = int(boff[t])
        assert blocks[b:b + blen[t]].numpy().tobytes() == \
            j_out[t, :blen[t]].tobytes(), t
    assert len(blocks) == int(boff[live[-1]]) + blen[live[-1]]


# the walks of kernel G's parse as the card's warp runs it
ROUND_CHAIN_CASES = {
    # name: (lambda -> (in_bufs, caps), acceleration, min_match)
    "4k_walk": (lambda: (split(gen_buffer(96 * 4096, 0.7, 201),
                               [4096] * 96), [4096] * 102), 1, 4),
    "zeros": (lambda: (split(bytes(60_000), [6_000] * 10), [4096] * 20),
              1, 4),
    "noise": (lambda: (split(noise_bytes(40_000, 4), [20_000] * 2),
                       [21_000] * 2), 1, 4),
    "slot_collisions": (lambda: (split(slot_collisions(40_000, 5),
                                       [8_000] * 5), [5_000] * 10), 1, 4),
    # capacity-stopped steps followed by more steps: the table keeps
    # entries at or past where the next step starts
    "capacity_stops": (lambda: ragged_list(9, 60_000, 12_000, 300, 600),
                       1, 4),
    "min_match_12_acceleration_7": (lambda: (split(DATA64K, [8192] * 8),
                                             [6000] * 12), 7, 12),
    "min_match_8_acceleration_2": (lambda: (split(DATA64K, [4096] * 16),
                                            [4096] * 17), 2, 8),
}


@pytest.mark.parametrize("case", sorted(ROUND_CHAIN_CASES))
def test_round_model_walk_matches_the_parse_and_jax(case):
    """``sg_encode_chain_plain`` with ``dest_size_block_rounds_plain`` as its
    parse gives every step's records and block bytes of the serial parse,
    and those are lz4_tpu's."""
    make, acc, mm = ROUND_CHAIN_CASES[case]
    in_bufs, caps = make()
    max_dest = sum(caps)
    vals, in_ends, _ = jsg.sg_chain_vals(in_bufs)
    j_out, *j_recs = jdsk.sg_encode_chain(vals, in_ends,
                                          np.asarray(caps, np.int32),
                                          max_dest, acc, mm)
    flat, t_ends = tdsk.sg_chain_input(in_bufs, CPU)
    data = flat.numpy().tobytes()
    ends, caps = t_ends.tolist(), list(caps)
    serial = tdsk.sg_encode_chain_plain(data, ends, caps, max_dest, acc, mm)
    counts = collections.Counter()
    rounds = tdsk.sg_encode_chain_plain(
        data, ends, caps, max_dest, acc, mm,
        parse=functools.partial(tdsk.dest_size_block_rounds_plain,
                                counts=counts))
    assert rounds == serial
    blocks, boff, blen, cons, isz, osz = serial
    for j, t in zip(j_recs, (blen, cons, isz, osz)):
        assert np.asarray(j).tolist() == t
    j_out = np.asarray(j_out).astype(np.uint8)
    live = [t for t, n in enumerate(blen) if n >= 0]
    assert len(live) > 1
    for t in live:
        assert blocks[boff[t]:boff[t] + blen[t]] == \
            j_out[t, :blen[t]].tobytes(), t
    if case == "capacity_stops":
        assert any(cons[t] < isz[t] and blen[t + 1] >= 0 for t in live)
    if case == "slot_collisions":
        assert counts["from_lane"] > 2 * counts["rounds"]
    if case == "noise":
        assert 0 < counts["probes"] < 40_000 // 2
    if case == "4k_walk":
        assert 0 < counts["rounds"] < 2 * counts["sequences"]


def _final_run_sizes(lits: np.ndarray) -> np.ndarray:
    """Exact encoded size of a final literal run of each length."""
    return 1 + lits + np.where(lits < 15, 0, 1 + (lits - 15) // 255)


@pytest.mark.parametrize("avail", [0, 5, 14, 15, 300, 65000, 65536, 70000])
def test_max_final_literals_matches_jax(avail):
    """The closed form and its fix-ups at every room in 0..70,000.  The
    port's run always fits its room, and is the largest L <= avail that
    fits or at most two bytes short of it (the closed form's own rounding,
    e.g. 523 at room 527 where 524 fits, which is lz4_tpu's parse).  It
    equals lz4_tpu at every room below 65,297; above it lz4_tpu's int32
    ``_div255`` wraps, and with 64 KB of literals left its run overruns
    the room."""
    rooms = np.arange(0, 70_001, dtype=np.int64)
    exact = np.searchsorted(_final_run_sizes(np.arange(avail + 1)), rooms,
                            side="right") - 1
    got = np.array([tdsk._max_final_literals(int(r), avail) for r in rooms])
    fits = (got < 0) | (_final_run_sizes(got) <= rooms)
    assert fits.all() and ((got < 0) == (exact < 0)).all()
    assert ((exact - got >= 0) & (exact - got <= 2)).all()
    want = np.asarray(jdsk._max_final_literals(
        jnp.asarray(rooms.astype(np.int32)), jnp.int32(avail)))
    below = rooms < 65_297
    np.testing.assert_array_equal(want[below], got[below])
    if avail >= 65_536:
        assert (_final_run_sizes(want[~below]) > rooms[~below]).any()


def test_sg_encode_chain_checks_its_arguments():
    flat, ends = tdsk.sg_chain_input([b"abc" * 10], CPU)
    with pytest.raises(tdsk.ChainEnvelopeError):
        tdsk.sg_encode_chain(flat, [0, 0], [100], 100)
    with pytest.raises(ValueError, match="TAIL|more bytes"):
        tdsk.sg_encode_chain(flat[:30], ends, [100], 100)
    with pytest.raises(ValueError, match="in_ends"):
        tdsk.sg_encode_chain(flat, [5, 30], [100], 100)
    with pytest.raises(ValueError, match="out_caps"):
        tdsk.sg_encode_chain(flat, ends, [], 100)
    with pytest.raises(TypeError):
        tdsk.sg_encode_chain(flat.int(), ends, [100], 100)


# ---------------------------------------------------------------------------
# kernel F: decode_blocks_sg's plain version against lz4_tpu's
# ---------------------------------------------------------------------------

def _linked_chain(data: bytes, sizes):
    """Blocks of ``sizes`` bytes, each compressed against the 64 KB of
    content before it, so matches cross block boundaries."""
    out, pos = [], 0
    for s in sizes:
        out.append(block_np.compress_block(
            data[pos:pos + s], dict_=data[max(pos - 65536, 0):pos]))
        pos += s
    return out


def _corrupt_middle():
    sizes = [4096] * 6 + [20_000]
    chain = _linked_chain(gen_buffer(sum(sizes), 0.7, 11), sizes)
    bad = bytearray(chain[3])
    bad[len(bad) // 2] ^= 0x5A
    bad[len(bad) // 3] = 0xFF
    chain[3] = bytes(bad)
    return chain, sizes


def _noise_chain():
    rng = np.random.default_rng(12)
    chain = [rng.integers(0, 256, int(rng.integers(1, 3000)),
                          dtype=np.uint8).tobytes() for _ in range(12)]
    return chain, [int(rng.integers(1, 65537)) for _ in range(12)]


SG_DECODE_CASES = {
    "cross_block_matches": lambda: (
        _linked_chain(gen_buffer(150_000, 0.7, 9),
                      [4096, 1, 13, 30_000, 65_536, 50_354]),
        [4096, 1, 13, 30_000, 65_536, 50_354]),
    "corrupt_block_in_the_middle": _corrupt_middle,
    "noise": _noise_chain,
}


@pytest.mark.parametrize("case", sorted(SG_DECODE_CASES))
def test_decode_blocks_sg_matches_jax(case):
    chain, sizes = SG_DECODE_CASES[case]()
    M = -(-max(map(len, chain)) // 128) * 128
    rows = np.zeros((len(chain), M), np.uint8)
    for i, c in enumerate(chain):
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in chain], np.int32)
    j_out, j_olen = jdec.decode_blocks_sg(jnp.asarray(rows.astype(np.int32)),
                                          jnp.asarray(lens), sizes)
    common.reset_counts()
    t_out, t_olen = tdec.decode_blocks_sg(torch.from_numpy(rows),
                                          torch.from_numpy(lens), sizes)
    assert common.PLAIN_CALLS["decode_sg"] == 1
    assert np.asarray(j_olen).tolist() == t_olen.tolist()
    total = sum(sizes)
    assert len(t_out) == total
    if t_olen.tolist() == sizes:
        j_flat = np.asarray(j_out).astype(np.uint8).reshape(-1)
        assert j_flat[65536:65536 + total].tobytes() == \
            t_out.numpy().tobytes()
    if case == "cross_block_matches":
        assert t_out.numpy().tobytes() == gen_buffer(150_000, 0.7, 9)
    else:
        assert (t_olen < 0).any()


def test_decode_blocks_sg_checks_its_arguments():
    flat = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError, match="64KB"):
        tdec.decode_blocks_sg_raw(flat, [0], [10], [65537])
    with pytest.raises(ValueError, match="inside flat"):
        tdec.decode_blocks_sg_raw(flat, [95], [10], [100])
    with pytest.raises(ValueError, match="int32"):
        tdec.decode_blocks_sg_raw(flat, [0] * 32768, [1] * 32768,
                                  [65536] * 32768)


@pytest.mark.parametrize("seed", range(4))
def test_decoded_length_agrees_with_the_decoder(seed):
    """The token scan the device walk collects sizes with gives the length
    a good block decodes to, and -1 for a block whose sequences do not end
    at its last byte."""
    rng = np.random.default_rng(seed)
    data = gen_buffer(20_000, 0.6, seed)
    comp = block_np.compress_block(data)
    assert tsg.decoded_length(comp) == len(data)
    assert tsg.decoded_length(comp[:-1]) == -1
    for _ in range(50):
        junk = rng.integers(0, 256, int(rng.integers(1, 200)),
                            dtype=np.uint8).tobytes()
        n = tsg.decoded_length(junk)
        r, _ = tdec.decode_block_plain(junk, len(junk), 1 << 20, bytes(65535))
        assert n == r or (r == -1 and n >= 0)


def _sg_cells_model(chain, sizes, limits=(None, 10_000, 1)):
    """``decode_blocks_sg_cells_plain`` (kernel F's schedule on the card) in
    windows of each of ``limits`` bytes equals the serial walk: every
    output byte and olen.  Returns the serial walk's."""
    flat, bstart, clen = tdec.join_payloads(chain, CPU)
    flat = flat.numpy().tobytes()
    want = tdec.decode_blocks_sg_plain(flat, bstart.tolist(), clen.tolist(),
                                       sizes)
    for limit in limits:
        got = tdec.decode_blocks_sg_cells_plain(flat, bstart, clen, sizes,
                                                limit)
        assert got == want, (limit, got[1], want[1])
    return want


@pytest.mark.parametrize("case", sorted(SG_DECODE_CASES))
def test_sg_cells_model_matches_the_serial_walk(case):
    _sg_cells_model(*SG_DECODE_CASES[case]())


@pytest.mark.parametrize("seed", range(4))
def test_sg_cells_model_bit_flips(seed):
    """Bit flips in a linked SG chain: failed blocks keep their bytes
    before the failing sequence, and later blocks copy them."""
    rng = np.random.default_rng(seed)
    sizes = [4096] * 12 + [30_000]
    chain = [bytearray(c) for c in _linked_chain(
        gen_buffer(sum(sizes), 0.7, 20 + seed), sizes)]
    for _ in range(2 + 2 * seed):
        k = int(rng.integers(len(chain)))
        i = int(rng.integers(len(chain[k])))
        chain[k][i] ^= 1 << int(rng.integers(8))
    _sg_cells_model([bytes(c) for c in chain], sizes)


SG_ADVERSARIAL = chip_smoke.sg_adversarial(3000, gen_buffer(4000, 0.5, 30))


@pytest.mark.parametrize("case", range(len(SG_ADVERSARIAL)))
def test_sg_cells_model_adversarial_chains(case):
    """chip_smoke's hard chains: references crossing 16 blocks (one more
    window than a reference may skip at the smallest limit), a failed
    middle block whose partial bytes and zero tail a later block copies,
    and a short block copied on; also against lz4_tpu (statuses, and the
    bytes where every block fills its size: lz4_tpu leaves what a failed
    or short block does not write unspecified)."""
    what, chain, sizes = SG_ADVERSARIAL[case]
    out, olen = _sg_cells_model(chain, sizes, (None, 6000, 3000, 1))
    if case == 0:
        assert out == gen_buffer(4000, 0.5, 30)[:3000] * 17
    if case == 1:
        assert olen[1] == -1 and out[4500:6000] == bytes(1500)
        assert out[6000:9000] == out[3000:6000]
    if case == 2:
        assert olen[1] == 1500 and out[6000:9000] == out[3000:6000]
    M = -(-max(map(len, chain)) // 128) * 128
    rows = np.zeros((len(chain), M), np.uint8)
    for i, c in enumerate(chain):
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in chain], np.int32)
    j_out, j_olen = jdec.decode_blocks_sg(jnp.asarray(rows.astype(np.int32)),
                                          jnp.asarray(lens), sizes)
    assert np.asarray(j_olen).tolist() == olen, what
    if olen == sizes:
        j_flat = np.asarray(j_out).astype(np.uint8).reshape(-1)
        assert j_flat[65536:65536 + len(out)].tobytes() == out


def test_sg_cells_model_windows_and_rounds():
    """A 40-block linked chain in windows of 1 byte to the whole chain:
    the windows cover the blocks in order and hold at most the limit or
    one block; the rounds of each (jump_rounds of its blocks + 1) resolve
    every reference, those below a window reading the bytes before it."""
    sizes = [int(x) for x in np.random.default_rng(7).integers(1, 9000, 40)]
    data = sparse_data(sum(sizes), 77)
    chain = _linked_chain(data, sizes)
    out, olen = _sg_cells_model(chain, sizes, (None, 1, 5000, 20_000))
    assert out == data and olen == sizes
    for limit in (1, 5000, 20_000):
        w = tdec.cell_windows(sizes, limit, first=0)
        assert w[0] == 0 and w[-1] == len(sizes) and (np.diff(w) > 0).all()
        for b0, b1 in zip(w[:-1], w[1:]):
            assert sum(sizes[b0:b1]) <= limit or b1 - b0 == 1


# ---------------------------------------------------------------------------
# the SG layer: device routes, the walks alone, headers, bounds, errors
# ---------------------------------------------------------------------------

SG_COMPRESS_CASES = {
    "16x4k_to_17x4k": lambda: (split(gen_buffer(65536, 0.7, 77),
                                     [4096] * 16), [4096] * 17),
    "ragged": lambda: ragged_list(0xD57, 90_000, 40_000, 8, 30_000),
}


@pytest.mark.parametrize("case", sorted(SG_COMPRESS_CASES))
def test_sg_compress_device_matches_jax(case):
    in_bufs, caps = SG_COMPRESS_CASES[case]()
    want = jsg.sg_compress(in_bufs, caps, use_device=True)
    common.reset_counts()
    got = tsg.sg_compress(in_bufs, caps, device=CPU)
    assert dict(common.PLAIN_CALLS) == {"sg_encode_chain": 1}
    assert got == want
    total, consumed, outs = got
    assert total > 0 and consumed == sum(map(len, in_bufs))
    # every SG frame is an ordinary LZ4F frame
    frame = b"".join(trim_to_filled(outs, caps, total))
    assert decompress_frame(frame) == (b"".join(in_bufs), len(frame))
    # and decodes back into the mirrored list on the device route
    n, dec = tsg.sg_decompress(trim_to_filled(outs, caps, total),
                               [len(b) for b in in_bufs], device=CPU)
    assert n == consumed and dec == in_bufs


def _jax_dest_size(src, capacity, dict_, acceleration):
    return block_np.compress_block_dest_size(src, capacity, acceleration,
                                             dict_=dict_)


WALK_CASES = {
    "16x4k_to_17x4k": (lambda: (split(DATA64K, [4096] * 16), [4096] * 17),
                       None),
    "stops_and_zero_pads": (lambda: ragged_list(7, 40_000, 9_000, 200, 400),
                            None),
    "partial_source": (lambda: (split(DATA64K, [4096] * 16), [4096] * 17),
                       30_000),
    "ragged_incompressible": (lambda: ragged_list(3, 60_000, 20_000, 9,
                                                  20_000, 0.1), None),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walks_match_jax_host_path(case):
    """The walks alone, each over the JAX package's host block codec."""
    make, source_size = WALK_CASES[case]
    in_bufs, caps = make()
    want = jsg.sg_compress(in_bufs, caps, source_size=source_size)
    got = tsg.sg_compress(in_bufs, caps, source_size=source_size,
                          dest_size_compress=_jax_dest_size)
    assert got == want
    total, consumed, outs = got
    assert total > 0
    comp = trim_to_filled(outs, caps, total)
    sizes = [len(b) for b in in_bufs]

    def block_decompress(c, out_cap, dict_):
        return block_np.decompress_block(c, out_cap, dict_=dict_)

    want_d = jsg.sg_decompress(comp, sizes)
    assert tsg.sg_decompress(comp, sizes,
                             block_decompress=block_decompress) == want_d
    assert b"".join(want_d[1])[:consumed] == b"".join(in_bufs)[:consumed]


def _large_block_frame():
    """test_sg.py's large-block layout on sparse data: blocks of 900, 400
    and 100 KB in one output buffer."""
    data = sparse_data(1_400_000, 31)
    sizes = [900_000, 400_000, 100_000]
    ins = split(data, sizes)
    caps = [len(data) + 4096]
    total, consumed, outs = jsg.sg_compress(ins, caps)
    assert consumed == len(data)
    return trim_to_filled(outs, caps, total), sizes, data


def _host_frame(case):
    in_bufs, caps = SG_COMPRESS_CASES[case]()
    total, _, outs = jsg.sg_compress(in_bufs, caps)
    return (trim_to_filled(outs, caps, total), [len(b) for b in in_bufs],
            b"".join(in_bufs))


SG_DECOMPRESS_CASES = {
    "16x4k_host_frame": lambda: _host_frame("16x4k_to_17x4k"),
    "ragged_host_frame": lambda: _host_frame("ragged"),
    "large_blocks": _large_block_frame,
}


@pytest.mark.parametrize("case", sorted(SG_DECOMPRESS_CASES))
def test_sg_decompress_device_matches_jax(case):
    comp, sizes, data = SG_DECOMPRESS_CASES[case]()
    want = jsg.sg_decompress(comp, sizes)
    assert jsg.sg_decompress(comp, sizes, use_device=True) == want
    common.reset_counts()
    got = tsg.sg_decompress(comp, sizes, device=CPU)
    assert got == want
    assert b"".join(got[1]) == data
    route = "decode_stream" if case == "large_blocks" else "decode_sg"
    assert dict(common.PLAIN_CALLS) == {route: 1}


def test_sg_header_and_bound_match_jax():
    for content, bmax in ((0, 4096), (1, 65536), (123_456, 65537),
                          (1 << 33, 4 << 20)):
        assert tsg._encode_sg_header(content, bmax) == \
            jsg._encode_sg_header(content, bmax)
    for args in ((100, 1, 1), (5, 5, 1), (65536, 16, 17), (1 << 24, 4096,
                                                            4352),
                 (0x7E000001, 1, 1)):
        assert tsg.sg_compress_bound(*args) == jsg.sg_compress_bound(*args)
    for name in ("BLOCK_HEADER_SIZE", "ENDMARK_SIZE", "SG_FRAME_HEADER_SIZE",
                 "SG_MAX_BLOCK_SIZE", "SG_MIN_OUT_BUF", "SG_MIN_FIRST_OUT",
                 "SG_OK", "SG_ERR_PARAM", "SG_ERR_OUT_SPACE", "SG_ERR_MAGIC",
                 "SG_ERR_CONTENT_CHECKSUM", "SG_ERR_BLOCK_CHECKSUM",
                 "SG_ERR_NO_CONTENT_SIZE", "SG_ERR_BLOCK_INDEP"):
        assert getattr(tspec, name) == getattr(jspec, name), name


def _refix(b):
    b[14] = (jsg.xxh32(bytes(b[4:14]), 0) >> 8) & 0xFF
    return b


HEADER_FAULTS = {
    0: lambda b: b,
    -1: lambda b: b.__setitem__(0, b[0] ^ 0xFF) or b,
    -2: lambda b: b.__setitem__(4, (b[4] & 0x3F) | 0x80) or b,
    -3: lambda b: b.__setitem__(14, b[14] ^ 0xFF) or b,
    -4: lambda b: _refix(b.__setitem__(4, b[4] | 1 << 4) or b),
    -5: lambda b: _refix(b.__setitem__(4, b[4] | 1 << 2) or b),
    -6: lambda b: _refix(b.__setitem__(4, b[4] & ~(1 << 3)) or b),
    -7: lambda b: _refix(b.__setitem__(4, b[4] | 1 << 5) or b),
}


@pytest.mark.parametrize("code", sorted(HEADER_FAULTS))
def test_sg_decode_header_codes_match_jax(code):
    good = bytearray(tsg._encode_sg_header(4096, 4096))
    buf = bytes(HEADER_FAULTS[code](good))

    def code_of(fn):
        try:
            fn(buf)
            return 0
        except (tsg.SgError, jsg.SgError) as exc:
            return exc.code

    assert code_of(tsg.sg_decode_header) == \
        code_of(jsg.sg_decode_header) == code


@pytest.mark.parametrize("args", [([], [100]), ([b"x"], []), ([b""], [100]),
                                  ([b"x" * 100], [5])])
def test_sg_compress_validates_like_jax(args):
    """The port validates before its device route; lz4_tpu's device route
    runs first, and with no output buffers fails inside JAX (a TypeError),
    so the codes are held against its host path."""
    with pytest.raises(tsg.SgError) as t_err:
        tsg.sg_compress(*args, device=CPU)
    with pytest.raises(jsg.SgError) as j_err:
        jsg.sg_compress(*args)
    assert t_err.value.code == j_err.value.code


def test_sg_compress_returns_zero_like_jax_when_the_first_buffer_is_short():
    args = ([b"x" * 100], [tspec.SG_MIN_FIRST_OUT - 1, 100])
    assert tsg.sg_compress(*args, device=CPU) == \
        jsg.sg_compress(*args, use_device=True) == (0, 0, [])


def _frame_with_big_block():
    """An SG frame whose one block decodes to 5 MB: a literal, then one
    match of offset 1 carried by length-extension bytes."""
    n = 5 << 20
    ext = n - 1 - 4 - 15
    block = (b"\x1fA\x01\x00" + b"\xff" * (ext // 255) + bytes([ext % 255])
             + b"\x00")
    frame = (tsg._encode_sg_header(n, n) + struct.pack("<I", len(block))
             + block + bytes(4))
    return [frame], [n]


def _corrupt_chain_frame():
    in_bufs, caps = SG_COMPRESS_CASES["16x4k_to_17x4k"]()
    total, _, outs = tsg.sg_compress(in_bufs, caps, device=CPU)
    comp = [bytearray(b) for b in trim_to_filled(outs, caps, total)]
    # the first block's first match offset, pointed past its empty window
    ip = tspec.SG_FRAME_HEADER_SIZE + tspec.BLOCK_HEADER_SIZE
    lit = comp[0][ip] >> 4
    ip += 1
    if lit == 15:
        while comp[0][ip] == 255:
            lit += 255
            ip += 1
        lit += comp[0][ip]
        ip += 1
    comp[0][ip + lit:ip + lit + 2] = b"\xff\xff"
    return [bytes(b) for b in comp], [4096] * 16


def _frame_over_8mb():
    """An SG frame of two blocks: 64 KB of text as literals, then a block
    decoding to about 9 MB whose matches (offset 65,535, as long as their
    offset) copy the 64 KB before it, the first one from the previous
    block: kernel D's route, with that block as its dictionary row."""
    head = DATA64K
    reps = (9 << 20) // 65535
    body = chip_smoke.lz4_seq(b"", 65535, 65535) * reps
    tail_lits = b"0123456789"
    second = body + chip_smoke.lz4_seq(tail_lits)
    n = len(head) + reps * 65535 + len(tail_lits)
    blocks = [chip_smoke.lz4_seq(head), second]
    frame = (tsg._encode_sg_header(n, n)
             + b"".join(struct.pack("<I", len(b)) + b for b in blocks)
             + bytes(4))
    return [frame], [n]


def _chain_of_4k(monkeypatch=None):
    """The '16x4k_to_17x4k' frame as its filled buffers, with the list it
    came from."""
    in_bufs, caps = SG_COMPRESS_CASES["16x4k_to_17x4k"]()
    total, _, outs = tsg.sg_compress(in_bufs, caps, device=CPU)
    return trim_to_filled(outs, caps, total), [len(b) for b in in_bufs]


SG_COMPRESS_ROUTES = {
    # name: (input list, out caps, source_size); the walk runs over kernel
    # H from its first block (outside kernel G's envelope), or from the
    # step past G's records
    "partial_source": (split(DATA64K, [4096] * 16), [4096] * 17, 30_000),
    "content_over_max_total": ([DATA64K[:3000]], [4096], None),
    "walk_longer_than_the_steps": (split(DATA64K, [4096] * 16), [4096] * 17,
                                   None),
}


@pytest.mark.parametrize("case", sorted(SG_COMPRESS_ROUTES))
def test_port_answers_where_jax_takes_its_host_path_compress(case,
                                                             monkeypatch):
    """lz4_tpu hands these walks to its host codec; the port runs them
    over kernel H (its plain version here).  The port consumes what
    lz4_tpu consumes, both packages decode its frame to that content, and
    its size is within 5 % of lz4_tpu's host walk: kernel H parses as
    lz4_tpu's destSize kernels do, and lz4_tpu's own chain kernel is 5.1 %
    above its host walk on the whole of this list (32,614 against 31,017
    bytes); the port's walk over H is 3.8 % above on the partial walk."""
    in_bufs, caps, source_size = SG_COMPRESS_ROUTES[case]
    if case == "content_over_max_total":
        monkeypatch.setattr(tdsk, "MAX_TOTAL", 2000)
    if case == "walk_longer_than_the_steps":
        real = tdsk.sg_chain_statics
        monkeypatch.setattr(tdsk, "sg_chain_statics",
                            lambda *a: (3, real(*a)[1]))
    common.reset_counts()
    total, consumed, outs = tsg.sg_compress(in_bufs, caps,
                                            source_size=source_size,
                                            device=CPU)
    h_calls = common.PLAIN_CALLS["encode_dest_size"]
    g_calls = common.PLAIN_CALLS["sg_encode_chain"]
    assert h_calls > 0
    assert g_calls == (case == "walk_longer_than_the_steps")
    j_total, j_consumed, _ = jsg.sg_compress(in_bufs, caps,
                                             source_size=source_size)
    assert consumed == j_consumed > 0
    assert abs(total - j_total) <= 0.05 * j_total, (total, j_total)
    content = b"".join(in_bufs)[:consumed]
    comp = trim_to_filled(outs, caps, total)
    assert tsg.sg_decompress(comp, [consumed], device=CPU) == \
        jsg.sg_decompress(comp, [consumed]) == (consumed, [content])


SG_DECOMPRESS_ROUTES = {
    # name: (frame buffers and out caps, the kernel that decodes)
    "block_over_4mb": (_frame_with_big_block, "decode_stream"),
    "block_over_8mb": (_frame_over_8mb, "decode_batch"),
    "content_over_max_device_content": (_chain_of_4k, "decode_stream"),
}


@pytest.mark.parametrize("case", sorted(SG_DECOMPRESS_ROUTES))
def test_port_answers_where_jax_takes_its_host_path_decompress(case,
                                                               monkeypatch):
    """Chains past kernel F go through kernel E in linked mode (blocks
    over 64 KB, content over MAX_DEVICE_CONTENT), a block over 8 MB
    through kernel D with its dictionary row; the port decodes them as
    lz4_tpu's host walk does."""
    make, kernel = SG_DECOMPRESS_ROUTES[case]
    comp, caps = make()
    if case == "content_over_max_device_content":
        monkeypatch.setattr(tsg, "MAX_DEVICE_CONTENT", 10_000)
    common.reset_counts()
    got = tsg.sg_decompress(comp, caps, device=CPU)
    assert common.PLAIN_CALLS[kernel] > 0
    assert common.PLAIN_CALLS["decode_sg"] == 0
    assert got == jsg.sg_decompress(comp, caps, use_device=True)
    assert got[0] == sum(caps)


def test_chain_that_does_not_decode_raises_like_jax():
    """A chain block that does not decode: lz4_tpu's host walk raises, and
    the port raises SgChainError."""
    comp, sizes = _corrupt_chain_frame()
    with pytest.raises(tsg.SgChainError):
        tsg.sg_decompress(comp, sizes, device=CPU)
    with pytest.raises(Exception):
        jsg.sg_decompress(comp, sizes, use_device=True)


@pytest.mark.parametrize("split_at", [1, 2, 5])
def test_decode_chain_linked_equals_one_stream_call(split_at, monkeypatch):
    """The E and D route of the SG decoder equals one call of kernel E's
    plain version over the whole chain (the same olen and bytes), with
    STREAM_MAX_INPUT cut so that the chain takes several runs, and with a
    corrupt block among them."""
    payloads = [chip_smoke.lz4_seq(DATA64K[:20_000])]
    for k in range(1, 7):
        payloads.append(chip_smoke.lz4_seq(DATA64K[k:k + 300], 15_000, 5000)
                        + chip_smoke.lz4_seq(b"tail!"))
    sizes = [20_000] + [5305] * 6
    payloads[4] = chip_smoke.lz4_seq(b"x", 60_000, 10) + \
        chip_smoke.lz4_seq(b"end..")
    want = tdec.decode_stream(payloads, 65536, 0, linked=True,
                              out_caps=sizes, device=CPU)
    limit = sum(map(len, payloads[:split_at])) + 65536
    monkeypatch.setattr(tdec, "STREAM_MAX_INPUT", limit)
    content, olen = tsg.decode_chain_linked(payloads, sizes,
                                            torch.device(CPU))
    assert olen.tolist() == want[1].tolist()
    assert content == want[0][:int(want[1][want[1] > 0].sum())].numpy() \
        .tobytes()


def round_counts() -> None:
    """Print the round model's counts on the smoke's walks and H rows."""
    import chip_smoke

    def model(counts):
        return functools.partial(tdsk.dest_size_block_rounds_plain,
                                 counts=counts)

    layouts = chip_smoke.sg_layouts(chip_smoke.real_text_corpus(16 << 20))
    for name in ("4k", "ragged"):
        what, ins, caps = layouts[name]
        flat, ends = tdsk.sg_chain_input(ins, CPU)
        counts = collections.Counter()
        recs = tdsk.sg_encode_chain_plain(flat.numpy().tobytes(),
                                          ends.tolist(), caps, sum(caps),
                                          parse=model(counts))
        print(f"G {name} ({what}): steps {sum(n >= 0 for n in recs[2])}, "
              f"{dict(counts)}")
    corpus = chip_smoke.real_text_corpus(64 << 20)
    rows = [corpus[i << 16:(i + 1) << 16] for i in range(0, 1024, 16)]
    per = []
    for row in rows:
        counts = collections.Counter()
        tdsk.encode_dest_size_plain(row, 0, len(row), len(row) // 2,
                                    parse=model(counts))
        per.append(counts)
    total = sum(per, collections.Counter())
    print(f"H, {len(rows)} rows of 64 KB at cap n/2: per row "
          f"{ {k: v / len(rows) for k, v in total.items()} }, rounds at "
          f"most {max(c['rounds'] for c in per)}")


if __name__ == "__main__":
    round_counts()
