"""The port's destSize kernels against lz4_tpu's, on the CPU: kernel H
(``encode_blocks_dest_size``), kernel D's resumable mode
(``decode_blocks_dest_size``) and dictionary rows (``decode_blocks``), and
the batch hooks of ``lz4_tpu_torch.block``; and the card's schedule of
kernel H's parse (``dest_size_block_rounds_plain``: rounds of 32
speculative probes) against the serial parse and lz4_tpu.

The port's plain versions run on CPU tensors; the JAX kernels run in
interpret mode.  Everything is compared at tolerance 0: block bytes, olen,
consumed and cons.
"""

import collections
import functools
import os
import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lz4_seq, noise_bytes, slot_collisions
from lz4_tpu import block as jblock
from lz4_tpu.kernels import decode_kernel as jdec
from lz4_tpu.kernels import destsize_kernel as jds
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.ops.block_np import compress_block
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import block as tblock
from lz4_tpu_torch.kernels import decode_kernel as tdec
from lz4_tpu_torch.kernels import destsize_kernel as tds
from lz4_tpu_torch.kernels.common import from_jax_lanes, to_jax_lanes

REPO = Path(__file__).resolve().parent.parent


def i32(values) -> np.ndarray:
    return np.asarray(values, np.int32)


def byte_lanes(buffers, width, right=False) -> np.ndarray:
    """[B, width] int32 byte lanes, rows zero padded (right-aligned when
    ``right``): what the JAX decoders take."""
    arr = np.zeros((len(buffers), width), np.int32)
    for i, b in enumerate(buffers):
        if b:
            at = width - len(b) if right else 0
            arr[i, at:at + len(b)] = np.frombuffer(b, np.uint8)
    return arr


def up128(n: int) -> int:
    return max(-(-n // 128) * 128, 128)


def max_literal_run(block: bytes) -> int:
    """The longest literal run of an LZ4 block (0 for an empty one)."""
    ip, best = 0, 0
    while ip < len(block):
        token = block[ip]
        run, ip = token >> 4, ip + 1
        if run == 15:
            while True:
                run += block[ip]
                ip += 1
                if block[ip - 1] != 255:
                    break
        best = max(best, run)
        ip += run
        if ip >= len(block):
            break
        ip += 2
        if token & 15 == 15:
            while block[ip] == 255:
                ip += 1
            ip += 1
    return best


# ---------------------------------------------------------------------------
# kernel H
# ---------------------------------------------------------------------------

def destsize_both(buffers, caps, prefixes=None, min_match=4, acceleration=1,
                  like_jax=None):
    """Run both packages' destSize encoders on rows ``[prefix | buffer]``,
    require equal block bytes, olen and consumed on every row for which
    ``like_jax(jax_block)`` holds (every row by default), decode every block
    of the port through its ``decode_blocks`` (the prefix as its dictionary
    row) back to the consumed source, and return [(consumed, block)] of the
    port, or with ``like_jax`` given, (that list, lz4_tpu's olen)."""
    prefixes = prefixes or [b""] * len(buffers)
    rows = [p + b for p, b in zip(prefixes, buffers)]
    NS = up128(max(map(len, rows)))
    slens = i32([len(b) for b in buffers])
    wlens = i32([len(p) for p in prefixes])
    caps = i32(caps)
    packed, _ = np_pack_rows(rows, NS)
    j_out, j_olen, j_cons = map(np.asarray, jds.encode_blocks_dest_size(
        bytes_to_val32_rows(jnp.asarray(packed), NS), jnp.asarray(slens),
        jnp.asarray(caps), acceleration, window_lens=jnp.asarray(wlens),
        min_match=min_match))
    t_out, t_olen, t_cons = tds.encode_blocks_dest_size(
        from_jax_lanes(byte_lanes(rows, NS)), torch.from_numpy(slens),
        torch.from_numpy(caps), acceleration,
        window_lens=torch.from_numpy(wlens), min_match=min_match)
    assert t_out.shape == j_out.shape and t_out.dtype == torch.uint8
    res = []
    for i, n in enumerate(t_olen.tolist()):
        block = t_out[i, :n].numpy().tobytes()
        j_block = j_out[i, :j_olen[i]].astype(np.uint8).tobytes()
        if like_jax is None or like_jax(j_block):
            assert (n, int(t_cons[i]), block) == \
                (int(j_olen[i]), int(j_cons[i]), j_block), i
        res.append((int(t_cons[i]), block))
    # the port's decoder reads the port's blocks
    P = max(int(wlens.max()), 1)
    dec, dlen = tdec.decode_blocks(
        t_out, t_olen, up128(int(slens.max())), out_caps=t_cons,
        dict_rows=from_jax_lanes(byte_lanes(prefixes, P, right=True)),
        dict_lens=torch.from_numpy(wlens))
    for i, (consumed, block) in enumerate(res):
        if block:
            assert int(dlen[i]) == consumed, i
            assert dec[i, :consumed].numpy().tobytes() == \
                buffers[i][:consumed], i
        else:
            assert consumed == 0
    return res if like_jax is None else (res, j_olen)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_destsize_contract_matches_jax(seed):
    rng = random.Random(seed)
    bufs, caps = [], []
    for i in range(12):
        n = rng.randint(20, 30_000)
        bufs.append(gen_buffer(n, rng.uniform(0.4, 0.95), seed * 50 + i))
        caps.append(rng.randint(10, max(12, n)))
    for (consumed, block), src, cap in zip(destsize_both(bufs, caps), bufs,
                                           caps):
        assert len(block) <= cap and 0 <= consumed <= len(src)
        if cap >= len(src) + len(src) // 255 + 32:
            assert consumed == len(src)


def test_destsize_tiny_capacities_match_jax():
    src = gen_buffer(1000, 0.6, 7)
    caps = [1, 2, 5, 6, 10, 17, 0, -3]
    res = destsize_both([src] * len(caps), caps)
    # cap 1 holds a bare token: a valid block of no bytes
    assert res[0] == (0, b"\x00") and res[1][0] >= 1
    assert res[6] == (0, b"") and res[7] == (0, b"")
    for (_, block), cap in zip(res, caps):
        assert len(block) <= max(cap, 0)


def test_destsize_prefix_window_matches_jax():
    base = gen_buffer(40_000, 0.8, 11)
    prefix, src = base[:20_000], base[15_000:]
    (c_plain, b_plain), (c_dict, b_dict) = destsize_both(
        [src, src], [4_000, 4_000], prefixes=[b"", prefix])
    assert len(b_plain) <= 4_000 and len(b_dict) <= 4_000
    assert c_dict >= c_plain


@pytest.mark.parametrize("wlen", [1, 3, 4, 5, 6, 7, 100, 65_535, 70_000])
def test_destsize_prefix_lengths_match_jax(wlen):
    """The prefix seeding ((wlen - 4) // 3 + 1 positions) at its edges, and
    a prefix longer than any offset can reach."""
    base = gen_buffer(wlen + 3_000, 0.7, wlen)
    destsize_both([base[wlen:]] * 2, [5_000, 700],
                  prefixes=[base[:wlen]] * 2)


def test_destsize_respects_min_match_like_jax():
    src = gen_buffer(20_000, 0.7, 31)
    (c, _), (c8, _) = destsize_both([src, src], [len(src) * 2, 3_000],
                                    min_match=12)
    assert c == len(src) and 0 < c8 < len(src)


def test_destsize_acceleration_matches_jax():
    bufs = [gen_buffer(12_000, p, 90 + i) for i, p in enumerate((0.5, 0.9))]
    destsize_both(bufs * 2, [20_000, 20_000, 3_000, 2_000], acceleration=2)
    destsize_both(bufs, [2_500, 20_000], acceleration=7, min_match=8)


def test_destsize_short_rows_match_jax():
    text = gen_buffer(64, 0.8, 5)
    bufs = [b"", text[:1], text[:12], text[:13], b"a" * 13, b"a" * 40]
    for cap in (0, 1, 3, 13, 14, 15, 100):
        res = destsize_both(bufs, [cap] * len(bufs))
        assert res[0] == ((0, b"\x00") if cap >= 1 else (0, b""))
    # the same short sources behind a prefix
    destsize_both(bufs, [100] * len(bufs), prefixes=[text[20:60]] * len(bufs))


def test_destsize_row_filling_its_width_matches_jax():
    """n == NS: the scan hashes up to n - 12 and never reads past the row."""
    src = gen_buffer(4096, 0.85, 3)
    destsize_both([src, src[:2048]], [5_000, 900],
                  prefixes=[b"", src[2048:]])


def test_destsize_literal_runs_past_the_div255_range_match_jax():
    """Over 65,295 literals before the first match and caps around 65,300.
    The JAX kernel sizes such runs with an int32 product that wraps and
    passes its cap; the port's exact div255 keeps every block within its
    cap, and equals lz4_tpu on every row whose runs stay under 65,295."""
    noise = incompressible(66_000)
    src = noise + gen_buffer(4_000, 0.9, 1) * 2
    caps = [65_290, 65_296, 65_300, 65_310, 65_560, 66_100, 66_270, 66_300,
            70_000, 80_000]
    compared = []

    def short_runs(block):
        compared.append(max_literal_run(block) < 65_295)
        return compared[-1]

    res, j_olen = destsize_both([src] * len(caps), caps, like_jax=short_runs)
    assert any(compared) and not all(compared)
    for (consumed, block), cap in zip(res, caps):
        assert len(block) <= cap
        # no block is longer than compress_bound of what it consumed
        assert len(block) <= consumed + consumed // 255 + 16
    assert res[-1][0] == len(src)
    assert (j_olen > np.asarray(caps)).any()


def test_destsize_checks_its_arguments():
    rows = torch.zeros((2, 256), dtype=torch.uint8)
    lens = torch.tensor([10, 300], dtype=torch.int32)
    caps = torch.tensor([100, 100], dtype=torch.int32)
    # lengths are clamped to the row, prefix first
    out, olen, cons = tds.encode_blocks_dest_size(
        rows, lens, caps, window_lens=torch.tensor([250, -5],
                                                   dtype=torch.int32))
    assert cons.tolist()[0] == 6 and cons.tolist()[1] == 256
    assert out.shape == (2, tds.out_width(256))
    with pytest.raises(ValueError):
        tds.encode_blocks_dest_size(rows[:, :200].contiguous(), lens, caps)
    with pytest.raises(ValueError):
        tds.encode_blocks_dest_size(
            torch.zeros((1, (1 << 18) + 128), dtype=torch.uint8), lens[:1],
            caps[:1])
    with pytest.raises(ValueError):
        tds.encode_blocks_dest_size(rows, lens[:1], caps)
    with pytest.raises(TypeError):
        tds.encode_blocks_dest_size(rows, lens.long(), caps)


# ---------------------------------------------------------------------------
# kernel H's parse as the card's warp runs it: rounds of 32 probes
# ---------------------------------------------------------------------------

_TEXT = functools.partial(gen_buffer, 30_000, 0.8)

# name: lambda -> (buffers, caps, prefixes, acceleration, min_match)
ROUND_CASES = {
    "text": lambda: ([gen_buffer(20_000, p, 40 + i)
                      for i, p in enumerate((0.5, 0.8, 0.95))],
                     [20_100, 6_000, 1_500], None, 1, 4),
    # long matches, and capacity stops inside them
    "zeros": lambda: ([bytes(30_000)] * 3, [30_200, 200, 40], None, 1, 4),
    # skip runs: scnt >> 6 reaches 2 and more
    "noise": lambda: ([noise_bytes(30_000, 1), noise_bytes(30_000, 2)
                       + _TEXT(2)[:5_000]], [30_200, 30_000], None, 1, 4),
    "slot_collisions": lambda: ([slot_collisions(20_000, s)
                                 for s in (1, 2)], [20_100, 4_000], None,
                                1, 4),
    "min_match_12_acceleration_7": lambda: (
        [_TEXT(3), slot_collisions(20_000, 3)], [30_100, 20_100], None, 7,
        12),
    "min_match_8_acceleration_2": lambda: (
        [_TEXT(4), _TEXT(5)[:20_000]], [30_100, 3_000], None, 2, 8),
    "rows_of_12_and_13_bytes": lambda: (
        [_TEXT(6)[:12], _TEXT(6)[:13], b"a" * 13, b"a" * 12],
        [100, 100, 100, 8], [b"", b"", b"", _TEXT(6)[:40]], 1, 4),
    "64k_prefixes": lambda: (
        [_TEXT(7)[20_000:28_000]] * 2 + [noise_bytes(8_000, 3)],
        [3_000, 9_000, 9_000], [_TEXT(7)[:20_000] + bytes(45_536)] * 2
        + [noise_bytes(65_536, 3)], 1, 4),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_model_matches_the_parse_and_jax(case):
    """``dest_size_block_rounds_plain`` gives, row for row, the blocks and
    consumed counts of ``_dest_size_block`` (the plain kernel H), which
    equal lz4_tpu's."""
    bufs, caps, prefixes, acc, mm = ROUND_CASES[case]()
    prefixes = prefixes or [b""] * len(bufs)
    serial = destsize_both(bufs, caps, prefixes, mm, acc)
    counts = collections.Counter()
    parse = functools.partial(tds.dest_size_block_rounds_plain,
                              counts=counts)
    for i, (src, pre, cap) in enumerate(zip(bufs, prefixes, caps)):
        block, consumed = tds.encode_dest_size_plain(
            pre + src, len(pre), len(src), cap, acc, mm, parse=parse)
        assert (consumed, block) == serial[i], i
    if case == "noise":         # skips of 2 bytes and more
        assert 0 < counts["probes"] < 30_000 // 2
    if case == "slot_collisions":
        assert counts["from_lane"] > 2 * counts["rounds"]
    if case == "zeros":         # matches of many ballots each
        assert counts["ballots"] > 100 * counts["sequences"] > 0
    if case == "text":
        assert 0 < counts["rounds"] < 2 * counts["sequences"]


def test_skip_sum_is_the_serial_advance():
    """The closed form every lane computes its probe position with."""
    for scnt in (64, 100, 127, 128, 448, 5_000, 70_000):
        ip = 0
        for k in range(40):
            assert tds._skip_sum(scnt, k) == ip
            ip += (scnt + k) >> tds.SKIP_TRIGGER


# ---------------------------------------------------------------------------
# kernel D: resumable mode and dictionary rows
# ---------------------------------------------------------------------------

def dest_size_decode_both(comps, clens, caps, out_cap_max, dicts=None):
    """Run both packages' resumable decoders and require equal out[:olen],
    olen and cons; returns (pieces, olen, cons)."""
    M = up128(max(map(len, comps)))
    arr = byte_lanes(comps, M)
    kw_j, kw_t = {}, {}
    if dicts is not None:
        P = up128(max(map(len, dicts)))
        d = byte_lanes(dicts, P, right=True)
        dl = i32(list(map(len, dicts)))
        kw_j = {"dict_rows": jnp.asarray(d), "dict_lens": jnp.asarray(dl)}
        kw_t = {"dict_rows": from_jax_lanes(d),
                "dict_lens": torch.from_numpy(dl)}
    j_out, j_olen, j_cons = map(np.asarray, jdec.decode_blocks_dest_size(
        jnp.asarray(arr), jnp.asarray(i32(clens)), jnp.asarray(i32(caps)),
        out_cap_max, **kw_j))
    t_out, t_olen, t_cons = tdec.decode_blocks_dest_size(
        from_jax_lanes(arr), torch.from_numpy(i32(clens)),
        torch.from_numpy(i32(caps)), out_cap_max, **kw_t)
    assert t_out.shape == (len(comps), out_cap_max)
    np.testing.assert_array_equal(t_olen.numpy(), j_olen)
    np.testing.assert_array_equal(t_cons.numpy(), j_cons)
    pieces = []
    for i, n in enumerate(j_olen.tolist()):
        n = max(n, 0)
        np.testing.assert_array_equal(to_jax_lanes(t_out[i, :n]),
                                      j_out[i, :n])
        pieces.append(t_out[i, :n].numpy().tobytes())
    return pieces, j_olen.tolist(), j_cons.tolist()


def test_dest_size_decode_every_cap_matches_jax():
    """Every capacity from 0 to the decoded length (and a little past it)
    on one block: each stop is at a token boundary, never in a sequence."""
    data = gen_buffer(600, 0.6, 17)
    comp = compress_block(data)
    caps = list(range(0, 640))
    pieces, olen, cons = dest_size_decode_both(
        [comp] * len(caps), [len(comp)] * len(caps), caps, 640)
    for cap, piece, n, c in zip(caps, pieces, olen, cons):
        assert 0 <= n <= cap and piece == data[:n]
        assert (c == len(comp)) == (n == len(data))
    assert olen[600] == 600 and olen[599] < 599 or data[-1:] == b""
    # the stops are monotone, and every full literal run counts as a stop
    assert cons == sorted(cons) and len(set(cons)) > 10


def test_dest_size_decode_resume_matches_jax():
    blocks = [gen_buffer(4096, 0.7, 70 + i) for i in range(3)]
    comps = [compress_block(b) for b in blocks]
    clens = list(map(len, comps))
    pieces, olen, cons = dest_size_decode_both(comps, clens, [4096] * 3, 4096)
    assert pieces == blocks and cons == clens
    caps = [1000, 2000, 3000]
    first, olen, cons = dest_size_decode_both(comps, clens, caps, 4096)
    for i, b in enumerate(blocks):
        assert 0 < olen[i] <= caps[i] and 0 < cons[i] < clens[i]
        assert first[i] == b[:olen[i]]
    # resume, all rows in one batch: the rest of each payload, with what
    # was produced as its dictionary row
    rests = [c[k:] for c, k in zip(comps, cons)]
    second, olen2, cons2 = dest_size_decode_both(
        rests, list(map(len, rests)), [4096] * 3, 4096, dicts=first)
    assert cons2 == list(map(len, rests))
    assert [a + b for a, b in zip(first, second)] == blocks
    # and once more in two steps, the second stop inside the dictionary era
    mid, olen3, cons3 = dest_size_decode_both(
        rests, list(map(len, rests)), [512] * 3, 4096, dicts=first)
    last, _, cons4 = dest_size_decode_both(
        [r[k:] for r, k in zip(rests, cons3)],
        [len(r) - k for r, k in zip(rests, cons3)], [4096] * 3, 4096,
        dicts=[a + b for a, b in zip(first, mid)])
    assert [a + b + c for a, b, c in zip(first, mid, last)] == blocks


def _token_ends(comp: bytes):
    """(offset after each match-carrying sequence, offset of its token)."""
    ends, i, n = [], 0, len(comp)
    while i < n:
        at, tok = i, comp[i]
        i += 1
        ll = tok >> 4
        if ll == 15:
            while True:
                b = comp[i]
                i += 1
                ll += b
                if b != 255:
                    break
        i += ll
        if i >= n:
            break
        i += 2
        if tok & 15 == 15:
            while comp[i] == 255:
                i += 1
            i += 1
        ends.append((i, at))
    return ends


def test_dest_size_decode_corruption_and_truncation_match_jax():
    data = gen_buffer(4096, 0.7, 70)
    comp = compress_block(data)
    bad = bytearray(comp)                   # offset 0 in the first sequence
    i0 = bad[0] >> 4
    bad[1 + i0] = bad[2 + i0] = 0
    ends = _token_ends(comp)
    after_match, token = ends[len(ends) // 2]
    cases = [bytes(bad),
             comp[:after_match],            # ends exactly after a match
             comp[:after_match - 1],        # cut inside a sequence
             comp[:token + 1],              # cut after a token: -1, or an
                                            # end when it has no literals
             comp[:1], b""]
    for caps in ([4096] * len(cases), [700] * len(cases)):
        pieces, olen, cons = dest_size_decode_both(
            cases, list(map(len, cases)), caps, 4096)
        assert (olen[0], cons[0]) == (-1, -1)
        assert olen[5] == 0 and cons[5] == 0
        if caps[0] == 4096:
            assert cons[1] == after_match and olen[1] > 0
            assert pieces[1] == data[:olen[1]]
            assert (olen[2], cons[2]) == (-1, -1)
        else:
            # the room runs out before the cut is reached: a clean stop
            assert all(0 < n <= 700 and 0 < c < after_match
                       for n, c in zip(olen[1:4], cons[1:4]))
    # the plain decoder, not resumable, rejects the block cut after a match
    out, olen = tdec.decode_blocks(
        from_jax_lanes(byte_lanes([cases[1]], up128(len(cases[1])))),
        torch.tensor([len(cases[1])], dtype=torch.int32), 4096)
    assert int(olen[0]) == -1


def test_dest_size_decode_noise_matches_jax():
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 300, 48)]
    dicts = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 128, 48)]
    # and valid blocks with a few bytes changed
    comp = compress_block(gen_buffer(400, 0.7, 9))
    for _ in range(16):
        row = bytearray(comp)
        for at in rng.integers(0, len(row), 2):
            row[at] = int(rng.integers(0, 256))
        rows.append(bytes(row))
        dicts.append(dicts[len(rows) % 48])
    caps = rng.integers(0, 513, len(rows)).tolist()
    _, olen, _ = dest_size_decode_both(rows, list(map(len, rows)), caps, 512,
                                       dicts=dicts)
    assert any(n < 0 for n in olen) and any(n > 0 for n in olen)


def spans_model_both(comps, clens, caps, out_cap_max, dicts=None,
                     span_log=2):
    """``dest_size_decode_both`` (lz4_tpu and the serial plain decoder),
    then the CPU model of kernel D's resumable schedule on the card
    (``decode_rows_spans_plain``: the walk, spans of 2^span_log sequences
    into cells, the rounds) on the same rows: equal olen, cons and bytes.
    Returns (pieces, olen, cons, the model's stats)."""
    pieces, olen, cons = dest_size_decode_both(comps, clens, caps,
                                               out_cap_max, dicts)
    kw = {}
    if dicts is not None:
        P = up128(max(map(len, dicts)))
        kw = {"dict_rows": from_jax_lanes(byte_lanes(dicts, P, right=True)),
              "dict_lens": torch.from_numpy(i32(list(map(len, dicts))))}
    stats = {}
    m_out, m_olen, m_cons = tdec.decode_rows_spans_plain(
        from_jax_lanes(byte_lanes(comps, up128(max(map(len, comps))))),
        torch.from_numpy(i32(clens)), out_cap_max,
        torch.from_numpy(i32(caps)), resumable=True, span_log=span_log,
        stats=stats, **kw)
    assert m_olen.tolist() == olen and m_cons.tolist() == cons
    for i, piece in enumerate(pieces):
        assert m_out[i, :len(piece)].numpy().tobytes() == piece
    return pieces, olen, cons, stats


def _reach_back_block(plen: int, k: int) -> bytes:
    """``k`` sequences of two literals and a 4-byte match at offset 3, then
    a 4-byte match reaching the first byte of a ``plen``-byte dictionary
    (offset = output so far + plen), then five literals: the dictionary is
    read from the span that holds sequence k."""
    out = b"".join(lz4_seq(b"q%d" % (i % 10), 3, 4) for i in range(k))
    return out + lz4_seq(b"", 6 * k + plen, 4) + lz4_seq(b"tail!")


def _resumable_cases(case):
    """(payloads, caps, out_cap_max, dictionaries or None) of one case of
    the resumable schedule's model."""
    text = gen_buffer(20_000, 0.7, 31)
    comp = compress_block(text[:4096])
    if case == "span_edges":
        # caps inside the first span, at span boundaries and one byte
        # either side (the spans of 2^2 sequences)
        _, _, spans, _ = tdec.walk_row_plain(comp, len(comp), 4096, 0,
                                             False, 2)
        caps = [1, 5, spans[1][1] - 1]
        for _, base in spans[1:8]:
            caps += [base - 1, base, base + 1]
        return [comp] * len(caps), caps, 4096, None
    if case == "dictionary":
        # dictionaries of 0, 1, a few KB and P bytes; matches into them from
        # later spans, real blocks written against a prefix
        P = 4096
        prefix = text[6000:6000 + P]
        comps, dicts = [], []
        for plen in (0, 1, 3000, P):
            comps.append(_reach_back_block(plen, 9) if plen else
                         compress_block(text[:3000]))
            dicts.append(prefix[P - plen:])
        for plen in (1, 3000, P):
            src = text[6000 + P - 500:6000 + P + 3000] + prefix[:plen]
            comps.append(compress_block(src, dict_=prefix[P - plen:]))
            dicts.append(prefix[P - plen:])
        caps = [8192] * len(comps)
        caps[-1] = caps[2] = 30         # stops in the first spans
        return comps, caps, 8192, dicts
    if case == "corrupt_around_stop":
        # a stop at the token at cons; a zero offset before it fails the
        # row, one after it is never read
        _, cons, _, _ = tdec.walk_row_plain(comp, len(comp), 1500, 0, True,
                                            2)
        ends = [e for e in _token_ends(comp)]
        before = bytearray(comp)
        after = bytearray(comp)
        for end, at in ends:
            tok = comp[at]
            lits = tok >> 4
            if lits < 15 and at + 1 + lits + 2 <= len(comp):
                off = at + 1 + lits
                if at < cons and end <= cons:
                    before[off] = before[off + 1] = 0
                elif at > cons:
                    after[off] = after[off + 1] = 0
        return [comp, bytes(before), bytes(after)], [1500] * 3, 4096, None
    if case == "truncated_empty":
        after_match, _ = _token_ends(comp)[len(_token_ends(comp)) // 2]
        comps = [comp[:after_match], comp[:after_match - 1], comp[:1], b"",
                 comp[:len(comp) // 3], comp]
        return comps, [4096, 4096, 4096, 4096, 4096, 2000], 4096, None
    rng = np.random.default_rng(8)                      # "noise"
    comps = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 400, 16)]
    dicts = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 200, 16)]
    return comps, rng.integers(0, 600, 16).tolist(), 512, dicts


@pytest.mark.parametrize("span_log", [0, 2, 7])
@pytest.mark.parametrize("case", ["span_edges", "dictionary",
                                  "corrupt_around_stop", "truncated_empty",
                                  "noise"])
def test_rows_spans_model_resumable_matches_serial_and_jax(case, span_log):
    comps, caps, out_cap_max, dicts = _resumable_cases(case)
    pieces, olen, cons, stats = spans_model_both(
        comps, list(map(len, comps)), caps, out_cap_max, dicts, span_log)
    if case == "span_edges":
        assert all(0 <= n <= c for n, c in zip(olen, caps))
        assert len(set(cons)) > 10
    elif case == "dictionary":
        assert olen[:2] == [3000, 63] and olen[3] == 63
        assert olen[4:6] == [3501, 6500] and cons[4:6] == list(
            map(len, comps[4:6]))
        assert 0 < olen[2] <= 30 and 0 < olen[6] <= 30
        # the reach into the dictionary lies in the third span or later
        assert stats["row_spans"][1] == (3 if span_log == 2 else
                                         11 if span_log == 0 else 1)
    elif case == "corrupt_around_stop":
        assert comps[2] != comps[0] and comps[2][:cons[0]] == comps[0][
            :cons[0]]
        assert (olen[0], cons[0]) == (olen[2], cons[2]) and olen[0] > 0
        assert (olen[1], cons[1]) == (-1, -1)
    elif case == "truncated_empty":
        assert cons[0] == len(comps[0]) and olen[0] > 0
        assert (olen[1], cons[1]) == (-1, -1)
        assert (olen[3], cons[3]) == (0, 0)


def _dict_block(plen: int, reach: int) -> bytes:
    """One literal, then a 4-byte match ``reach`` bytes before the start of
    the output, then five literals: valid iff reach <= plen."""
    return bytes([0x10]) + b"a" + (reach + 1).to_bytes(2, "little") + \
        bytes([0x50]) + b"hello"


def test_decode_blocks_dict_rows_match_jax():
    """decode_blocks with right-aligned dictionary rows: lengths 0, 1, 100
    and P, blocks written against a prefix, an offset that reaches the
    dictionary's first byte and one that reaches one past it."""
    base = gen_buffer(6_000, 0.8, 23)
    P = 1024
    dicts, comps, want = [], [], []
    for plen in (0, 1, 100, P):
        prefix, src = base[1500 - plen:1500], base[1400:5000]
        (consumed, block), = destsize_both([src], [8_000], prefixes=[prefix])
        assert consumed == len(src)
        dicts.append(prefix)
        comps.append(block)
        want.append(src)
    for plen in (1, 100, P):
        for reach, ok in ((plen, True), (plen + 1, False)):
            dicts.append(base[:plen])
            comps.append(_dict_block(plen, reach))
            want.append(b"a" + (base[:plen] + b"a")[:4].ljust(4, b"a")[:4]
                        + b"hello" if ok else None)
    M = up128(max(map(len, comps)))
    arr, d = byte_lanes(comps, M), byte_lanes(dicts, P, right=True)
    clens, dlens = i32(list(map(len, comps))), i32(list(map(len, dicts)))
    for out_caps in (None, i32([len(w) if w else 10 for w in want])):
        kj = {} if out_caps is None else {"out_caps": jnp.asarray(out_caps)}
        kt = {} if out_caps is None else \
            {"out_caps": torch.from_numpy(out_caps)}
        j_out, j_olen = map(np.asarray, jdec.decode_blocks(
            jnp.asarray(arr), jnp.asarray(clens), 3712, jnp.asarray(d),
            jnp.asarray(dlens), **kj))
        t_out, t_olen = tdec.decode_blocks(
            from_jax_lanes(arr), torch.from_numpy(clens), 3712,
            dict_rows=from_jax_lanes(d), dict_lens=torch.from_numpy(dlens),
            **kt)
        np.testing.assert_array_equal(t_olen.numpy(), j_olen)
        for i, w in enumerate(want):
            if w is None:
                assert int(t_olen[i]) == -1
                continue
            assert int(t_olen[i]) == len(w)
            np.testing.assert_array_equal(to_jax_lanes(t_out[i, :len(w)]),
                                          j_out[i, :len(w)])
            if i < 4:
                assert t_out[i, :len(w)].numpy().tobytes() == w


def test_decode_blocks_clamps_and_checks_dict_arguments():
    comp = _dict_block(4, 4)
    rows = from_jax_lanes(byte_lanes([comp, comp], 128))
    lens = torch.tensor([len(comp)] * 2, dtype=torch.int32)
    d = from_jax_lanes(byte_lanes([b"wxyz", b"wxyz"], 8, right=True))
    # dict_lens are clamped to [0, P]: 99 reads as 8, -1 as 0
    out, olen = tdec.decode_blocks(
        rows, lens, 64, dict_rows=d,
        dict_lens=torch.tensor([99, -1], dtype=torch.int32))
    assert olen.tolist() == [10, -1]
    assert out[0, :10].numpy().tobytes() == b"awxyzhello"
    with pytest.raises(ValueError):
        tdec.decode_blocks(rows, lens, 64, dict_rows=d)
    with pytest.raises(ValueError):
        tdec.decode_blocks(rows, lens, 64, dict_lens=lens)
    with pytest.raises(ValueError):
        tdec.decode_blocks(rows, lens, 64, dict_rows=d[:1], dict_lens=lens)
    with pytest.raises(TypeError):
        tdec.decode_blocks_dest_size(rows, lens, lens.long(), 64)


def test_dest_size_decode_caps_at_out_cap_max():
    """The port never produces more than out_cap_max bytes; the JAX function
    rounds out_cap_max up to 128 first (ROADMAP.md, Queue 3)."""
    data = gen_buffer(600, 0.6, 17)
    comp = compress_block(data)
    arr = byte_lanes([comp], up128(len(comp)))
    args = (i32([len(comp)]), i32([600]))
    j_out, j_olen, _ = jdec.decode_blocks_dest_size(
        jnp.asarray(arr), *map(jnp.asarray, args), 400)
    t_out, t_olen, t_cons = tdec.decode_blocks_dest_size(
        from_jax_lanes(arr), *map(torch.from_numpy, args), 400)
    assert 400 < int(np.asarray(j_olen)[0]) <= 512 and j_out.shape == (1, 400)
    assert 0 < int(t_olen[0]) <= 400 and t_out.shape == (1, 400)
    assert t_out[0, :int(t_olen[0])].numpy().tobytes() == \
        data[:int(t_olen[0])]
    assert 0 < int(t_cons[0]) < len(comp)


# ---------------------------------------------------------------------------
# the batch hooks of block.py, and the example
# ---------------------------------------------------------------------------

def test_block_batch_hooks_match_jax():
    bufs = [gen_buffer(65536, p, 10 + i)
            for i, p in enumerate((0.5, 0.7, 0.9))] + [b"tail-block", b""]
    comps = tblock.compress_batch(bufs, device="cpu")
    assert comps == jblock.compress_batch(bufs)
    lens = [len(b) for b in bufs]
    outs = tblock.decompress_batch(comps, 65536, out_lens=lens, device="cpu")
    assert outs == bufs == jblock.decompress_batch(comps, 65536,
                                                   out_lens=lens)
    assert tblock.decompress_batch(comps, 65536, device="cpu") == bufs
    assert tblock.compress_batch(bufs[:2], min_match=8, acceleration=2,
                                 device="cpu") == \
        jblock.compress_batch(bufs[:2], acceleration=2, min_match=8)


def test_block_batch_hooks_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tblock.compress_batch([b"abc"])
    with pytest.raises(RuntimeError, match="cuda"):
        tblock.decompress_batch([b"\x30abc"], 16)


def test_example_resumes_on_the_cpu():
    script = REPO / "examples" / "torch_port" / "dest_size_resume_torch.py"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, str(script), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "equal to the input" in res.stdout
    if not torch.cuda.is_available():
        res = subprocess.run([sys.executable, str(script)], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and "cuda" in res.stderr
