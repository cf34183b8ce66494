"""Kernel A's adaptive mode: a min_match per block (``mm_rows``).

The port's ``encode_blocks_linked(..., mm_rows=)`` against lz4_tpu's in
interpret mode, byte for byte, with and without a 64 KB prefix; the
candidate tables, which the port builds over ``[window | K blocks]`` tiles
with a threshold per sorted slot, against lz4_tpu's per-block ``[window |
block]`` rows, also where the two layouts read different bytes (a query in
its block's first 3 lanes whose candidate lies 65,533-65,535 back);
``cand_frac8_rows`` against lz4_tpu's, exactly (tolerance 0: a mean of
booleans); the card's three phases modelled with each block's own
min_match; and the round trip through the port's linked decoder.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lz4_tpu.kernels import encode_kernel as jenc
from lz4_tpu.tpu import fetch_byte_rows, linked_val_rows
from lz4_tpu.utils.datagen import gen_buffer
from lz4_tpu_torch.kernels import decode_kernel as tdec
from lz4_tpu_torch.kernels import encode_kernel as tenc

from .test_torch_encode import model_block
from .test_torch_kernels import _assert_rows_equal, stdlib_text, val32

W = 65536
MIXED = [[4, 12, 8]]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream(data: bytes, prefix: bytes = b""):
    """The port's one-stream input for ``data`` behind ``prefix``:
    (stream [1, (NB+1)*W] uint8, lens [1, NB], prefix_lens [1])."""
    nb = -(-len(data) // W)
    flat = np.zeros(((nb + 1) * W,), np.uint8)
    flat[W - len(prefix):W] = np.frombuffer(prefix, np.uint8)
    flat[W:W + len(data)] = np.frombuffer(data, np.uint8)
    lens = [[min(W, len(data) - k * W) for k in range(nb)]]
    return (torch.from_numpy(flat[None]),
            torch.tensor(lens, dtype=torch.int32),
            torch.tensor([len(prefix)], dtype=torch.int32))


def _jax_rows(stream: torch.Tensor) -> np.ndarray:
    """lz4_tpu's per-block rows [1, NB, 2W] of val32 lanes for the port's
    stream: row k is ``[window | block k]``, wrapping at its end."""
    flat = stream[0].numpy()
    nb = len(flat) // W - 1
    rows = np.stack([flat[k * W:(k + 2) * W] for k in range(nb)])
    return val32(rows).reshape(1, nb, 2 * W)


def _jax_tables(stream: torch.Tensor, mm_rows) -> np.ndarray:
    """lz4_tpu's candidate deltas in adaptive mode
    (``_encode_blocks_linked(..., dynamic_mm=True)``): each per-block row
    filtered at its block's min_match, the block lanes kept, the last 12
    zeroed."""
    rows = _jax_rows(stream)
    nb = rows.shape[1]
    d = jenc.cand_delta_rows(jnp.asarray(rows.reshape(nb, 2 * W)),
                             jnp.asarray(np.asarray(mm_rows, np.int32)
                                         .reshape(-1)))
    d = np.asarray(d)[:, W:].copy()
    d[:, W - 12:] = 0
    return d


# ---------------------------------------------------------------------------
# cand_frac8_rows
# ---------------------------------------------------------------------------

def _frac8_rows(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "gen_buffer":      # the blocks tests/test_kernels.py uses
        data = np.frombuffer(gen_buffer(3 * W, 0.8, 123), np.uint8)
        return data.reshape(3, W)
    if kind == "noise":
        return rng.integers(0, 256, (4, W), dtype=np.uint8)
    if kind == "zeros":
        return np.zeros((2, W), np.uint8)
    if kind == "text":
        return np.frombuffer(stdlib_text(2 * W), np.uint8).reshape(2, W)
    if kind == "short":           # rows shorter than the 65535 reach
        return np.frombuffer(stdlib_text(8 * 4099), np.uint8).reshape(8, -1)
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["gen_buffer", "noise", "zeros", "text",
                                  "short"])
def test_cand_frac8_rows_equals_jax(kind):
    """Equal to lz4_tpu's statistic exactly (tolerance 0) on the same
    rows' val32 lanes, which wrap at the row end."""
    rows = _frac8_rows(kind)
    want = np.asarray(jenc.cand_frac8_rows(jnp.asarray(val32(rows))))
    got = tenc.cand_frac8_rows(torch.from_numpy(rows.copy()))
    assert got.dtype == torch.float32 and got.shape == (len(rows),)
    assert (got.numpy() == want).all(), (got, want)
    if kind == "zeros":
        assert (got.numpy() == 1).all()
    if kind == "noise":
        assert (got.numpy() < 1e-3).all()


def test_cand_frac8_rows_checks_its_rows():
    with pytest.raises(TypeError):
        tenc.cand_frac8_rows(torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        tenc.cand_frac8_rows(torch.zeros((64,), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mm_rows,prefix", [
    (MIXED, 0), (MIXED, W), ([[12, 4, 6]], 20_000), ([[5, 7, 11]], 0)])
def test_tables_equal_jax_per_block_rows(mm_rows, prefix):
    data = gen_buffer(3 * W, 0.8, 123)
    pre = gen_buffer(prefix + 10, 0.6, 9)[10:] if prefix else b""
    stream, _, _ = _stream(data, pre)
    mm = torch.tensor(mm_rows, dtype=torch.int32)
    delta, jump = tenc.linked_tables(stream, 3, 4, None, mm)
    assert (delta.numpy() == _jax_tables(stream, mm_rows)).all()
    # the jump table is the one the filtered deltas give
    ref = tenc._next_candidate(delta)[:, ::4]
    assert torch.equal(jump, ref)


def _planted(nb: int, k: int, j: int, w: int, wrap: bool, seed: int):
    """Noise in which block k's lane j repeats the 5 bytes at lane w of its
    window (65536 + j - w back), byte +5 differs, and the 4 bytes before
    agree with the candidate's -4 lane as a per-block row reads it
    (``wrap``: past the window's start it wraps to the block's last bytes)
    or as the stream holds it (the tiles' reading)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 256, ((nb + 1) * W,), dtype=np.uint8)
    p, c = (k + 1) * W + j, k * W + w
    flat[p:p + 5] = flat[c:c + 5]
    flat[p + 5] = flat[c + 5] ^ 0x5A
    for m in range(1, 5):
        if c - m >= k * W or wrap:
            at = c - m if c - m >= k * W else c - m + 2 * W
            flat[p - m] = flat[at]
        else:
            flat[p - m] = flat[c - m]
    return torch.from_numpy(flat[None].copy())


# (blocks, block, lane, window lane, which reading agrees)
PLANTS = [(3, 1, 0, 2, True), (3, 1, 0, 2, False), (3, 2, 1, 3, True),
          (3, 2, 2, 3, False), (8, 6, 0, 1, True), (8, 6, 0, 3, False),
          (8, 7, 1, 2, True), (1, 0, 2, 3, True)]


@pytest.mark.parametrize("nb,k,j,w,wrap", PLANTS,
                         ids=[f"nb{c[0]}-b{c[1]}-lane{c[2]}-win{c[3]}-"
                              f"{'wrap' if c[4] else 'real'}"
                              for c in PLANTS])
def test_tables_equal_jax_where_the_layouts_read_apart(nb, k, j, w, wrap):
    """The one pair of lanes where a tile and a per-block row read
    different bytes: the tables still equal lz4_tpu's per-block deltas.
    Where the per-block row's wrap agrees and the tile's bytes do not, the
    static tiles (one min_match) drop the candidate that adaptive mode
    keeps."""
    stream = _planted(nb, k, j, w, wrap, seed=nb * 100 + k * 10 + j + w)
    mm_rows = [[12 if b == k else (4, 8)[b % 2] for b in range(nb)]]
    delta, _ = tenc.linked_tables(stream, nb, 4, None,
                                  torch.tensor(mm_rows, dtype=torch.int32))
    ref = _jax_tables(stream, mm_rows)
    assert (delta.numpy() == ref).all()
    d = W + j - w
    assert int(delta[k, j]) == (d if wrap else 0)
    if wrap and k > 0:
        static, _ = tenc.linked_tables(stream, nb, 12)
        assert int(static[k, j]) == 0


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mm", [4, 8, 12])
def test_uniform_mm_rows_reproduce_the_static_bytes(mm):
    for data in (gen_buffer(3 * W, 0.8, 123), stdlib_text(2 * W + 5000)):
        stream, lens, pre = _stream(data)
        static = tenc.encode_blocks_linked(stream, lens, min_match=mm,
                                           reject_step=3)
        mmr = torch.full(lens.shape, mm, dtype=torch.int32)
        adaptive = tenc.encode_blocks_linked(stream, lens, min_match=4,
                                             reject_step=3, mm_rows=mmr)
        assert torch.equal(static[1], adaptive[1])
        for r, n in enumerate(static[1].reshape(-1).tolist()):
            assert torch.equal(static[0].reshape(len(lens[0]), -1)[r, :n],
                               adaptive[0].reshape(len(lens[0]), -1)[r, :n])


@pytest.mark.parametrize("prefix,rs", [(0, 3), (W, 3), (0, 1), (W, 2)])
def test_mixed_mm_rows_equal_jax(prefix, rs):
    """``mm_rows=[[4, 12, 8]]`` on gen_buffer(3 * 65536, 0.8, 123), as
    tests/test_kernels.py runs lz4_tpu, and behind a 64 KB prefix: the
    port's bytes and lengths are lz4_tpu's (interpret mode)."""
    data = gen_buffer(3 * W, 0.8, 123)
    pre = stdlib_text(W) if prefix else b""
    stream, lens, pre_t = _stream(data, pre)
    mmr = torch.tensor(MIXED, dtype=torch.int32)
    t_out, t_olen = tenc.encode_blocks_linked(stream, lens, reject_step=rs,
                                              prefix_lens=pre_t,
                                              mm_rows=mmr)
    if prefix:
        val = jnp.asarray(_jax_rows(stream))
    else:
        val, _ = linked_val_rows(data, 1, 3)
    j_out, j_olen = jenc.encode_blocks_linked(
        val, jnp.asarray(lens.numpy()), reject_step=rs,
        prefix_lens=jnp.asarray(pre_t.numpy()),
        mm_rows=jnp.asarray(MIXED, jnp.int32))
    _assert_rows_equal(fetch_byte_rows(j_out.reshape(3, -1)), j_olen,
                       t_out, t_olen)
    # each block's floor holds: no match shorter than its min_match
    out = t_out.reshape(3, -1)
    for k, mm in enumerate(MIXED[0]):
        assert min(_match_lengths(out[k, :int(t_olen[0, k])].numpy()
                                  .tobytes()), default=mm) >= mm


def _match_lengths(block: bytes):
    ip, out = 0, []
    while ip < len(block):
        tok = block[ip]
        ip += 1
        lit = tok >> 4
        if lit == 15:
            while True:
                lit += block[ip]
                ip += 1
                if block[ip - 1] != 255:
                    break
        ip += lit
        if ip >= len(block):
            break
        ip += 2
        ml = tok & 15
        if ml == 15:
            while True:
                ml += block[ip]
                ip += 1
                if block[ip - 1] != 255:
                    break
        out.append(ml + 4)
    return out


@pytest.mark.parametrize("prefix", [0, W])
def test_three_phases_with_a_min_match_per_block(prefix):
    """The card's phases (probe words, walks joined at shared match ends,
    emission), modelled with each block's own min_match, give the plain
    scan's payloads."""
    data = stdlib_text(3 * W + 777)
    pre = gen_buffer(W, 0.7, 3) if prefix else b""
    stream, lens, pre_t = _stream(data, pre)
    mm = [[8, 4, 12, 6]]
    mmr = torch.tensor(mm, dtype=torch.int32)
    delta, jump = tenc.linked_tables(stream, 4, 4, None, mmr)
    out, olen = tenc.scan_linked(stream, lens, pre_t, delta, jump, 1, 4, 1,
                                 mm_rows=mmr)
    for k in range(4):
        start = (k + 1) * W
        low = start - (len(pre) if k == 0 else W)
        ip = start + (0 if start - low else 1)
        payload, _ = model_block(stream[0], start, int(lens[0, k]), low, ip,
                                 delta[k], jump[k], True, 1, mm[0][k], 1)
        assert payload == out[0, k, :int(olen[0, k])].numpy().tobytes(), k


def test_round_trip_through_the_linked_decoder():
    data = stdlib_text(5 * W + 1234)
    stream, lens, pre = _stream(data)
    mmr = torch.tensor([[4, 6, 8, 12, 16, 5]], dtype=torch.int32)
    out, olen = tenc.encode_blocks_linked(stream, lens, min_match=8,
                                          mm_rows=mmr)
    dout, dlen = tdec.decode_blocks_linked(out[0], olen[0], W)
    assert dlen.tolist() == lens[0].tolist()
    got = b"".join(dout[k, :n].numpy().tobytes()
                   for k, n in enumerate(dlen.tolist()))
    assert got == data


def test_mm_rows_argument_checks():
    stream, lens, pre = _stream(gen_buffer(2 * W, 0.5, 1))
    bad = [
        (torch.tensor([[4, 8, 8]], dtype=torch.int32), ValueError),  # shape
        (torch.tensor([4, 8], dtype=torch.int32), ValueError),       # rank
        (torch.tensor([[4, 8]], dtype=torch.int64), TypeError),      # dtype
        (torch.empty((1, 2), dtype=torch.int32, device="meta"),      # device
         ValueError),
    ]
    delta, jump = tenc.linked_tables(stream, 2)
    for mmr, err in bad:
        with pytest.raises(err):
            tenc.encode_blocks_linked(stream, lens, mm_rows=mmr)
        with pytest.raises(err):
            tenc.scan_linked(stream, lens, pre, delta, jump, mm_rows=mmr)


def test_the_wrapper_hands_mm_rows_to_the_kernel(monkeypatch):
    """On the card the wrapper passes ``mm_rows`` (or a null pointer) to
    ``lz4tt_encode_linked`` in the place its C signature gives it; the
    library, the device guard and the stream are stubbed, the kernel path
    forced on CPU tensors."""
    import contextlib

    from lz4_tpu_torch.kernels import build

    calls = []

    class Lib:
        def lz4tt_encode_linked(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "kernels_lib", lambda: Lib())
    monkeypatch.setattr(tenc, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tenc, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    stream, lens, pre = _stream(gen_buffer(2 * W, 0.5, 1))
    mmr = torch.tensor([[6, 9]], dtype=torch.int32)
    tenc.encode_blocks_linked(stream, lens, min_match=5, mm_rows=mmr)
    tenc.encode_blocks_linked(stream, lens, min_match=5)
    names = build._SIGNATURES["lz4tt_encode_linked"]
    assert [len(a) for a in calls] == [len(names)] * 2
    at = len(names) - 3                  # min_match, mm_rows, reject_step
    assert calls[0][at - 1:at + 2] == (5, mmr.data_ptr(), 1)
    assert calls[1][at - 1:at + 2] == (5, None, 1)
