"""The port's kernels (lz4_tpu_torch.kernels) held against lz4_tpu's.

Both packages get the same bytes (numpy seeds, stdlib text, datagen); the
JAX side runs in interpret mode as its own tests run it, the port through
its kernels' plain versions (CPU tensors).  Codec outputs are integers, so
every comparison is exact: lengths, statuses and ``out[:olen]`` bytes.
"""

import functools
import sysconfig
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu.kernels import decode_kernel as jdec
from lz4_tpu.kernels import encode_kernel as jenc
from lz4_tpu.kernels.pack_kernel import pack_frame_payloads as jpack
from lz4_tpu.ops.block_np import compress_block
from lz4_tpu.tpu import fetch_byte_rows, linked_val_rows
from lz4_tpu.utils.datagen import gen_buffer
from lz4_tpu_torch.kernels import common
from lz4_tpu_torch.kernels import decode_kernel as tdec
from lz4_tpu_torch.kernels import encode_kernel as tenc
from lz4_tpu_torch.kernels import pack_kernel as tpk
from lz4_tpu_torch.kernels.pack_kernel import pack_frame_payloads as tpack

from .test_adversarial_kernel import _cases as adversarial_cases
from .test_fuzz import cycle_params

W = 65536


@functools.lru_cache(maxsize=None)
def stdlib_text(n: int) -> bytes:
    """The first ``n`` bytes of the Python stdlib sources, in sorted order
    (the way bench.py builds its corpus)."""
    parts, size = [], 0
    for p in sorted(Path(sysconfig.get_paths()["stdlib"]).rglob("*.py")):
        parts.append(p.read_bytes())
        size += len(parts[-1])
        if size >= n:
            break
    return b"".join(parts)[:n]


def mixed_stream(n: int, seed: int) -> bytes:
    """Text, datagen mixes, a zero run and random bytes, ``n`` bytes."""
    data = _mixed_base(seed)
    return (data * (n // len(data) + 1))[:n]


@functools.lru_cache(maxsize=None)
def _mixed_base(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    text = stdlib_text(220_000)
    parts = [text[:150_000], gen_buffer(100_000, 0.6, seed), bytes(40_000),
             rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes(),
             gen_buffer(80_000, 0.9, seed + 1), text[150_000:],
             bytes(7000), rng.integers(0, 4, 20_000, dtype=np.uint8).tobytes()]
    return b"".join(parts)


def val32(rows_u8: np.ndarray) -> np.ndarray:
    """[..., N] uint8 rows -> int32 val32 lanes (wrapping at the row end),
    the JAX package's layout."""
    ext = np.concatenate([rows_u8, rows_u8[..., :3]], -1).astype(np.int64)
    v = ext[..., :-3] | ext[..., 1:-2] << 8 | ext[..., 2:-1] << 16 \
        | ext[..., 3:] << 24
    return v.astype(np.uint32).view(np.int32)


def _rows(buffers, width=None):
    width = width or -(-max(max(map(len, buffers)), 1) // 128) * 128
    arr = np.zeros((len(buffers), width), np.uint8)
    lens = np.zeros((len(buffers),), np.int32)
    for i, b in enumerate(buffers):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


def _assert_rows_equal(j_out, j_olen, t_out, t_olen):
    j_olen = np.asarray(j_olen).reshape(-1)
    t_olen = t_olen.numpy().reshape(-1)
    assert (j_olen == t_olen).all(), (j_olen, t_olen)
    j_out = np.asarray(j_out).reshape(len(j_olen), -1)
    t_out = t_out.numpy().reshape(len(t_olen), -1)
    for i, n in enumerate(j_olen):
        if n > 0:
            assert (j_out[i, :n].astype(np.uint8) == t_out[i, :n]).all(), i


# ---------------------------------------------------------------------------
# candidate table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_mm", [None, 8])
def test_cand_delta_rows_matches_jax(filter_mm):
    data = mixed_stream(2 * 3 * W, 11)
    rows = np.frombuffer(data, np.uint8).reshape(2, 3 * W)
    v = val32(rows)
    jf = None if filter_mm is None else jnp.full((2,), filter_mm, jnp.int32)
    want = np.asarray(jenc.cand_delta_rows(jnp.asarray(v), jf))
    got = tenc.cand_delta_rows(torch.from_numpy(v), filter_mm).numpy()
    assert (want == got).all()


# ---------------------------------------------------------------------------
# kernel A: linked blocks
# ---------------------------------------------------------------------------

NB = 9                               # 8 blocks and a partial: two K=6 tiles
LINKED_DATA_LEN = 8 * W + 20_011


@pytest.mark.parametrize("prefix", [0, W])
@pytest.mark.parametrize("mm,rs,acc", [(4, 1, 1), (8, 1, 1), (8, 3, 1),
                                       (4, 1, 4)])
def test_encode_blocks_linked_matches_jax(mm, rs, acc, prefix):
    data = mixed_stream(LINKED_DATA_LEN, 5)
    pre = mixed_stream(prefix, 77) if prefix else b""
    stream = np.zeros(((NB + 1) * W,), np.uint8)
    stream[W - prefix:W] = np.frombuffer(pre, np.uint8)
    stream[W:W + len(data)] = np.frombuffer(data, np.uint8)
    if prefix:
        # [previous block | block] rows built on the host, as the JAX
        # package's DeviceFrameCompressor does for a prefixed remainder
        rows = np.stack([stream[k * W:(k + 2) * W] for k in range(NB)])
        val = jnp.asarray(val32(rows)).reshape(1, NB, 2 * W)
        lens = np.array([[min(W, len(data) - k * W) for k in range(NB)]],
                        np.int32)
    else:
        val, lens = linked_val_rows(data, 1, NB)
    j_out, j_olen = jenc.encode_blocks_linked(
        val, jnp.asarray(lens), acc, prefix_lens=jnp.asarray([prefix]),
        min_match=mm, reject_step=rs)
    t_out, t_olen = tenc.encode_blocks_linked(
        torch.from_numpy(stream).reshape(1, -1), torch.from_numpy(lens), acc,
        prefix_lens=torch.tensor([prefix], dtype=torch.int32), min_match=mm,
        reject_step=rs)
    _assert_rows_equal(fetch_byte_rows(j_out[0]), j_olen, t_out, t_olen)


def test_encode_blocks_linked_zeroed_window_lanes_match_jax():
    """A partial prefix with the chunked window builder's lane zeroing."""
    from lz4_tpu.tpu import _chunk_windows
    nb, plen = 7, 30_000
    data = mixed_stream(nb * W, 9)
    prefix = mixed_stream(plen, 10)
    tail = np.zeros((W,), np.uint8)
    tail[W - plen:] = np.frombuffer(prefix, np.uint8)
    packed = np.frombuffer(data, np.uint8).reshape(nb, W).view("<i4")
    val = _chunk_windows(jnp.asarray(packed),
                         jnp.asarray(tail.view("<i4").reshape(1, -1)),
                         jnp.int32(plen), NB=nb, BS=W)
    lens = np.full((1, nb), W, np.int32)
    j_out, j_olen = jenc.encode_blocks_linked(
        val, jnp.asarray(lens), 1, prefix_lens=jnp.asarray([plen]),
        min_match=8)
    stream = torch.from_numpy(np.concatenate(
        [tail, np.frombuffer(data, np.uint8)])).reshape(1, -1)
    t_out, t_olen = tenc.encode_blocks_linked(
        stream, torch.from_numpy(lens), 1,
        prefix_lens=torch.tensor([plen], dtype=torch.int32), min_match=8,
        zero_window_lanes=True)
    _assert_rows_equal(fetch_byte_rows(j_out[0]), j_olen, t_out, t_olen)


# ---------------------------------------------------------------------------
# kernel B: independent rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mm", [4, 8])
def test_encode_blocks_matches_jax(mm):
    text = stdlib_text(W)
    rng = np.random.default_rng(3)
    bufs = [text, gen_buffer(40_000, 0.7, 8), bytes(5000),
            rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(), b"",
            b"x" * 13, mixed_stream(W, 4)[:61_234]]
    arr, lens = _rows(bufs, W)
    j_out, j_olen = jenc.encode_blocks(jnp.asarray(val32(arr)),
                                       jnp.asarray(lens), 1, min_match=mm)
    t_out, t_olen = tenc.encode_blocks(torch.from_numpy(arr),
                                       torch.from_numpy(lens), 1,
                                       min_match=mm)
    _assert_rows_equal(fetch_byte_rows(j_out), j_olen, t_out, t_olen)


# ---------------------------------------------------------------------------
# kernel C: pack
# ---------------------------------------------------------------------------

def test_pack_frame_payloads_matches_jax():
    rng = np.random.default_rng(21)
    B, M, NS = 7, 512, 384
    comp = rng.integers(0, 256, (B, M)).astype(np.int32)
    plain = rng.integers(0, 256, (B, NS)).astype(np.int32)
    blens = np.array([384, 300, 384, 1, 200, 0, 0], np.int32)
    # rows 1 and 3 are stored (payload not smaller than the block); the
    # last two are padding rows
    olen = np.array([100, 300, 17, 5, 199, 1, 0], np.int32)
    j_flat, j_total, j_stored = jpack(jnp.asarray(comp), jnp.asarray(olen),
                                      jnp.asarray(plain), blens)
    t_flat, t_total, t_stored = tpack(
        common.from_jax_lanes(comp), torch.from_numpy(olen),
        common.from_jax_lanes(plain), blens)
    assert tpk.body_length(t_total) == j_total
    assert (t_stored.numpy() == j_stored).all()
    want = np.asarray(j_flat).reshape(-1)[:j_total].astype(np.uint8)
    assert (t_flat[:j_total].numpy() == want).all()


PROLOGUE_CASES = {
    # (olen, blens, M, NS): stored rows, padding rows, an empty batch
    "stored and padding": ([100, 300, 17, 5, 199, 1, 0],
                           [384, 300, 384, 1, 200, 0, 0], 512, 384),
    "40 rows": (list(np.random.default_rng(23).integers(0, 300, 40)),
                list(np.random.default_rng(24).integers(0, 257, 40)), 384,
                256),
    "padding only": ([0, 3], [0, 0], 128, 128),
    "empty": ([], [], 128, 128),
    # lengths outside their rows: a fault (lz4_tpu has no such check)
    "olen past M": ([200, 5], [250, 20], 128, 256),
    "negative olen": ([-1, 5], [10, 20], 128, 256),
    "blen past NS": ([5, 5], [10, 300], 128, 256),
    "negative blen": ([5, 5], [10, -4], 128, 256),
}


@pytest.mark.parametrize("case", sorted(PROLOGUE_CASES))
def test_pack_prologue_plain_matches_jax_bookkeeping(case):
    """Kernel C's first launch, modelled: stored flags, record offsets,
    headers and the total equal what lz4_tpu's pack writes; a length
    outside its row sets the fault flag, and the CPU wrapper raises."""
    olen, blens, M, NS = PROLOGUE_CASES[case]
    olen = np.asarray(olen, np.int32)
    blens = np.asarray(blens, np.int32)
    stored, eff, hdr, dst, total = tpk.pack_prologue_plain(
        torch.from_numpy(olen), torch.from_numpy(blens), M, NS)
    fault = case in ("olen past M", "negative olen", "blen past NS",
                     "negative blen")
    assert total.dtype == torch.int64 and total[1] == int(fault)
    if fault:
        with pytest.raises(ValueError, match="exceeds its row"):
            tpk.body_length(total)
        return
    B = len(olen)
    if B == 0:
        assert total.tolist() == [0, 0]
        return
    rng = np.random.default_rng(25)
    comp = rng.integers(0, 256, (B, M)).astype(np.int32)
    plain = rng.integers(0, 256, (B, NS)).astype(np.int32)
    j_flat, j_total, j_stored = jpack(jnp.asarray(comp), jnp.asarray(olen),
                                      jnp.asarray(plain), blens)
    assert tpk.body_length(total) == j_total
    assert (stored.numpy() == j_stored).all()
    body = np.asarray(j_flat).reshape(-1)[:j_total].astype(np.uint8)
    pos = 0
    for b in range(B):
        assert dst[b] == pos
        if blens[b] <= 0:
            assert eff[b] == 0
            continue
        head = int.from_bytes(body[pos:pos + 4].tobytes(), "little")
        assert int(hdr[b]) & 0xFFFFFFFF == head
        assert int(eff[b]) == head & ~0x80000000
        pos += 4 + int(eff[b])
    assert pos == j_total


# ---------------------------------------------------------------------------
# kernel D: decode
# ---------------------------------------------------------------------------

def _linked_payloads(data: bytes, bs: int):
    blocks = [data[i:i + bs] for i in range(0, len(data), bs)]
    return blocks, [compress_block(b, dict_=(blocks[i - 1] if i else b""))
                    for i, b in enumerate(blocks)]


def _linked_model(arr, lens, bs, window_len):
    """Kernel D's linked statuses as the card works them out: every block's
    summary with its window assumed present, then the in-order rule."""
    parsed = [tdec.parse_block_plain(arr[b].tobytes(), int(n), bs,
                                     bs if b else window_len)
              for b, n in enumerate(lens)]
    return tdec.linked_statuses_plain(parsed, bs)


def _decode_linked_both(payloads, bs, window=None):
    """Both packages' linked decoders on one chain: equal statuses and
    bytes, and statuses equal to ``_linked_model``'s."""
    arr, lens = _rows(payloads)
    jw = None if window is None else jnp.asarray(
        np.frombuffer(window, np.uint8).astype(np.int32)).reshape(1, bs)
    j_out, j_olen = jdec.decode_blocks_linked(
        jnp.asarray(arr.astype(np.int32)), jnp.asarray(lens), bs,
        init_window=jw, init_window_len=len(window) if window else 0)
    tw = None if window is None else torch.frombuffer(
        bytearray(window), dtype=torch.uint8)
    t_out, t_olen = tdec.decode_blocks_linked(
        torch.from_numpy(arr), torch.from_numpy(lens), bs, init_window=tw,
        init_window_len=len(window) if window else 0)
    _assert_rows_equal(j_out, j_olen, t_out, t_olen)
    assert _linked_model(arr, lens, bs, len(window) if window else 0) == \
        t_olen.tolist()
    return t_out, t_olen.numpy()


def test_decode_blocks_linked_valid_chain_matches_jax():
    data = mixed_stream(4 * W - 999, 31)
    blocks, payloads = _linked_payloads(data, W)
    out, olen = _decode_linked_both(payloads, W)
    assert list(olen) == [len(b) for b in blocks]


def test_decode_blocks_linked_init_window_matches_jax():
    data = mixed_stream(3 * W, 32)
    blocks, payloads = _linked_payloads(data, W)
    out, olen = _decode_linked_both(payloads[1:], W, window=blocks[0])
    assert list(olen) == [W, W]
    assert out[1].numpy().tobytes() == blocks[2]


def test_decode_blocks_linked_partial_predecessor_matches_jax():
    # block 0 decodes short, so block 1 sees an empty window: it fails if
    # it reaches back, exactly as in the JAX kernel
    data = mixed_stream(2 * W, 33)
    short = data[:30_000]
    p1 = compress_block(data[W:], dict_=short)
    _, olen = _decode_linked_both([compress_block(short), p1], W)
    assert olen[0] == 30_000


@pytest.mark.parametrize("reaches", [True, False])
@pytest.mark.parametrize("short", [1, 2])
def test_decode_blocks_linked_short_middle_block_matches_jax(short, reaches):
    """A short block in the middle of a chain: its successor fails when it
    reaches back (and so does every later block that reaches back), and
    decodes when it does not."""
    data = mixed_stream(5 * W, 34)
    blocks, payloads = _linked_payloads(data, W)
    payloads[short] = compress_block(blocks[short][:20_000],
                                     dict_=blocks[short - 1])
    if not reaches:
        payloads[short + 1] = compress_block(blocks[short + 1])
    _, olen = _decode_linked_both(payloads, W)
    assert olen[short] == 20_000 and (olen[short + 1] == -1) == reaches


@pytest.mark.parametrize("seed", [1, 2])
def test_decode_blocks_linked_malformed_matches_jax(seed):
    cases = adversarial_cases(seed)
    _decode_linked_both(cases, 8192)


@pytest.mark.parametrize("seed", [1, 2])
def test_decode_blocks_linked_fuzzed_chain_matches_jax(seed):
    """A valid chain with bit flips in some blocks, and one block cut."""
    rng = np.random.default_rng(seed)
    data = mixed_stream(6 * 8192, 40 + seed)
    _, payloads = _linked_payloads(data, 8192)
    payloads = [bytearray(p) for p in payloads]
    for b in rng.choice(len(payloads), 2, replace=False):
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(len(payloads[b])))
            payloads[b][i] ^= 1 << int(rng.integers(8))
    payloads[int(rng.integers(len(payloads)))] = payloads[0][:-5]
    _decode_linked_both([bytes(p) for p in payloads], 8192)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_decode_blocks_batch_malformed_matches_jax(seed):
    cases = adversarial_cases(seed)
    _, block, _ = cycle_params(1000 + seed)
    rng = np.random.default_rng(seed)
    comp = bytearray(compress_block(block))
    for _ in range(12):
        mut = bytearray(comp)
        for _ in range(int(rng.integers(1, 9))):
            mut[int(rng.integers(len(mut)))] = int(rng.integers(256))
        cases.append(bytes(mut))
    cases.append(comp)
    arr, lens = _rows(cases)
    cap = 8192
    j_out, j_olen = jdec.decode_blocks(jnp.asarray(arr.astype(np.int32)),
                                       jnp.asarray(lens), cap)
    t_out, t_olen = tdec.decode_blocks(torch.from_numpy(arr),
                                       torch.from_numpy(lens), cap)
    _assert_rows_equal(j_out, j_olen, t_out, t_olen)
    assert (t_olen.numpy() == -1).any() and (t_olen.numpy() > 0).any()


def _spans_cases():
    """Kernel D batch inputs for the model of its schedule on the card:
    (payloads, out_cap) per case."""
    text = stdlib_text(1 << 20)
    N = 16384
    rng = np.random.default_rng(77)
    period = rng.integers(0, 256, 7, dtype=np.uint8).tobytes()
    body = compress_block(text[:N])
    ends = [i for i in range(1, len(body)) if tdec.walk_row_plain(
        body[:i], i, N, 0, True, 0)[1] == i]
    return {
        "corpus": ([compress_block(text[i * N:(i + 1) * N])
                    for i in range(4)] + [compress_block(text[:5000])], N),
        # offsets under 32: zeros and short periods, and text after them
        "zeros_periods": ([compress_block(bytes(N)),
                           compress_block((period * N)[:N]),
                           compress_block((b"ab" * N)[:N - 3]),
                           compress_block(bytes(3000) + text[:9000])], N),
        "noise": ([compress_block(rng.integers(0, 256, n, dtype=np.uint8)
                                  .tobytes()) for n in (N, 700, 15, 1)]
                  + [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                     for n in rng.integers(0, 3000, 12)], N),
        "malformed": (adversarial_cases(3), 8192),
        # truncations, a payload that ends exactly after a match (the walk
        # rejects it), rows past their cap, empty rows
        "truncated_capped": ([body[:k] for k in (1, 2, 3, len(body) // 2,
                                                 len(body) - 1)]
                             + [body[:ends[len(ends) // 2]], b"", b"",
                                compress_block(text[:N + 1000])], N),
    }


@functools.lru_cache(maxsize=None)
def _spans_case_jax(case):
    comps, cap = _spans_cases()[case]
    arr, lens = _rows(comps)
    j_out, j_olen = jdec.decode_blocks(jnp.asarray(arr.astype(np.int32)),
                                       jnp.asarray(lens), cap)
    return arr, lens, cap, np.asarray(j_out), np.asarray(j_olen)


@pytest.mark.parametrize("span_log", [0, 2, 7])
@pytest.mark.parametrize("case", ["corpus", "zeros_periods", "noise",
                                  "malformed", "truncated_capped"])
def test_rows_spans_model_matches_serial_and_jax(case, span_log):
    """The CPU model of kernel D's batch mode on the card (the walk with its
    checkpoints, spans of 2^span_log sequences into cells, the rounds)
    equals the serial plain decoder and lz4_tpu, byte for byte."""
    arr, lens, cap, j_out, j_olen = _spans_case_jax(case)
    rows, clens = torch.from_numpy(arr), torch.from_numpy(lens)
    caps = torch.full((len(lens),), cap, dtype=torch.int32)
    stats = {}
    m_out, m_olen, m_cons = tdec.decode_rows_spans_plain(
        rows, clens, cap, caps, span_log=span_log, stats=stats)
    assert m_cons is None
    _assert_rows_equal(j_out, j_olen, m_out, m_olen)
    p_out, p_olen = tdec.decode_blocks(rows, clens, cap)
    assert torch.equal(m_olen, p_olen)
    for i, n in enumerate(p_olen.tolist()):
        assert torch.equal(m_out[i, :max(n, 0)], p_out[i, :max(n, 0)])
    seqs, spans = stats["row_sequences"], stats["row_spans"]
    for n, q, k in zip(m_olen.tolist(), seqs, spans):
        assert k == (-(-q // (1 << span_log)) if n >= 0 else 0)
    if case == "corpus":
        assert max(spans) > (200 if span_log == 0 else 1)
        assert stats.get("jump_rounds", 0) >= 1


def test_jax_lane_conversions_round_trip():
    rng = np.random.default_rng(5)
    lanes = rng.integers(0, 256, (3, 200)).astype(np.int32)
    t = common.from_jax_lanes(lanes)
    assert t.dtype == torch.uint8
    assert (common.to_jax_lanes(t) == lanes).all()
    # val32 rows: the low byte of every lane is the byte at that position
    assert (common.from_jax_lanes(val32(lanes.astype(np.uint8))).numpy()
            == lanes).all()
    le = common.le32_lanes(t)
    assert (le.numpy() == val32(lanes.astype(np.uint8))[:, :-3]).all()


# ---------------------------------------------------------------------------
# host layers: spec, XXH32, the build machinery, argument checks
# ---------------------------------------------------------------------------

def test_spec_matches_jax():
    from lz4_tpu import spec as jspec
    from lz4_tpu_torch import spec as tspec
    for n in (0, 1, 255, 65536, 1 << 22, 0x7E000000, 0x7E000001):
        assert tspec.compress_bound(n) == jspec.compress_bound(n)
    for hint in (0, 1, 65536, 65537, 1 << 20, 1 << 23):
        assert tspec.optimal_block_size_id(hint) == \
            jspec.optimal_block_size_id(hint)
    assert tspec.BLOCK_SIZES == jspec.BLOCK_SIZES


def test_xxh32_matches_jax():
    from lz4_tpu.ops import xxhash_np
    from lz4_tpu_torch.ops import xxhash
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for n in (0, 1, 15, 16, 17, 100, 5000):
        for seed in (0, 1, 0xDEADBEEF):
            want = xxhash_np.xxh32(data[:n], seed)
            assert xxhash.xxh32(data[:n], seed) == want
            st = xxhash.XXH32State(seed)
            for i in range(0, n, 7):
                st.update(data[i:min(i + 7, n)])
            assert st.digest() == want


def test_build_shared_caches_by_source_and_reports_failures(tmp_path,
                                                            monkeypatch):
    import shutil
    from lz4_tpu_torch.kernels import build
    cc = shutil.which("cc")
    if cc is None:
        pytest.skip("needs a C compiler")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    src = tmp_path / "k.c"
    src.write_text("int f(void) { return 7; }\n")
    flags = ["-O2", "-fPIC", "-shared"]

    def cmd(out):
        obj = str(out.with_name("k.o"))
        return [[cc, "-O2", "-fPIC", "-c", str(src), "-o", obj],
                [cc, "-shared", obj, "-o", str(out)]]

    first = build.build_shared("k", [src], flags, cmd)
    assert build.build_shared("k", [src], flags, cmd) == first
    src.write_text("int f(void) { return 8; }\n")
    second = build.build_shared("k", [src], flags, cmd)
    assert second != first and second.exists()
    src.write_text("this is not C\n")
    with pytest.raises(build.BuildError, match="build of k failed"):
        build.build_shared("k", [src], flags, cmd)


def test_find_nvcc_raises_without_a_toolkit(tmp_path, monkeypatch):
    from lz4_tpu_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.find_nvcc()


def test_wrappers_check_their_arguments():
    rows = torch.zeros((2, 256), dtype=torch.uint8)
    lens = torch.tensor([10, 20], dtype=torch.int32)
    with pytest.raises(TypeError):
        tenc.encode_blocks(rows.int(), lens)
    with pytest.raises(ValueError):
        tenc.encode_blocks(rows[:, ::2], lens)            # not contiguous
    with pytest.raises(ValueError):
        tenc.encode_blocks(torch.zeros((2, 1 << 19), dtype=torch.uint8),
                           lens)                           # row too long
    with pytest.raises(ValueError):
        tenc.encode_blocks_linked(rows, lens.reshape(1, 2))  # short stream
    with pytest.raises(ValueError):
        tdec.decode_blocks_linked(rows, lens, 256,
                                  init_window=torch.zeros(100,
                                                          dtype=torch.uint8),
                                  init_window_len=50)
    for block_size in (0, tdec.STREAM_BLOCK_CAP + 1):
        with pytest.raises(ValueError, match="8 MB"):
            tdec.decode_blocks_linked(rows, lens, block_size)
    with pytest.raises(ValueError):
        common.use_kernel(rows, torch.zeros(1, device="meta"))


@pytest.mark.parametrize("olen,blens", [
    ([200, 5], [250, 20]),       # compressed olen past its row (M = 128)
    ([-1, 5], [10, 20]),         # negative compressed olen
    ([5, 5], [10, 300]),         # block past its plaintext row (NS = 256)
    ([5, 5], [10, -4]),          # negative block length
])
def test_pack_rejects_lengths_past_their_rows(olen, blens):
    comp = torch.zeros((2, 128), dtype=torch.uint8)
    src = torch.zeros((2, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="exceeds its row"):
        tpack(comp, torch.tensor(olen, dtype=torch.int32), src, blens)
    # the same rows with lengths that fit pack without complaint
    tpack(comp, torch.tensor([100, 5], dtype=torch.int32), src, [250, 20])


@pytest.mark.parametrize("native", [True, False])
def test_xxh32_state_streams_long_inputs(native, monkeypatch):
    from lz4_tpu.ops import xxhash_np
    from lz4_tpu_torch.ops import xxhash
    if not native:
        monkeypatch.setattr(xxhash, "_load_native", lambda: None)
    elif xxhash._load_native() is None:
        pytest.skip("needs a C compiler")
    data = np.random.default_rng(9).integers(0, 256, 300_007,
                                              dtype=np.uint8).tobytes()
    st = xxhash.XXH32State(5)
    for a, b in ((0, 3), (3, 16), (16, 100_001), (100_001, 300_007)):
        st.update(data[a:b])
    assert st.digest() == xxhash_np.xxh32(data, 5) == xxhash.xxh32(data, 5)
