"""The port's HC block API (``lz4_tpu_torch.hc``) and kernel I's prefix
mode, against ``lz4_tpu``, on the CPU.

Kernel I's plain version (``hc_row_rounds_plain``, the model of the card's
rounds) is held equal to the serial walk over the d48 table on rows
``[prefix | source]``, and, without a prefix, to ``lz4_tpu``'s Pallas
kernel I in interpret mode; every prefixed block decodes through
``lz4_tpu.ops.block_np`` with its prefix as the dictionary.  The API's
blocks: up to 64 KB without a dictionary, kernel I's row byte for byte;
with a dictionary or over 64 KB (pieces joined), decoded by ``lz4_tpu`` and
no more than ``RATIO_BOUND`` times ``lz4_tpu.hc``'s host HC.  The destSize
form is held, at every capacity, to the serial walk run with
``lz4_tpu/hc.py``'s capacity loop.  ``HcCompressStream`` mirrors
``tests/test_stream.py``'s HC tests, decoded by ``lz4_tpu``'s
``BlockDecompressStream``.  Tolerance 0 on bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hc_prefix_cases, real_text_corpus
from lz4_tpu import hc as jhc
from lz4_tpu.kernels import hc_kernel as jkernel
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.ops import block_np
from lz4_tpu.stream import BlockDecompressStream
from lz4_tpu.utils.datagen import gen_buffer
from lz4_tpu_torch import hc as thc
from lz4_tpu_torch.kernels import common
from lz4_tpu_torch.kernels import hc_kernel as tkernel
from lz4_tpu_torch.legacy import literal_head, terminal_literals

from .test_torch_block_api import RATIO_BOUND, one_thread  # noqa: F401

CPU = "cpu"
W = 65536
TEXT = real_text_corpus(200_000)


def prefixed_row(prefix: bytes, src: bytes):
    """One row ``[prefix | source]`` (width a multiple of 128) with its
    source and prefix lengths, as kernel I takes them."""
    ns = max(-(-(len(prefix) + len(src)) // 128) * 128, 128)
    row = torch.zeros((1, ns), dtype=torch.uint8)
    if prefix + src:
        row[0, :len(prefix) + len(src)] = torch.frombuffer(
            bytearray(prefix + src), dtype=torch.uint8)
    return (row, torch.tensor([len(src)], dtype=torch.int32),
            torch.tensor([len(prefix)], dtype=torch.int32))


PREFIX_CASES = hc_prefix_cases(TEXT)
LEVELS = (1, 3, 9, 16)


@pytest.fixture(scope="module")
def prefixed():
    """Every prefix case at every level through kernel I's plain version
    (payload, tails) and the serial walk (payload)."""
    res = {}
    for name, (prefix, src) in PREFIX_CASES.items():
        row, n, wl = prefixed_row(prefix, src)
        for level in LEVELS:
            out, olen, tails = tkernel.encode_blocks_hc(
                row, n, level, tails=True, window_lens=wl)
            s_out, s_olen = tkernel.hc_scan_serial(row, n, level,
                                                   window_lens=wl)
            res[name, level] = (out[0, :olen[0]].numpy().tobytes(),
                                int(tails[0]),
                                s_out[0, :s_olen[0]].numpy().tobytes())
    return res


@pytest.mark.parametrize("level", LEVELS)
def test_rounds_equal_the_serial_walk_behind_prefixes(prefixed, level):
    for name in PREFIX_CASES:
        block, tail, serial = prefixed[name, level]
        assert block == serial, (name, level)
        assert tail == terminal_literals(block), (name, level)


@pytest.mark.parametrize("name", sorted(PREFIX_CASES))
def test_prefixed_blocks_decode_with_the_prefix(prefixed, name):
    prefix, src = PREFIX_CASES[name]
    for level in LEVELS:
        block = prefixed[name, level][0]
        assert block_np.decompress_block(block, len(src),
                                         dict_=prefix) == src, level


def offsets(block: bytes):
    """The match offsets of a block, by a walk over its tokens."""
    out, i = [], 0
    while True:
        tok = block[i]
        lit, i = tok >> 4, i + 1
        if lit == 15:
            while block[i] == 255:
                lit, i = lit + 255, i + 1
            lit, i = lit + block[i], i + 1
        i += lit
        if i >= len(block):
            return out
        out.append(block[i] | block[i + 1] << 8)
        i += 2
        if tok & 15 == 15:
            while block[i] == 255:
                i += 1
            i += 1


def test_no_match_reaches_past_65535_bytes(prefixed):
    for level in LEVELS:
        near = prefixed["repeat at distance 65,535", level][0]
        far = prefixed["repeat at distance 65,536", level][0]
        assert offsets(near) == [65_535], level     # the whole repeat
        assert all(0 < o < 65_535 for o in offsets(far)), level
        assert len(far) > 10 * len(near), level


def test_the_widest_row_a_full_prefix_and_source():
    """[64 KB prefix | 64 KB source]: 32-bit tables; the rounds model, the
    serial walk and a decode agree."""
    prefix, src = TEXT[:W], TEXT[W:2 * W]
    row, n, wl = prefixed_row(prefix, src)
    assert row.shape[1] == tkernel.MAX_ROW
    perm, slot = tkernel.hc_sorted_tables(row)
    assert perm.dtype == slot.dtype == torch.int32
    for level in (1, 3):
        out, olen = tkernel.hc_scan(row, n, (perm, slot), level,
                                    window_lens=wl)
        s_out, s_olen = tkernel.hc_scan_serial(row, n, level, window_lens=wl)
        block = out[0, :olen[0]].numpy().tobytes()
        assert block == s_out[0, :s_olen[0]].numpy().tobytes()
        assert block_np.decompress_block(block, W, dict_=prefix) == src


# -- without a prefix: lz4_tpu's Pallas kernel I ------------------------------

JAX_NS = 16_384
JAX_BLOCKS = [TEXT[:JAX_NS], TEXT[JAX_NS:2 * JAX_NS - 1_000], b"x" * 13, b""]


@pytest.fixture(scope="module")
def jax_rows():
    """lz4_tpu's kernel I (interpret mode) on JAX_BLOCKS at levels 3 and 9:
    {level: [payload bytes]}."""
    packed, lens = np_pack_rows(JAX_BLOCKS, JAX_NS)
    val = bytes_to_val32_rows(jnp.asarray(packed), JAX_NS)
    res = {}
    for level in (3, 9):
        out, olen = jkernel.encode_blocks_hc(val, jnp.asarray(lens), level)
        out, olen = np.asarray(out), np.asarray(olen)
        res[level] = [out[i, :olen[i]].astype(np.uint8).tobytes()
                      for i in range(len(JAX_BLOCKS))]
    return res


@pytest.mark.parametrize("level", (3, 9))
def test_zero_prefixes_give_lz4_tpus_kernel_i(jax_rows, level):
    rows = torch.zeros((len(JAX_BLOCKS), JAX_NS), dtype=torch.uint8)
    for i, b in enumerate(JAX_BLOCKS):
        if b:
            rows[i, :len(b)] = torch.frombuffer(bytearray(b),
                                                dtype=torch.uint8)
    lens = torch.tensor([len(b) for b in JAX_BLOCKS], dtype=torch.int32)
    zero = torch.zeros_like(lens)
    for wl in (None, zero):
        out, olen = tkernel.encode_blocks_hc(rows, lens, level,
                                             window_lens=wl)
        got = [out[i, :olen[i]].numpy().tobytes()
               for i in range(len(JAX_BLOCKS))]
        assert got == jax_rows[level]


@pytest.mark.parametrize("level", (3, 9))
def test_compress_hc_block_is_kernel_i_up_to_64_kb(jax_rows, level):
    for b, want in zip(JAX_BLOCKS, jax_rows[level]):
        assert thc.compress_hc_block(b, level, device=CPU) == want
    assert thc.compress_hc_block(JAX_BLOCKS[0], level, capacity=len(
        jax_rows[level][0]), device=CPU) == jax_rows[level][0]
    assert thc.compress_hc_block(JAX_BLOCKS[0], level, capacity=len(
        jax_rows[level][0]) - 1, device=CPU) == b""


# -- dictionaries and pieces: decoded by lz4_tpu, sizes bounded ---------------

RATIO_CASES = {
    "text behind a 30 KB dictionary": (TEXT[60_000:80_000], TEXT[30_000:60_000],
                                      9),
    "text behind a 100 KB dictionary": (TEXT[100_000:110_000],
                                        TEXT[:100_000], 9),
    "gen_buffer behind a dictionary": (gen_buffer(12_000, 0.7, 5)[6_000:],
                                       gen_buffer(12_000, 0.7, 5)[:6_000], 9),
    "140 KB of text, three pieces": (TEXT[:140_000], b"", 3),
    "140 KB behind a dictionary": (TEXT[50_000:190_000], TEXT[:50_000], 3),
}


@pytest.mark.parametrize("name", sorted(RATIO_CASES))
def test_dictionary_and_piece_blocks_decode_within_the_bound(name):
    src, dict_, level = RATIO_CASES[name]
    block = thc.compress_hc_block(src, level, dict_=dict_, device=CPU)
    assert block_np.decompress_block(block, len(src), dict_=dict_) == src
    host = jhc.compress_hc_block(src, level, dict_=dict_)
    assert len(block) <= RATIO_BOUND * len(host), (len(block), len(host))


# -- the capacity rule -----------------------------------------------------------

def serial_dest_size(src: bytes, capacity: int, level: int,
                     dict_: bytes = b""):
    """The serial walk over the d48 table with ``lz4_tpu/hc.py``'s capacity
    loop: the sequences before the first that does not fit with its tail,
    then ``block_np``'s most final literals, or a walk of a shorter
    source."""
    dict_ = dict_[-W:]
    attempts = 1 << (level - 1)
    while True:
        row, n, wl = prefixed_row(dict_, src)
        buf = row[0].numpy().tobytes()
        out, anchor = tkernel._hc_row_plain(
            buf, len(src), tkernel.hc_tables(row)[0].numpy(), attempts,
            start=len(dict_), capacity=capacity)
        base = len(dict_)
        avail = base + len(src) - anchor
        lit = block_np._max_final_literals(capacity - len(out), avail)
        if lit < 0:
            return 0, b""
        if anchor > base and avail > lit and lit < 5:
            src = src[:anchor - base + max(lit, 0)]
            continue
        return (anchor - base + lit,
                bytes(out) + literal_head(lit) + buf[anchor:anchor + lit])


CAPACITY_CASES = {
    "text behind a dictionary": (TEXT[20_000:20_900], TEXT[16_000:20_000], 9),
    "gen_buffer": (gen_buffer(700, 0.5, 7), b"", 3),
    "a 2-byte period": (b"ab" * 500, b"", 9),
}


@pytest.mark.parametrize("name", sorted(CAPACITY_CASES))
def test_dest_size_holds_the_capacity_rule_at_every_capacity(name):
    src, dict_, level = CAPACITY_CASES[name]
    full = thc.compress_hc_block(src, level, dict_=dict_, device=CPU)
    for cap in range(len(full) + 2):
        consumed, block = thc.compress_hc_dest_size(src, cap, level,
                                                    dict_=dict_, device=CPU)
        assert len(block) <= cap, cap
        assert (consumed, block) == serial_dest_size(src, cap, level,
                                                     dict_), cap
        if block:
            assert block_np.decompress_block(block, consumed,
                                             dict_=dict_) == src[:consumed]
        else:
            assert consumed == 0, cap
    assert thc.compress_hc_dest_size(src, len(full), level, dict_=dict_,
                                     device=CPU) == (len(src), full)


def test_dest_size_over_several_pieces():
    src = TEXT[:150_000]
    full = thc.compress_hc_block(src, 1, device=CPU)
    for cap in (5, 1_000, 30_000, len(full) - 3, len(full)):
        consumed, block = thc.compress_hc_dest_size(src, cap, 1, device=CPU)
        assert len(block) <= cap and consumed > 0, cap
        assert block_np.decompress_block(block, consumed) == src[:consumed]
    assert consumed == len(src) and block == full


# -- HcCompressStream: test_stream.py's HC tests -------------------------------

def test_hc_stream_double_buffer():
    data = gen_buffer(200_000, 0.75, 404)
    chunks = [data[i:i + 32_768] for i in range(0, len(data), 32_768)]
    enc = thc.HcCompressStream(level=9, device=CPU)
    dec = BlockDecompressStream()
    linked_total = 0
    for c in chunks:
        blk = enc.compress_continue(c)
        linked_total += len(blk)
        assert dec.decompress_continue(blk, len(c)) == c
    indep_total = sum(len(thc.compress_hc_block(c, 9, device=CPU))
                      for c in chunks)
    assert linked_total < indep_total


def test_hc_stream_save_load_dict():
    base = gen_buffer(100_000, 0.8, 17)
    dict_, payload = base[:W], base[60_000:90_000]
    enc = thc.HcCompressStream(level=8, device=CPU)
    assert enc.load_dict(dict_) == W
    saved = enc.save_dict()
    assert saved == dict_[-W:]
    blk = enc.compress_continue(payload)
    dec = BlockDecompressStream()
    dec.set_stream_decode(dict_)
    assert dec.decompress_continue(blk, len(payload)) == payload
    # resume from a saved dict in a fresh stream: same window semantics
    enc2 = thc.HcCompressStream(level=8, device=CPU)
    enc2.load_dict(saved)
    assert enc2.compress_continue(payload) == blk


def test_hc_stream_limited_output():
    data = gen_buffer(20_000, 0.6, 3)
    enc = thc.HcCompressStream(level=9, device=CPU)
    full = enc.compress_continue(data)
    enc.reset()
    assert enc.compress_continue(data, capacity=len(full) - 1) == b""
    assert enc.save_dict() == b""           # the window stayed as it was
    enc.reset()
    assert enc.compress_continue(data, capacity=len(full)) == full


def test_save_dict_follows_lz4_tpus_stream():
    t, j = thc.HcCompressStream(3, device=CPU), jhc.HcCompressStream(3)
    steps = [("load", TEXT[:5_000]), ("chunk", TEXT[5_000:9_000]),
             ("chunk", b""), ("chunk", TEXT[9_000:80_000]),
             ("limited", TEXT[80_000:84_000]), ("chunk", TEXT[84_000:85_000]),
             ("load", TEXT[:70_000]), ("chunk", TEXT[90_000:91_000]),
             ("reset", None), ("chunk", TEXT[95_000:96_000])]
    for what, arg in steps:
        if what == "load":
            assert t.load_dict(arg) == j.load_dict(arg)
        elif what == "reset":
            t.reset()
            j.reset()
        else:
            cap = 10 if what == "limited" else None
            blk = t.compress_continue(arg, cap)
            assert (blk == b"") == (j.compress_continue(arg, cap) == b"")
        for m in (W, 70_000, 100, 1, 0, -1):
            assert t.save_dict(m) == j.save_dict(m), (what, m)


# -- arguments ---------------------------------------------------------------------

def test_levels_and_arguments_are_checked_and_clamped():
    src = TEXT[:3_000]
    assert thc.DEFAULT_CLEVEL == jhc.DEFAULT_CLEVEL == 9
    assert thc.MAX_CLEVEL == jhc.MAX_CLEVEL == 16
    for level, want in ((0, 9), (None, 9), (-3, 1), (20, 16), (5, 5)):
        assert thc.HcCompressStream(level, device=CPU).level == \
            jhc.HcCompressStream(level).level == want
    s, j = thc.HcCompressStream(device=CPU), jhc.HcCompressStream()
    for level in (0, 20, 4):
        s.reset(level)
        j.reset(level)
        assert s.level == j.level
    assert thc.compress_hc_block(src, 0, device=CPU) == \
        thc.compress_hc_block(src, 9, device=CPU)
    assert thc.compress_hc_block(src, 40, device=CPU) == \
        thc.compress_hc_block(src, 16, device=CPU)
    assert thc.compress_hc_dest_size(src, -4, device=CPU) == (0, b"")
    assert thc.compress_hc_block(b"", capacity=0, device=CPU) == b""

    row, n, wl = prefixed_row(TEXT[:1_000], src)
    common.reset_counts()
    want = tkernel.encode_blocks_hc(row, n, 9, window_lens=wl)
    assert common.PLAIN_CALLS["encode_hc"] == 1
    assert common.LAUNCHES["encode_hc"] == 0
    # window_lens clamp to [0, NS], src_lens to [0, NS - window_lens]
    ns = row.shape[1]
    for w, k, same_as in ((-5, 100, (0, 100)), (ns + 9, 7, (ns, 0)),
                          (1_000, ns, (1_000, ns - 1_000))):
        got = tkernel.encode_blocks_hc(
            row, torch.tensor([k], dtype=torch.int32), 3,
            window_lens=torch.tensor([w], dtype=torch.int32))
        ref = tkernel.hc_scan_serial(
            row, torch.tensor([same_as[1]], dtype=torch.int32), 3,
            window_lens=torch.tensor([same_as[0]], dtype=torch.int32))
        assert got[1] == ref[1] and torch.equal(
            got[0][0, :got[1][0]], ref[0][0, :ref[1][0]]), (w, k)
    with pytest.raises(TypeError):
        tkernel.encode_blocks_hc(row, n, 9, window_lens=wl.long())
    with pytest.raises(ValueError, match="window_lens"):
        tkernel.encode_blocks_hc(row, n, 9, window_lens=torch.zeros(
            (2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="too large"):
        tkernel.encode_blocks_hc(torch.zeros((1, 2 * W + 128),
                                             dtype=torch.uint8), n, 9)
    wide, wn, wwl = prefixed_row(TEXT[:W], TEXT[W:W + 10])
    with pytest.raises(TypeError):      # 16-bit tables for a 128 KB row
        tkernel.hc_scan(wide, wn, tuple(
            t.to(torch.int16) for t in tkernel.hc_sorted_tables(wide)), 9,
            window_lens=wwl)
    assert torch.equal(want[0], tkernel.encode_blocks_hc(
        row, n, 9, window_lens=wl)[0])


def test_hc_api_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for fn in (lambda: thc.compress_hc_block(b"abc"),
               lambda: thc.compress_hc_dest_size(b"abc", 10),
               thc.HcCompressStream):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


def ratios() -> None:
    """The port's HC sizes against lz4_tpu's host HC on the same bytes:
    the dictionary and piece cases, a double-buffer stream session, and
    linked frames."""
    from lz4_tpu import frame as jframe
    from lz4_tpu_torch import frame as tframe
    torch.set_num_threads(1)
    rows = [(name, thc.compress_hc_block(src, level, dict_=dict_,
                                         device=CPU),
             jhc.compress_hc_block(src, level, dict_=dict_))
            for name, (src, dict_, level) in RATIO_CASES.items()]
    data = gen_buffer(200_000, 0.75, 404)
    t, j = thc.HcCompressStream(9, device=CPU), jhc.HcCompressStream(9)
    chunks = [data[i:i + 32_768] for i in range(0, len(data), 32_768)]
    rows.append(("a stream of 32 KB chunks of gen_buffer, level 9",
                 b"".join(t.compress_continue(c) for c in chunks),
                 b"".join(j.compress_continue(c) for c in chunks)))
    text = real_text_corpus(150_000)
    for kw in (dict(block_size_id=4, level=9),
               dict(block_size_id=4, level=3, content_checksum=True)):
        rows.append((f"a linked frame of 150 KB of text, {kw}",
                     tframe.compress_frame(text, tframe.FramePreferences(
                         **kw), device=CPU),
                     jframe.compress_frame(text, jframe.FramePreferences(
                         **kw))))
    for name, port, host in rows:
        print(f"{name}: port {len(port)} bytes, lz4_tpu {len(host)} bytes, "
              f"port / lz4_tpu {len(port) / len(host):.4f}")


if __name__ == "__main__":
    ratios()
