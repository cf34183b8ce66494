"""The port's scatter-gather layer (lz4_tpu_torch.sg) and the plain versions
of its kernels, the chain encoder G (``sg_encode_chain``) and the chain
decoder F (``decode_blocks_sg``), held against lz4_tpu.

Both packages get the same bytes, made from seeds.  The JAX kernels run in
interpret mode, so the lists are small (at most 128 KB, and one long but
sparse list for the large-block route).  Codec outputs are integers: every
comparison is exact.  Nothing here needs the reference C library.
"""

import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("avail", [0, 5, 14, 15, 300, 65000, 65536, 70000])
def test_max_final_literals_matches_jax(avail):
    """The closed form and its fix-ups at every room in 0..70,000, int32
    wrap-around of _div255 included (rooms past 65,297 with 64 KB of
    literals left give a run that overruns the room, in both packages)."""
    rooms = np.arange(0, 70_001, dtype=np.int32)
    want = np.asarray(jdsk._max_final_literals(jnp.asarray(rooms),
                                               jnp.int32(avail)))
    got = [tdsk._max_final_literals(int(r), avail) for r in rooms]
    assert want.tolist() == got


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


DEVICE_FALLBACKS = {
    # name: (call on the port, call on lz4_tpu, error the port raises)
    "partial_source": (
        lambda: tsg.sg_compress(split(DATA64K, [4096] * 16), [4096] * 17,
                                source_size=30_000, device=CPU),
        lambda: jsg.sg_compress(split(DATA64K, [4096] * 16), [4096] * 17,
                                source_size=30_000, use_device=True),
        tsg.SgDeviceUnsupported),
    "content_outside_envelope": (
        lambda: tsg.sg_compress([DATA64K[:3000]], [4096], device=CPU),
        None, tsg.SgDeviceUnsupported),
    "walk_longer_than_the_steps": (
        lambda: tsg.sg_compress(split(DATA64K, [4096] * 16), [4096] * 17,
                                device=CPU),
        None, tsg.SgDeviceUnsupported),
    "block_over_4mb": (
        lambda: tsg.sg_decompress(*_frame_with_big_block(), device=CPU),
        lambda: jsg.sg_decompress(*_frame_with_big_block(), use_device=True),
        tsg.SgDeviceUnsupported),
    "chain_does_not_decode": (
        lambda: tsg.sg_decompress(*_corrupt_chain_frame(), device=CPU),
        None, tsg.SgChainError),
}


@pytest.mark.parametrize("case", sorted(DEVICE_FALLBACKS))
def test_port_raises_where_jax_takes_its_host_path(case, monkeypatch):
    port, jax_call, err = DEVICE_FALLBACKS[case]
    if case == "content_outside_envelope":
        monkeypatch.setattr(tdsk, "MAX_TOTAL", 2000)
    if case == "walk_longer_than_the_steps":
        real = tdsk.sg_chain_statics
        monkeypatch.setattr(tdsk, "sg_chain_statics",
                            lambda *a: (3, real(*a)[1]))
    with pytest.raises(err) as exc:
        port()
    assert isinstance(exc.value, tsg.SgError)
    if jax_call is not None:
        res = jax_call()                # lz4_tpu's host path answers
        assert res[0] > 0
    if case == "chain_does_not_decode":
        comp, sizes = _corrupt_chain_frame()
        with pytest.raises(Exception):
            jsg.sg_decompress(comp, sizes, use_device=True)
