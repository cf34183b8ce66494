"""The port's one-shot block API (``lz4_tpu_torch.block``) against
``lz4_tpu.block``, on the CPU.

The port's calls run the kernels' plain versions (``device="cpu"``):
kernel B or A (``compress_fast``), H (``compress_dest_size``) and D, batch
or resumable (the decoders, behind the host's walk over the block's
lengths).  Decoders must give ``lz4_tpu``'s bytes, or raise its
``Lz4BlockError`` with its message, on every input here: the cases of
``tests/test_block_api.py``, the golden blocks, the adversarial blocks of
``tests/test_adversarial_kernel.py`` and targets at the edges of
sequences.  ``compress_fast`` up to 256 KB and ``compress_dest_size`` are
bit-identical to lz4_tpu's kernels B and H (interpret mode) on the same
row; every encoder's block decodes through ``lz4_tpu.block``.  Tolerance
0 on bytes throughout.
"""

import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lz4_seq, real_text_corpus
from lz4_tpu import block as jblock
from lz4_tpu.kernels import destsize_kernel as jds
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.ops import block_np
from lz4_tpu.utils import datagen as jdatagen
from lz4_tpu.utils import datagencli as jdatagencli
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import block as tblock
from lz4_tpu_torch.utils import datagen as tdatagen
from lz4_tpu_torch.utils import datagencli as tdatagencli
from lz4_tpu_torch.device import byte_rows, window_tensor
from lz4_tpu_torch.kernels import decode_kernel as tdec

from .test_adversarial_kernel import CAP, _cases

CPU = "cpu"
FX = Path(__file__).resolve().parent / "fixtures"
GOLDEN_INPUT = (FX / "golden_input.bin").read_bytes()[:65536]
# the port's blocks against lz4_tpu's host parse: at most this much longer
# (measured: 0.972-1.019 on stdlib text and gen_buffer, 4 KB to 1 MB)
RATIO_BOUND = 1.03


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small tensor ops; with one intra-op
    thread each, test workers side by side do not oversubscribe the
    cores (each spinning its own pool slows every worker many times)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def outcome(fn, *args, **kwargs):
    """("ok", result) or ("error", message) of a block call."""
    try:
        return "ok", fn(*args, **kwargs)
    except (jblock.Lz4BlockError, tblock.Lz4BlockError) as e:
        return "error", type(e).__name__, str(e)


def same(name, *args, **kwargs):
    """The port's ``name`` (on the CPU) and lz4_tpu's give the same bytes,
    or raise the same error with the same message."""
    got = outcome(getattr(tblock, name), *args, device=CPU, **kwargs)
    want = outcome(getattr(jblock, name), *args, **kwargs)
    assert got == want, (name, args[1:], got[:1], want[:1])
    return got


def all_decoders(comp, size, dict_=b"", targets=(), caps=()):
    """Every decoder of the API on one block, against lz4_tpu."""
    for mo in (size, size - 1, size + 1, 2 ** 31 - 1, 0):
        same("decompress_safe", comp, mo, dict_)
    for t in targets:
        if not dict_:
            same("decompress_safe_partial", comp, t)
    for cap in caps:
        same("decompress_dest_size", comp, cap, dict_)
    same("decompress_fast", comp + b"tail", size, dict_)
    same("decompress_fast", comp, max(size - 1, 0), dict_)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,proba,seed,accel", [
    (50_000, 0.7, 1, 1), (60_000, 0.8, 2, 8), (20_000, 0.7, 5, 1),
    (1, 0.5, 3, 1), (13, 0.5, 4, 1), (0, 0.5, 6, 1)])
def test_decoders_match_lz4_tpu(n, proba, seed, accel):
    data = gen_buffer(n, proba, seed)
    comp = jblock.compress_fast(data, accel)
    targets = sorted({0, 1, 500, n // 3, n - 1, n, n + 10})
    caps = sorted({0, 1, 17, 500, n // 2, n, n + 100})
    all_decoders(comp, n, targets=targets, caps=caps)
    assert same("decompress_safe", comp, n)[1] == data


def test_decoders_with_a_dictionary_match_lz4_tpu():
    base = gen_buffer(120_000, 0.8, 11)
    for dlen in (1, 4_000, 65_536, 90_000):
        dict_, src = base[:dlen], base[dlen:dlen + 20_000]
        comp = block_np.compress_block(src, dict_=dict_)
        all_decoders(comp, len(src), dict_, caps=(0, 300, 7_000, 20_000))
        # too short a dictionary: offsets past it
        if dlen > 100:
            same("decompress_safe", comp, len(src), dict_[-100:])
            same("decompress_dest_size", comp, 20_000, dict_[-100:])


def test_golden_blocks_match_lz4_tpu():
    for name in ("golden_block_64k.bin", "golden_block_hc9.bin"):
        comp = (FX / name).read_bytes()
        assert tblock.decompress_safe(comp, 65536, device=CPU) == \
            GOLDEN_INPUT
        all_decoders(comp, 65536, targets=(0, 7, 4_095, 40_000, 65_535,
                                           65_536, 70_000),
                     caps=(3, 1_000, 65_535, 65_536))


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_adversarial_blocks_match_lz4_tpu(seed):
    for c in _cases(seed):
        same("decompress_safe", c, CAP)
        same("decompress_fast", c, CAP)
        for t in (0, 3, 100, CAP):
            same("decompress_safe_partial", c, t)
        for cap in (0, 100, CAP):
            same("decompress_dest_size", c, cap)


def test_empty_and_structural_errors_match_lz4_tpu():
    cases = [b"", b"\x00", b"\x10", b"\x10a", b"\x10a\x01", b"\x10a\x00\x00",
             b"\x1fa\x01\x00", b"\x1fa\x01\x00\xff", b"\x11a\x01\x00\x00",
             b"\xf0" + b"\xff" * 3, b"\x40abc", b"\x40abcd",
             b"\x40abcd\x05\x00\x00", bytes([0x12, 0xAA, 0xFF, 0xFF])]
    for c in cases:
        for mo in (0, 2, 100):
            same("decompress_safe", c, mo)
            same("decompress_safe_partial", c, mo)
            same("decompress_dest_size", c, mo)
            same("decompress_fast", c, mo)


def test_partial_stops_inside_literals_matches_and_the_dictionary():
    """``decompress_safe_partial`` cuts where ``lz4_tpu`` cuts: inside a
    literal run, inside a match, inside an overlapping match, exactly at a
    sequence's edge and past the end; behind a dictionary (the walk and
    kernel D's resumable mode, as the API runs them) inside a match that
    reads it."""
    text = gen_buffer(3_000, 0.6, 21)
    comp = (lz4_seq(text[:40], 30, 300) + lz4_seq(text[40:60], 3, 50)
            + lz4_seq(text[60:100], 200, 19) + lz4_seq(text[100:130]))
    size = 40 + 300 + 20 + 50 + 40 + 19 + 30
    for t in list(range(0, 45)) + [339, 340, 341, 345, 360, 361, 362, 400,
                                   410, 411, 449, 450, 468, 469, 470, 499,
                                   size - 1, size, size + 1, 10_000]:
        same("decompress_safe_partial", comp, t)
    dict_ = text[1_000:3_000]
    comp = lz4_seq(b"ab", 1_500, 900) + lz4_seq(b"cd", 7, 60) + \
        lz4_seq(b"tail!")
    for t in (0, 1, 2, 3, 500, 901, 902, 903, 904, 960, 964, 965, 969, 5_000):
        want = block_np.decompress_block(comp, t, dict_, partial=True)
        src_end, out_end, keep = tblock.walk_safe(comp, t, len(dict_),
                                                  partial=True)
        got = tblock.decode_prefix(comp, src_end, out_end,
                                   window_tensor(dict_, CPU), True, CPU)
        assert got[:keep].numpy().tobytes() == want, t


def test_resumable_kernel_rejects_a_cut_sequence_where_lz4_tpu_rewinds():
    """A difference on purpose, pinned: kernel D's resumable mode reports
    -1 for a source that ends inside a sequence, where lz4_tpu's destSize
    decode rewinds to the token and reports a clean stop.  The API walks
    the lengths first and hands D only the whole sequences, so it gives
    lz4_tpu's answer."""
    data = gen_buffer(8_000, 0.7, 31)
    comp = jblock.compress_default(data)
    cut = comp[:len(comp) // 2]
    rows, lens = byte_rows([cut], len(cut), CPU)
    _, olen, cons = tdec.decode_blocks_dest_size(
        rows, lens, torch.tensor([8_000], dtype=torch.int32), 8_000)
    assert int(olen[0]) == int(cons[0]) == -1
    out, consumed = same("decompress_dest_size", cut, 8_000)[1]
    assert 0 < consumed < len(cut) and data.startswith(out)


def test_decompress_fast_reports_the_bytes_it_read():
    a, b = gen_buffer(4096, 0.7, 71), gen_buffer(2048, 0.6, 72)
    ca = tblock.compress_default(a, device=CPU)
    cb = tblock.compress_default(b, device=CPU)
    blob = ca + cb + b"garbage-tail"
    out, consumed = tblock.decompress_fast(blob, len(a), device=CPU)
    assert (out, consumed) == (a, len(ca)) == jblock.decompress_fast(
        blob, len(a))
    assert tblock.decompress_fast(blob[consumed:], len(b), device=CPU) == \
        (b, len(cb))
    with pytest.raises(tblock.Lz4BlockError):
        tblock.decompress_fast(ca, len(a) - 1, device=CPU)


def test_the_output_row_is_sized_from_the_walk():
    """``max_output`` of 2**31 - 1 is a normal call: the row is the
    block's own length, found by the walk."""
    data = gen_buffer(30_000, 0.7, 41)
    comp = jblock.compress_default(data)
    assert tblock.walk_safe(comp, 2 ** 31 - 1) == (len(comp), 30_000, 30_000)
    assert tblock.decompress_safe(comp, 2 ** 31 - 1, device=CPU) == data


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def up128(n: int) -> int:
    return max(-(-n // 128) * 128, 128)


@pytest.mark.parametrize("n,accel", [(0, 1), (1, 1), (13, 1), (5_000, 1),
                                     (65_536, 1), (70_001, 2)])
def test_compress_fast_is_kernel_b_on_a_row_of_one(n, accel):
    data = gen_buffer(n, 0.7, n + 7)
    got = tblock.compress_fast(data, accel, device=CPU)
    assert got == jblock.compress_batch([data], block_size=up128(n),
                                        acceleration=accel)[0]
    assert jblock.decompress_safe(got, n) == data


def test_compress_fast_past_256_kb_joins_kernel_a_chain():
    data = real_text_corpus(600_000)
    for accel in (1, 3):
        comp = tblock.compress_fast(data, accel, device=CPU)
        assert jblock.decompress_safe(comp, len(data)) == data
        assert tblock.decompress_safe(comp, len(data), device=CPU) == data
    assert len(tblock.compress_default(data, device=CPU)) <= \
        RATIO_BOUND * len(jblock.compress_default(data))


def test_capacity_rule():
    data = gen_buffer(30_000, 0.5, 3)
    full = tblock.compress_default(data, device=CPU)
    assert tblock.compress_default(data, capacity=100, device=CPU) == b""
    assert tblock.compress_default(data, capacity=len(full),
                                   device=CPU) == full
    assert tblock.compress_default(data, capacity=len(full) - 1,
                                   device=CPU) == b""
    assert jblock.compress_default(data, capacity=100) == b""
    big = gen_buffer(300_000, 0.7, 4)
    full = tblock.compress_fast(big, device=CPU)
    assert tblock.compress_fast(big, 1, len(full) - 1, device=CPU) == b""
    assert tblock.compress_fast(big, 1, len(full), device=CPU) == full


def h_row(src: bytes, cap: int, accel: int = 1):
    """lz4_tpu's kernel H on one row holding ``src`` (interpret mode):
    (block, consumed)."""
    ns = up128(len(src))
    packed, _ = np_pack_rows([src], ns)
    out, olen, cons = map(np.asarray, jds.encode_blocks_dest_size(
        bytes_to_val32_rows(jnp.asarray(packed), ns),
        jnp.asarray([len(src)], np.int32), jnp.asarray([cap], np.int32),
        accel))
    return out[0, :olen[0]].astype(np.uint8).tobytes(), int(cons[0])


@pytest.mark.parametrize("n,caps", [(40_000, (1, 6, 1_000, 12_000, 80_000)),
                                    (0, (0, 1)), (13, (3, 20))])
def test_compress_dest_size_is_kernel_h_on_a_row_of_one(n, caps):
    data = gen_buffer(n, 0.6, 4)
    for cap in caps:
        got = tblock.compress_dest_size(data, cap, device=CPU)
        assert got == h_row(data, cap)
        comp, consumed = got
        assert len(comp) <= max(cap, 0)
        if comp:
            assert jblock.decompress_safe(comp, consumed) == data[:consumed]
    assert tblock.compress_dest_size(data, 900, 3, device=CPU) == \
        h_row(data, 900, 3)


def test_compress_dest_size_past_the_row_takes_its_first_256_kb():
    """A source past kernel H's 256 KB row gives H its first 256 KB: with
    room to spare, one call consumes exactly 256 KB (lz4_tpu's host codec
    would take all of it)."""
    data = gen_buffer(300_000, 0.7, 5)
    comp, consumed = tblock.compress_dest_size(data, 400_000, device=CPU)
    assert consumed == 1 << 18
    assert (comp, consumed) == h_row(data[:1 << 18], 400_000)
    assert jblock.decompress_safe(comp, consumed) == data[:consumed]
    assert jblock.compress_dest_size(data, 400_000)[1] == len(data)


def test_every_encoder_decodes_through_lz4_tpu():
    rng = random.Random(9)
    for n in (0, 1, 100, 4_096, 70_000, 262_144, 262_145):
        data = gen_buffer(n, rng.uniform(0.3, 0.95), n)
        for accel in (1, 2):
            comp = tblock.compress_fast(data, accel, device=CPU)
            assert jblock.decompress_safe(comp, n) == data
            assert len(comp) <= tblock.compress_bound(n)
        comp, consumed = tblock.compress_dest_size(data, max(n // 3, 1),
                                                   device=CPU)
        assert jblock.decompress_safe(comp, consumed) == data[:consumed]
    noise = incompressible(5_000)
    assert jblock.decompress_safe(tblock.compress_default(noise, device=CPU),
                                  5_000) == noise


@pytest.mark.parametrize("source", ["text", "gen_buffer"])
def test_ratio_against_the_host_parse_is_bounded(source):
    data = real_text_corpus(300_000) if source == "text" \
        else gen_buffer(300_000, 0.7, 9)
    for n in (4_096, 65_536, 300_000):
        port = len(tblock.compress_fast(data[:n], device=CPU))
        host = len(jblock.compress_fast(data[:n]))
        assert port <= RATIO_BOUND * host, (n, port, host)


def test_block_api_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for fn, args in ((tblock.compress_fast, (b"abc",)),
                     (tblock.compress_dest_size, (b"abc", 10)),
                     (tblock.decompress_safe, (b"\x30abc", 3)),
                     (tblock.decompress_safe_partial, (b"\x30abc", 2)),
                     (tblock.decompress_dest_size, (b"\x30abc", 3)),
                     (tblock.decompress_fast, (b"\x30abc", 3))):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(*args)


# ---------------------------------------------------------------------------
# the data generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,proba,seed", [
    (0, 0.7, 1), (1, 0.5, 2), (4_099, 0.3, 3), (65_536, 0.9, 4),
    (200_001, 0.7, 5)])
def test_datagen_gives_lz4_tpus_bytes(size, proba, seed, capsysbinary):
    assert tdatagen.gen_buffer(size, proba, seed) == \
        jdatagen.gen_buffer(size, proba, seed)
    assert tdatagen.gen_buffer_np(size, proba, seed, chunk=50_000) == \
        jdatagen.gen_buffer_np(size, proba, seed, chunk=50_000)
    assert tdatagen.incompressible(size, seed) == \
        jdatagen.incompressible(size, seed)
    argv = ["datagen", f"-g{size}", f"-s{seed}", f"-P{int(proba * 100)}"]
    outs = []
    for cli in (tdatagencli, jdatagencli):
        assert cli.main(argv) == 0
        outs.append(capsysbinary.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0]) == size
