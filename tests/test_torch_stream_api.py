"""The port's dictionary streams (``lz4_tpu_torch.stream``) against
``lz4_tpu.stream``, on the CPU.

The port's streams keep their 64 KB window as a tensor and run the
kernels' plain versions (``device="cpu"``): kernel A behind the window
(``compress_continue``), H on ``[window | chunk]``
(``compress_dest_size_continue``) and D with the window as its dictionary
row (the decoders).  Chained sessions with chunks of 1 KB to 300 KB, the
double-buffer, ring-buffer and line-by-line disciplines, ``load_dict``,
``save_dict`` and ``reset``: the port's compressed streams decode through
``lz4_tpu.stream`` and lz4_tpu's through the port, tolerance 0 on bytes;
the destSize encoder is bit-identical to lz4_tpu's kernel H on the same
rows.
"""

import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import real_text_corpus
from lz4_tpu import stream as jstream
from lz4_tpu.kernels import destsize_kernel as jds
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.utils.datagen import gen_buffer
from lz4_tpu_torch import stream as tstream
from lz4_tpu_torch.block import Lz4BlockError

from .test_torch_block_api import RATIO_BOUND, one_thread, up128  # noqa: F401

CPU = "cpu"
DATA = gen_buffer(400_000, 0.7, 600)


def pair():
    """A port compressor and decompressor on the CPU."""
    return (tstream.BlockCompressStream(device=CPU),
            tstream.BlockDecompressStream(device=CPU))


def session(chunks, enc, dec_port, dec_jax):
    """Compress ``chunks`` with ``enc`` and decode every block with both
    decoders; returns the compressed size."""
    total = 0
    for chunk in chunks:
        blk = enc.compress_continue(chunk)
        total += len(blk)
        assert dec_port.decompress_continue(blk, len(chunk)) == chunk
        assert dec_jax.decompress_continue(blk, len(chunk)) == chunk
    return total


@pytest.mark.parametrize("seed", [1, 2])
def test_chained_sessions_of_1_kb_to_300_kb_chunks(seed):
    rng = random.Random(seed)
    chunks, pos = [], 0
    while pos < len(DATA):
        n = rng.choice([1_024, rng.randint(1_000, 70_000), 300_000])
        chunks.append(DATA[pos:pos + n])
        pos += n
    enc, dec = pair()
    session(chunks, enc, dec, jstream.BlockDecompressStream())
    # lz4_tpu's compressed stream through the port's decoder
    jenc, dec = jstream.BlockCompressStream(), pair()[1]
    for chunk in chunks:
        assert dec.decompress_continue(jenc.compress_continue(chunk),
                                       len(chunk)) == chunk


def test_double_buffer_discipline():
    slot = [bytearray(65536), bytearray(65536)]
    enc, dec = pair()
    jdec = jstream.BlockDecompressStream()
    for i in range(0, 300_000, 65536):
        chunk = DATA[i:i + 65536]
        s = (i // 65536) % 2
        slot[s][:len(chunk)] = chunk
        blk = enc.compress_continue(bytes(slot[s][:len(chunk)]))
        assert dec.decompress_continue(blk, 65536) == chunk
        assert jdec.decompress_continue(blk, 65536) == chunk


def test_ring_buffer_discipline():
    ring, pos, off = bytearray(8192), 0, 0
    enc, dec = pair()
    jdec = jstream.BlockDecompressStream()
    src = DATA[:50_000]
    while off < len(src):
        n = min(1024, len(src) - off)
        if pos + n > len(ring):
            pos = 0
        ring[pos:pos + n] = src[off:off + n]
        blk = enc.compress_continue(bytes(ring[pos:pos + n]))
        assert dec.decompress_continue(blk, n) == src[off:off + n]
        assert jdec.decompress_continue(blk, n) == src[off:off + n]
        pos += n
        off += n


def test_line_by_line_discipline():
    lines = [(f"2026-08-17T12:{i % 60:02d} host-{i % 8} request {i} served "
              f"in {i % 97} ms status=OK\n").encode() for i in range(150)]
    enc, dec = pair()
    blob = b"".join(struct.pack("<H", len(b)) + b for b in
                    (enc.compress_continue(ln) for ln in lines))
    jdec, pos, back = jstream.BlockDecompressStream(), 0, []
    while pos < len(blob):
        (n,) = struct.unpack_from("<H", blob, pos)
        blk = blob[pos + 2:pos + 2 + n]
        back.append(dec.decompress_continue(blk, 1 << 16))
        assert jdec.decompress_continue(blk, 1 << 16) == back[-1]
        pos += 2 + n
    assert back == lines
    assert len(blob) < sum(map(len, lines)) // 2


def test_load_dict_save_dict_and_reset():
    dict_ = gen_buffer(90_000, 0.7, 601)
    sample = dict_[5000:9000] + gen_buffer(1000, 0.5, 602) + dict_[70_000:
                                                                   74_000]
    enc = tstream.BlockCompressStream(device=CPU)
    assert enc.load_dict(dict_) == 65536
    assert enc.save_dict() == dict_[-65536:]
    assert enc.save_dict(100) == dict_[-100:]
    blk = enc.compress_continue(sample)
    assert tstream.BlockDecompressStream(dict_, device=CPU) \
        .decompress_continue(blk, len(sample)) == sample
    assert jstream.BlockDecompressStream(dict_).decompress_continue(
        blk, len(sample)) == sample
    assert enc.save_dict() == (dict_ + sample)[-65536:]
    # saveDict -> a new stream -> loadDict keeps the chain
    first, second = DATA[:80_000], DATA[80_000:120_000]
    enc = tstream.BlockCompressStream(device=CPU)
    b1 = enc.compress_continue(first)
    enc2 = tstream.BlockCompressStream(device=CPU)
    enc2.load_dict(enc.save_dict())
    b2 = enc2.compress_continue(second)
    jdec = jstream.BlockDecompressStream()
    assert jdec.decompress_continue(b1, len(first)) + \
        jdec.decompress_continue(b2, len(second)) == first + second
    # reset forgets the window: the block equals a fresh stream's
    enc2.reset()
    assert enc2.save_dict() == b""
    assert enc2.compress_continue(first[:10_000]) == \
        tstream.BlockCompressStream(device=CPU).compress_continue(
            first[:10_000])
    # capacity: b"" and the window stays
    enc = tstream.BlockCompressStream(device=CPU)
    enc.load_dict(first)
    assert enc.compress_continue(second, capacity=10) == b""
    assert enc.save_dict() == first[-65536:]
    # a decoder with too short a window raises as lz4_tpu's does
    with pytest.raises(Lz4BlockError, match="offset beyond window"):
        tstream.BlockDecompressStream(device=CPU).decompress_continue(
            b2, len(second))


def h_rows(window: bytes, chunk: bytes, cap: int, accel: int):
    """lz4_tpu's kernel H on the row ``[window | chunk]`` (interpret mode):
    (consumed, block)."""
    row = window + chunk
    ns = up128(len(row))
    packed, _ = np_pack_rows([row], ns)
    out, olen, cons = map(np.asarray, jds.encode_blocks_dest_size(
        bytes_to_val32_rows(jnp.asarray(packed), ns),
        jnp.asarray([len(chunk)], np.int32), jnp.asarray([cap], np.int32),
        accel, window_lens=jnp.asarray([len(window)], np.int32)))
    return int(cons[0]), out[0, :olen[0]].astype(np.uint8).tobytes()


def test_dest_size_continue_is_kernel_h_behind_the_window():
    enc = tstream.BlockCompressStream(acceleration=2, device=CPU)
    enc.load_dict(DATA[:3_000])
    history, pos = DATA[:3_000], 3_000
    jdec = jstream.BlockDecompressStream(DATA[:3_000])
    tdec = tstream.BlockDecompressStream(DATA[:3_000], device=CPU)
    for cap in (5_000, 1, 30_000):
        chunk = DATA[pos:pos + 40_000]
        got = enc.compress_dest_size_continue(chunk, cap)
        assert got == h_rows(history[-65536:], chunk, cap, 2)
        consumed, blk = got
        if blk:
            assert jdec.decompress_continue(blk, consumed) == \
                chunk[:consumed]
            assert tdec.decompress_continue(blk, consumed) == \
                chunk[:consumed]
        history += chunk[:consumed]
        pos += consumed
        assert enc.save_dict() == history[-65536:]


def test_dest_size_continue_decode_resumes_like_lz4_tpu():
    blocks, chunks = [], [DATA[i:i + 50_000] for i in range(0, 250_000,
                                                            50_000)]
    jenc = jstream.BlockCompressStream()
    blocks = [jenc.compress_continue(c) for c in chunks]
    tdec = tstream.BlockDecompressStream(device=CPU)
    jdec = jstream.BlockDecompressStream()
    for blk, chunk in zip(blocks, chunks):
        got, rest = b"", blk
        for cap in (7_000, 1, 20_000, 50_000):
            t = tdec.decompress_dest_size_continue(rest, cap)
            assert t == jdec.decompress_dest_size_continue(rest, cap)
            got += t[1]
            rest = rest[t[0]:]
        assert got == chunk and not rest
    # a block cut in the middle stops at the token before the cut
    cut = blocks[0][:len(blocks[0]) // 2]
    assert tstream.BlockDecompressStream(device=CPU) \
        .decompress_dest_size_continue(cut, 50_000) == \
        jstream.BlockDecompressStream().decompress_dest_size_continue(
            cut, 50_000)


@pytest.mark.parametrize("source", ["text", "gen_buffer"])
def test_stream_ratio_against_the_host_parse_is_bounded(source):
    data = real_text_corpus(300_000) if source == "text" \
        else gen_buffer(300_000, 0.7, 9)
    for size in (4_096, 65_536):
        chunks = [data[i:i + size] for i in range(0, len(data), size)]
        enc, dec = pair()
        port = session(chunks, enc, dec, jstream.BlockDecompressStream())
        jenc = jstream.BlockCompressStream()
        host = sum(len(jenc.compress_continue(c)) for c in chunks)
        assert port <= RATIO_BOUND * host, (size, port, host)


def test_streams_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.BlockCompressStream()
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.BlockDecompressStream()
