"""The plain reference: it accepts the frames of the port's plain CPU path
for both configurations, and rejects them with one bit flipped, with
another header, or against other content."""

import json
import struct

import numpy as np
import pytest

from codecbench.cells import HERE, generator
from codecbench.reference.lz4frame import check_frame
from codecbench.reference.xxh32 import xxh32
from codecbench.system import System

from .conftest import TINY


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def frames():
    """(config, content, frame) of each configuration, made by the port's
    plain versions on the CPU: text and noise, a short last block."""
    obj = generator(TINY)(dict(TINY, object_MiB=0.25), 77)[0]
    out = {}
    for name, size in (("lz4-fast-bd", 200_003), ("lz4-hc9", 130_001)):
        cfg = config(name)
        content = obj[:size]
        out[name] = (cfg, content, System(cfg, "cpu").compress(content))
    return out


def test_xxh32_known_values():
    assert xxh32(b"") == 0x02CC5D05
    assert xxh32(b"a") == 0x550D7456
    assert xxh32(b"abc") == 0x32D153FF
    assert xxh32(b"Nobody inspects the spammish repetition") == 0xE2293B2F


def test_xxh32_matches_the_port_at_every_tail():
    from lz4_tpu_torch.ops.xxhash import xxh32 as port_xxh32
    data = np.random.default_rng(3).bytes(300)
    for n in list(range(0, 70)) + [255, 256, 299]:
        for seed in (0, 1, 2**32 - 1):
            assert xxh32(data[:n], seed) == port_xxh32(data[:n], seed)


@pytest.mark.parametrize("name", ["lz4-fast-bd", "lz4-hc9"])
def test_accepts_the_ports_frames(frames, name):
    cfg, content, frame = frames[name]
    c = check_frame(frame, cfg["frame"], content)
    assert (c.header_bad, c.blocks_bad, c.tail_bad, c.bytes_wrong) == \
        (0, 0, 0, 0), c.notes
    assert c.checksum == xxh32(content)


@pytest.mark.parametrize("name", ["lz4-fast-bd", "lz4-hc9"])
def test_rejects_one_bit_flipped(frames, name):
    cfg, content, frame = frames[name]
    rng = np.random.default_rng(5)
    for pos in rng.choice(np.arange(4, len(frame)), 40, replace=False):
        for bit in (0, 5):
            bad = bytearray(frame)
            bad[pos] ^= 1 << bit
            c = check_frame(bytes(bad), cfg["frame"], content)
            caught = c.header_bad or c.blocks_bad or c.tail_bad or \
                c.bytes_wrong or c.checksum != xxh32(content)
            assert caught, (pos, bit)


@pytest.mark.parametrize("name", ["lz4-fast-bd", "lz4-hc9"])
def test_rejects_another_header_and_other_content(frames, name):
    cfg, content, frame = frames[name]
    other = dict(cfg["frame"],
                 block_independent=not cfg["frame"]["block_independent"])
    assert check_frame(frame, other, content).header_bad == 1
    changed = bytearray(content)
    changed[len(changed) // 2] ^= 0x40
    assert check_frame(frame, cfg["frame"], bytes(changed)).bytes_wrong > 0
    assert check_frame(frame, cfg["frame"], content[:-1]).bytes_wrong > 0


def test_rejects_trailing_bytes_and_a_missing_end_mark(frames):
    cfg, content, frame = frames["lz4-fast-bd"]
    assert check_frame(frame + b"\0", cfg["frame"], content).tail_bad == 1
    cut = frame[:-8]          # no end mark and no content checksum
    assert check_frame(cut, cfg["frame"], content).tail_bad == 1


def _frame(independent: bool, *blocks: bytes) -> bytes:
    header = struct.pack("<IBB", 0x184D2204, 0x60 if independent else 0x40,
                         0x40)
    header += bytes([(xxh32(header[4:]) >> 8) & 0xFF])
    body = b"".join(struct.pack("<I", len(b)) + b for b in blocks)
    return header + body + b"\0\0\0\0"


@pytest.mark.parametrize("independent", [True, False])
def test_a_match_into_the_block_before(independent):
    """Block 2 copies 20 bytes from block 1 (offset 26), then ends in 6
    literals: right in a linked frame, a fault in an independent one."""
    content = b"abcdefghijklmnopqrstuvwxyz" * 2
    first = bytes([0xF0, 26 - 15]) + content[:26]
    second = bytes([0x0F]) + struct.pack("<H", 26) + bytes([20 - 4 - 15]) \
        + bytes([0x60]) + content[46:]
    expect = {"block_size_id": 4, "block_independent": independent,
              "block_checksum": False, "content_checksum": False,
              "content_size": False}
    c = check_frame(_frame(independent, first, second), expect, content)
    assert c.header_bad == 0 and c.tail_bad == 0
    if independent:
        assert c.blocks_bad == 1
    else:
        assert (c.blocks_bad, c.bytes_wrong) == (0, 0), c.notes


def test_the_end_of_block_rules():
    """A match that ends in a block's last 5 bytes breaks the format."""
    content = b"abcd" * 8
    block = bytes([0x4F]) + content[:4] + struct.pack("<H", 4) + \
        bytes([32 - 4 - 4 - 15]) + bytes([0x00])
    expect = {"block_size_id": 4, "block_independent": True,
              "block_checksum": False, "content_checksum": False,
              "content_size": False}
    assert check_frame(_frame(True, block), expect, content).blocks_bad == 1
