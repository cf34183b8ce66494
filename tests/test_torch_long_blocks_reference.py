"""The ``lz4 -1`` deployment (independent 4 MB blocks, content checksum)
judged by the benchmark's plain reference, on the CPU.

``codecbench/reference/lz4frame.py`` is NumPy written from the format
descriptions, with nothing of the port: it judges the frames of
``device.compress_frame_device``'s long-block route against the
configuration's frame settings, and each block but the last alone to
exactly ``block_size`` bytes of the object.  The benchmark's cell
``cli-default.text64m.read8`` resolves by name, and its system round-trips
an object into a frame the reference judges clean.
"""

import numpy as np
import pytest

from codecbench import cells
from codecbench.reference.lz4frame import check_frame, derive_blocks
from codecbench.reference.xxh32 import xxh32
from codecbench.system import System
from lz4_tpu_torch import device

from .test_torch_long_blocks import LAYOUTS, prefs, records, text_and_noise

CPU = "cpu"
CELL = "cli-default.text64m.read8"


def expect(bsid: int) -> dict:
    return {"block_size_id": bsid, "block_independent": True,
            "block_checksum": False, "content_checksum": True,
            "content_size": False}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def case(request):
    bsid = request.param
    bs, parts = LAYOUTS[bsid]
    data = text_and_noise(bsid, parts)
    return bsid, bs, data, device.compress_frame_device(
        data, prefs(bsid), block_size=bs, device=CPU)


def test_the_reference_finds_no_fault(case):
    bsid, _, data, out = case
    c = check_frame(out, expect(bsid), data)
    assert (c.header_bad, c.blocks_bad, c.tail_bad, c.bytes_wrong) == \
        (0, 0, 0, 0), c.notes
    assert c.checksum == xxh32(data)


def test_each_block_but_the_last_decodes_alone_to_block_size(case):
    bsid, bs, data, out = case
    buf = np.frombuffer(out, np.uint8)
    recs = records(out)
    assert len(recs) >= 2
    for k, (start, size, stored) in enumerate(recs[:-1]):
        want = np.frombuffer(data, np.uint8, bs, k * bs)
        assert derive_blocks(buf, [start], [size], [stored], bs, True,
                             want) == (0, 0), k


def test_the_cell_resolves_by_name():
    cell = cells.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "lz4-cli-default"
    assert cell.config["frame"] == expect(7)
    assert cell.config["compress"]["kwargs"]["block_size"] == 4 << 20
    assert cell.traffic["reads_per_write"] == 8
    assert callable(cells.generator(cell.traffic))
    assert {"compress_MBps", "decompress_MBps", "ratio", "setup_s"} == \
        set(cell.end_to_end)
    assert {"idle_ms_per_MiB.merge.compress",
            "merged_bytes_per_byte.compress", "encode_roofline",
            "decode_roofline"} <= set(cell.per_layer)
    assert "pinned_d2h_per_byte.decompress" not in cell.per_layer
    for name in cell.end_to_end + cell.per_layer:
        assert callable(cells.metric_reader(name))


def test_the_cells_system_round_trips_a_frame_the_reference_judges_clean():
    cell = cells.load_cell(CELL)
    system = System(cell.config, device=CPU)
    data = text_and_noise(11, [("text", 300_000), ("noise", 20_000)])
    out = system.compress(data)
    c = check_frame(out, cell.config["frame"], data)
    assert (c.header_bad, c.blocks_bad, c.tail_bad, c.bytes_wrong) == \
        (0, 0, 0, 0), c.notes
    assert c.checksum == xxh32(data)
    assert system.decompress(out) == (data, len(out))
