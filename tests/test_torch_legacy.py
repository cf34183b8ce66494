"""Legacy compress on the port (``device.compress_legacy_device``, ``-l``
through lz4_tpu_torch.io and the CLI), the ``tails`` of kernels A and I
and the join of their payloads (lz4_tpu_torch.legacy), held against
lz4_tpu.

The port's legacy files parse differently from lz4_tpu's host codec, so
they are held to the rule for a different parse: both packages' legacy
decoders give back the input, and the file is no larger than
``lz4_tpu.frame.compress_legacy``'s on the same bytes (levels below 3), or
each block no larger than lz4_tpu's device HC payloads of its slice (HC
levels; kernel I is bit-exact to lz4_tpu's).  Inputs are small; the slice
that one legacy block holds is patched down so that several slices are
crossed.
"""

import io

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu import tpu as jtpu
from lz4_tpu.frame import FramePreferences as JaxPrefs
from lz4_tpu.frame import compress_legacy, decompress_legacy
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import device as tdev
from lz4_tpu_torch import io as tio
from lz4_tpu_torch import legacy
from lz4_tpu_torch.kernels import common
from lz4_tpu_torch.kernels import encode_kernel as tenc
from lz4_tpu_torch.kernels import hc_kernel as thc

from .test_torch_hc import _cli, _mixed
from .test_torch_stream import _legacy_payloads

CPU = "cpu"
W = 65536
TEXT = chip_smoke.real_text_corpus(1 << 20)

LEGACY_CASES = {
    # name: (input, level, slice size or None for 8 MB)
    "empty": (b"", 1, None),
    "one_byte": (b"x", 1, None),
    "3000_bytes": (gen_buffer(3000, 0.7, 81), 1, None),
    "text_across_slices": (TEXT[:600_000], 1, 256 << 10),
    "noise": (incompressible(300_000, 82), 1, None),
    "level_9": (TEXT[200_000:350_000], 9, 128 << 10),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_compress_round_trips(case, tmp_path, monkeypatch):
    """``-l`` through io.compress_stream and compress_filename: the same
    file both ways, decoded to the input by both packages' legacy decoders
    and by the port's io, no larger than lz4_tpu's (levels below 3) or
    than lz4_tpu's device HC payloads slice by slice (level 9); empty input
    gives lz4_tpu's exact bytes."""
    data, level, slice_size = LEGACY_CASES[case]
    if slice_size:
        monkeypatch.setattr(tdev, "LEGACY_SLICE", slice_size)
    prefs = tio.IoPrefs(legacy=True, level=level)
    out = io.BytesIO()
    assert tio.compress_stream(io.BytesIO(data), out, prefs,
                               device=CPU) == (len(data), len(out.getvalue()))
    got = out.getvalue()
    src = tmp_path / "f"
    src.write_bytes(data)
    assert tio.compress_filename(str(src), str(tmp_path / "f.lz4"), prefs,
                                 device=CPU) == (len(data), len(got))
    assert (tmp_path / "f.lz4").read_bytes() == got
    assert decompress_legacy(got) == (data, len(got))
    assert tdev.decompress_legacy_device(got, device=CPU) == (data, len(got))
    back = io.BytesIO()
    tio.decompress_stream(io.BytesIO(got), back, tio.IoPrefs(), device=CPU)
    assert back.getvalue() == data
    if not data:
        assert got == compress_legacy(data)
    elif level < 3:
        assert len(got) <= len(compress_legacy(data, level=level))
    else:
        step = tdev.LEGACY_SLICE
        blocks = _legacy_payloads(got)
        assert len(blocks) == -(-len(data) // step)
        for k, blk in enumerate(blocks):
            frame = jtpu.compress_frame_device_hc(
                data[k * step:(k + 1) * step], JaxPrefs(
                    block_size_id=4, block_independent=True,
                    content_checksum=False), level=level)
            payloads = chip_smoke.frame_payloads(frame, 7)
            assert not any(st for _, st in payloads)
            assert len(blk) <= sum(len(p) for p, _ in payloads)


def test_legacy_compress_groups_slices(monkeypatch):
    """Slices go S to a launch of kernel A (CHAIN_GROUP_BYTES of input) and
    whole slices to a group of kernel I's rows; the file does not change
    with the grouping."""
    data = TEXT[:300_000]
    monkeypatch.setattr(tdev, "LEGACY_SLICE", 64 << 10)
    for level, kernel, group in ((1, "encode_linked", "CHAIN_GROUP_BYTES"),
                                 (3, "encode_hc", "HC_GROUP_ROWS")):
        whole = tdev.compress_legacy_device(data, level, device=CPU)
        monkeypatch.setattr(tdev, group, 2 if level >= 3 else 128 << 10)
        common.reset_counts()
        assert tdev.compress_legacy_device(data, level, device=CPU) == whole
        assert common.PLAIN_CALLS[kernel] == 3
        assert decompress_legacy(whole) == (data, len(whole))


def test_cli_legacy_round_trip(tmp_path):
    """``python -m lz4_tpu_torch.cli -l f`` writes lz4_tpu's container,
    decoded by lz4_tpu and by the port's ``-d``."""
    data = TEXT[:70_000]
    (tmp_path / "f").write_bytes(data)
    for flags in (["-l"], ["-l", "-9"]):
        res = _cli([*flags, "-f", "f"], tmp_path)
        assert res.returncode == 0, res.stderr
        got = (tmp_path / "f.lz4").read_bytes()
        assert got[:4] == b"\x02\x21\x4c\x18"
        assert decompress_legacy(got) == (data, len(got))
        res = _cli(["-d", "-f", "f.lz4", "g"], tmp_path)
        assert res.returncode == 0, res.stderr
        assert (tmp_path / "g").read_bytes() == data


# ---------------------------------------------------------------------------
# the tails of kernels A and I, and the join
# ---------------------------------------------------------------------------

def _linked_case(data: bytes, mm: int):
    nb = -(-len(data) // W)
    stream = torch.zeros((2, (nb + 1) * W), dtype=torch.uint8)
    stream[0, W:W + len(data)] = torch.frombuffer(bytearray(data),
                                                  dtype=torch.uint8)
    half = data[:len(data) // 2]
    stream[1, W:W + len(half)] = torch.frombuffer(bytearray(half),
                                                  dtype=torch.uint8)
    lens = torch.tensor([[min(W, max(len(d) - k * W, 0)) for k in range(nb)]
                         for d in (data, half)], dtype=torch.int32)
    return stream, lens


@pytest.mark.parametrize("mm", [4, 8])
def test_kernel_a_tails_point_at_the_terminal_sequence(mm):
    """encode_blocks_linked(tails=True) returns the payloads of tails=False
    and each payload's terminal token offset, as terminal_literals finds
    it (0 for a padding row); joining with the tails equals the join by
    the token walk, and decodes to the stream."""
    data = TEXT[:150_000] + incompressible(20_000, 83) + bytes(9000)
    stream, lens = _linked_case(data, mm)
    out, olen = tenc.encode_blocks_linked(stream, lens, min_match=mm)
    t_out, t_olen, tails = tenc.encode_blocks_linked(stream, lens,
                                                     min_match=mm,
                                                     tails=True)
    assert torch.equal(olen, t_olen) and torch.equal(out, t_out)
    for s, d in enumerate((data, data[:len(data) // 2])):
        payloads = [out[s, k, :n].numpy().tobytes()
                    for k, n in enumerate(olen[s].tolist()) if n]
        for k, p in enumerate(payloads):
            assert tails[s, k] == legacy.terminal_literals(p)
        assert tails[s, len(payloads):].eq(0).all()
        joined = legacy.merge_payloads(payloads, tails[s].tolist())
        assert joined == legacy.merge_payloads(payloads)
        assert decompress_legacy(b"\x02\x21\x4c\x18"
                                 + len(joined).to_bytes(4, "little")
                                 + joined) == (d, 8 + len(joined))


@pytest.mark.parametrize("level", [1, 9])
def test_kernel_i_tails_point_at_the_terminal_sequence(level):
    """encode_blocks_hc(tails=True): the same payloads, and tails as
    terminal_literals finds them (rows of 0, 12 and 13 bytes, noise and
    text); the join of independent rows decodes to their concatenation."""
    rows_b = [TEXT[:W], b"", TEXT[5:17], TEXT[:13],
              incompressible(3000, 84), _mixed(20_000, 85)]
    rows, lens = tdev.byte_rows(rows_b, W, CPU)
    out, olen = thc.encode_blocks_hc(rows, lens, level)
    t_out, t_olen, tails = thc.encode_blocks_hc(rows, lens, level,
                                                tails=True)
    assert torch.equal(olen, t_olen) and torch.equal(out, t_out)
    payloads = [out[b, :n].numpy().tobytes()
                for b, n in enumerate(olen.tolist())]
    assert tails.tolist() == [legacy.terminal_literals(p) for p in payloads]
    joined = legacy.merge_payloads(payloads, tails.tolist())
    assert joined == legacy.merge_payloads(payloads)
    want = b"".join(rows_b)
    assert decompress_legacy(b"\x02\x21\x4c\x18"
                             + len(joined).to_bytes(4, "little")
                             + joined) == (want, 8 + len(joined))


def test_merge_payloads_of_literal_only_payloads_joins_one_run():
    """Payloads that are one literal run each (noise) join as one run, and
    a join of no payloads is the empty block."""
    parts = [incompressible(n, 86 + n) for n in (14, 1, 300, 0)]
    payloads = [legacy.literal_head(len(p)) + p for p in parts]
    joined = legacy.merge_payloads(payloads, [0] * len(payloads))
    assert joined == legacy.literal_head(315) + b"".join(parts)
    assert legacy.merge_payloads([]) == b"\x00"
    assert np.frombuffer(joined, np.uint8).size == 1 + 2 + 315
