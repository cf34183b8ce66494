"""The reader of ``pinned_d2h_per_byte.decompress``: the root spans'
``pinned_d2h_bytes`` over their content bytes, and None, with its reason,
on a port whose root spans lack the counter."""

import pytest

from codecbench.cells import benchmark, metric_reader

from .test_codecbench_portspans import run, spans

NAME = "pinned_d2h_per_byte.decompress"


def test_the_metric_is_declared_for_the_decompress_cells():
    (m,) = [m for m in benchmark()["per_layer"] if m["name"] == NAME]
    assert m["moves"] == "decompress_MBps"
    assert m["workloads"] == ["hc9.text64m.read8", "fast-bd.mixed64m.rw"]


def test_a_port_without_the_counter_gives_none(capsys):
    assert metric_reader(NAME)(run()) is None
    assert "no count 'pinned_d2h_bytes'" in capsys.readouterr().err


def test_the_ratio_over_the_decompress_calls():
    taken = spans()
    for s in taken:
        if s.parent is None:
            # the compress roots' counts must not enter a decompress metric
            compress = s.attrs["entry"].startswith("compress")
            s.attrs["counts"]["pinned_d2h_bytes"] = \
                (1 << 30) if compress else 48 << 20
    got = metric_reader(NAME)(run(taken=(taken, 0)))
    assert got == pytest.approx(48 / 64)
