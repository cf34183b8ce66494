"""The split of device-idle time between the port's host steps
(``portspans.py``) on a hand-built trace and span list, and the readers of
it: the split matches a hand count and adds up to ``idle_frac``'s idle; a
misfit, dropped spans, no device intervals or a port without spans give
None.  Also a traced run on the CPU, where the new metrics are left out."""

from types import SimpleNamespace

import pytest

from codecbench import cells, portspans, trace
from codecbench.cells import benchmark, metric_reader
from codecbench.run import RunRecord
from codecbench.trace import Interval, Span, TraceView

from .conftest import tiny_root
from .test_codecbench_metrics import PORT, record
from .test_codecbench_run import run_cell

MIB = 1 << 20
NEW = [m["name"] for m in benchmark()["per_layer"]
       if m["name"].startswith(("idle_ms_per_MiB.", "idle_unnamed_frac.",
                                "host_copy_per_byte.",
                                "tables_event_ms_per_MiB",
                                "link_bytes_per_byte.",
                                "xxh32_bytes_per_byte.", "syncs_per_MiB."))]
COUNTED = [n for n in NEW if n.startswith(("host_copy_", "link_", "xxh32_",
                                           "syncs_"))]


def view(device=True) -> TraceView:
    """Two compress calls (0-100 and 200-300 us) and one decompress call
    (400-500 us), each of 64 MiB content and a 20 MiB frame; the card busy
    at 20-30 and 60-70 us, and at 410-440 us."""
    spans = [Span("compress", 0, 100_000, 64 * MIB, 20 * MIB),
             Span("compress", 200_000, 300_000, 64 * MIB, 20 * MIB),
             Span("decompress", 400_000, 500_000, 64 * MIB, 20 * MIB)]
    dev = [Interval("kernel", "radixSort", 20_000, 30_000),
           Interval("memcpy", "Memcpy HtoD", 22_000, 26_000),
           Interval("kernel", "walk_linked_kernel", 60_000, 70_000),
           Interval("kernel", "linked_cells_kernel", 410_000, 440_000)]
    return TraceView(spans, dev if device else [], [], PORT)


def spans():
    """The port's spans of the three calls: a root each, its steps under
    it."""
    out = []

    def add(name, t0, t1, parent=None, call=None, **attrs):
        s = SimpleNamespace(name=name, t0=t0, t1=t1, id=len(out) + 1,
                            parent=parent, call=call, attrs=attrs or None)
        if parent is None:
            s.call = s.id
        out.append(s)
        return s

    def counts(copies):
        return {"host_copy_bytes": copies, "syncs": 3, "h2d_bytes": MIB,
                "d2h_bytes": 2 * MIB, "xxh32_bytes": 64 * MIB}

    r = add("call", 1_000, 99_000, entry="compress_frame_device",
            content=64 * MIB, frame=20 * MIB, counts=counts(3 * MIB))
    add("copy", 2_000, 25_000, r.id, r.id)
    la = add("launch", 30_000, 50_000, r.id, r.id)
    add("tables", 31_000, 40_000, la.id, r.id, event_ms=0.009)
    add("link", 50_000, 80_000, r.id, r.id)
    add("xxh32", 85_000, 95_000, r.id, r.id)
    add("walk", 96_000, 98_000, r.id, r.id)
    r = add("call", 200_500, 299_000, entry="compress_frame_device",
            content=64 * MIB, frame=20 * MIB, counts=counts(5 * MIB))
    add("copy", 201_000, 251_000, r.id, r.id)
    r = add("call", 400_100, 499_900, entry="decompress_frame_device",
            content=64 * MIB, frame=20 * MIB, counts=counts(128 * MIB))
    w = add("walk", 400_200, 405_000, r.id, r.id)
    add("xxh32", 401_000, 402_000, w.id, r.id)
    add("link", 440_000, 470_000, r.id, r.id)
    add("copy", 470_000, 499_000, r.id, r.id)
    return out


def run(v=None, taken=None) -> RunRecord:
    rec = record(view() if v is None else v)
    rec.port_spans = (spans(), 0) if taken is None else taken
    return rec


def test_the_idle_split_matches_a_hand_count():
    s = portspans.split(run())
    # compress 1: idle 0-20, 30-60, 70-100 us; compress 2: all 100 us
    assert s.idle["compress"] == {"copy": 18_000 + 50_000,
                                  "launch": 20_000,      # tables inside
                                  "link": 20_000, "xxh32": 10_000,
                                  "walk": 2_000,
                                  "unnamed": 10_000 + 50_000}
    # decompress: idle 400-410 and 440-500 us
    assert s.idle["decompress"] == {"walk": 3_800, "xxh32": 1_000,
                                    "link": 30_000, "copy": 29_000,
                                    "unnamed": 70_000 - 63_800}
    assert s.tables_ms == pytest.approx(0.009)
    assert s.misfit_ns == 0


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_steps_and_unnamed_add_up_to_idle_fracs_idle(kind):
    rec = run()
    s = portspans.split(rec)
    spans_ = rec.trace.spans_of(kind)
    idle = trace.span_ns(spans_) - trace.union_ns(rec.trace.inside(kind))
    assert sum(s.idle[kind].values()) == s.idle_ns[kind] == idle
    frac = metric_reader(f"idle_frac.{kind}")(rec)
    assert idle == pytest.approx(frac * trace.span_ns(spans_))
    mib = 64 * len(spans_)
    got = sum(metric_reader(f"idle_ms_per_MiB.{step}.{kind}")(rec)
              for step in portspans.STEPS) * mib * 1e6
    unnamed = metric_reader(f"idle_unnamed_frac.{kind}")(rec) * idle
    assert got + unnamed == pytest.approx(idle)


def test_the_readers():
    rec = run()
    read = {n: metric_reader(n)(rec) for n in NEW}
    assert len(NEW) == 21 and len(COUNTED) == 8
    assert read["idle_ms_per_MiB.copy.compress"] == \
        pytest.approx(0.068 / 128)
    assert read["idle_ms_per_MiB.link.decompress"] == \
        pytest.approx(0.030 / 64)
    assert read["idle_unnamed_frac.compress"] == pytest.approx(60 / 180)
    assert read["host_copy_per_byte.compress"] == pytest.approx(8 / 128)
    assert read["host_copy_per_byte.decompress"] == pytest.approx(2.0)
    assert read["tables_event_ms_per_MiB"] == pytest.approx(0.009 / 128)
    assert read["link_bytes_per_byte.compress"] == pytest.approx(6 / 128)
    assert read["link_bytes_per_byte.decompress"] == pytest.approx(3 / 64)
    assert read["xxh32_bytes_per_byte.compress"] == pytest.approx(1.0)
    assert read["xxh32_bytes_per_byte.decompress"] == pytest.approx(1.0)
    assert read["syncs_per_MiB.compress"] == pytest.approx(6 / 128)
    assert read["syncs_per_MiB.decompress"] == pytest.approx(3 / 64)


def test_a_count_the_port_lacks_gives_none(capsys):
    taken = spans()
    for s in taken:
        if s.parent is None:
            del s.attrs["counts"]["xxh32_bytes"]
    rec = run(taken=(taken, 0))
    assert metric_reader("xxh32_bytes_per_byte.compress")(rec) is None
    assert "no count 'xxh32_bytes'" in capsys.readouterr().err
    assert metric_reader("syncs_per_MiB.compress")(rec) == \
        pytest.approx(6 / 128)


def late_root():
    out = spans()
    out[0].t1 = 2_100_000        # 2 ms past its benchmark span
    return out


@pytest.mark.parametrize("case", ["misfit", "dropped", "no_device",
                                  "no_roots", "count", "no_port"])
def test_no_split_gives_none(case, capsys, monkeypatch):
    v = view(device=case != "no_device")
    taken = {"misfit": (late_root(), 0), "dropped": (spans(), 1),
             "no_roots": ([s for s in spans() if s.parent], 0),
             "count": (spans()[:9], 0)}.get(case, (spans(), 0))
    rec = run(v, taken)
    if case == "no_port":
        del rec.port_spans
        monkeypatch.setattr(portspans, "_take", lambda: None)
    for name in NEW:
        assert metric_reader(name)(rec) is None, name
    err = capsys.readouterr().err
    assert err.count("codecbench: port spans:") == 1     # said once


def test_a_traced_run_on_the_cpu_leaves_the_new_metrics_out(capsys,
                                                           tmp_path):
    root = tiny_root(tmp_path)
    assert set(NEW) <= set(cells.load_cell("tiny-fast", root).per_layer)
    res, err = run_cell(capsys, root, "tiny-fast", trace=1)
    assert not set(NEW) & set(res["metrics"])
    assert "codecbench: port spans: no device intervals" in err
