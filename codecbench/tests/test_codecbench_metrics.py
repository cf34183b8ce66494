"""The arithmetic of the per-layer and end-to-end metrics on a synthetic
trace: the union of intervals, assignment by span, the idle share, the
copies, the tables, the rooflines and the breakdown."""

import re

import pytest

from codecbench import trace
from codecbench.cells import HERE, benchmark, metric_reader
from codecbench.run import RunRecord
from codecbench.trace import Interval, Span, TraceView
from codecbench.window import Call

MIB = 1 << 20
PORT = re.compile(r"\b(walk_linked_kernel|pack_copy_kernel|"
                  r"linked_cells_kernel)\b")


def view() -> TraceView:
    """Two compress calls (0-100 and 200-300 us) and one decompress call
    (400-500 us), each of 64 MiB content and a 20 MiB frame."""
    spans = [Span("compress", 0, 100_000, 64 * MIB, 20 * MIB),
             Span("compress", 200_000, 300_000, 64 * MIB, 20 * MIB),
             Span("decompress", 400_000, 500_000, 64 * MIB, 20 * MIB)]
    dev = [
        Interval("memcpy", "Memcpy HtoD (Pageable -> Device)", 5_000, 15_000),
        Interval("kernel", "void at::native::radixSortKVInPlace<...>(...)",
                 10_000, 30_000),                # overlaps the copy by 5 us
        Interval("kernel", "void (anonymous namespace)::walk_linked_kernel"
                 "(unsigned char const*, long long)", 40_000, 60_000),
        Interval("memset", "Memset (Device)", 60_000, 61_000),
        # starts inside the first call and ends after it: clipped at 100 us
        Interval("kernel", "pack_copy_kernel(...)", 90_000, 120_000),
        Interval("kernel", "void at::native::elementwise_kernel<...>",
                 210_000, 220_000),
        Interval("kernel", "pack_copy_kernel(...)", 250_000, 260_000),
        Interval("memcpy", "Memcpy DtoH (Device -> Pageable)", 280_000,
                 290_000),
        Interval("memcpy", "Memcpy DtoD (Device -> Device)", 291_000,
                 292_000),
        Interval("kernel", "linked_cells_kernel(int)", 410_000, 440_000),
        Interval("memcpy", "Memcpy DtoH (Device -> Pageable)", 450_000,
                 490_000),
    ]
    return TraceView(spans, dev, [(400_000, 500_000, "aten::copy_"),
                                  (460_000, 470_000, "aten::to")], PORT)


def readers(kind: str) -> dict:
    """The readers of the metrics of one kind in ``BENCHMARK.json``."""
    return {m["name"]: metric_reader(m["name"]) for m in benchmark()[kind]}


def record(v=None) -> RunRecord:
    calls = [Call("compress", 0.2, 64 * MIB, 20 * MIB, True),
             Call("decompress", 0.1, 64 * MIB, 20 * MIB, True),
             Call("compress", 0.3, 64 * MIB, 22 * MIB, True),
             Call("decompress", 0.3, 64 * MIB, 22 * MIB, True)]
    return RunRecord(calls, 12.5, v)


def test_union_counts_overlap_once():
    ivs = [Interval("kernel", "", 0, 10), Interval("kernel", "", 5, 20),
           Interval("kernel", "", 30, 40), Interval("kernel", "", 32, 35)]
    assert trace.union_ns(ivs) == 30
    assert trace.total_ns(ivs) == 38
    assert trace.union_ns([]) == 0


def test_inside_clips_to_spans():
    v = view()
    comp = v.inside("compress")
    assert trace.total_ns(comp) == 10_000 + 20_000 + 20_000 + 1_000 + \
        10_000 + 10_000 + 10_000 + 10_000 + 1_000
    assert max(d.t1 for d in comp) <= 300_000
    assert trace.total_ns(v.inside("decompress")) == 70_000


def test_port_kernel_names_are_read_from_the_sources():
    from codecbench.system import System
    pat = trace.port_kernels(System.csrc(None))
    assert pat.search("void (anonymous namespace)::encode_hc_kernel<16>(x)")
    assert pat.search("linked_cells_kernel(unsigned char const*, int)")
    assert not pat.search("void at::native::radixSortKVInPlace<2, -1>")


def test_per_layer_readers():
    rec = record(view())
    got = {n: read(rec) for n, read in readers("per_layer").items()}
    # compress: busy = 5-30, 40-60, 60-61, 90-100, 210-220, 250-260,
    # 280-290, 291-292 us = 25 + 20 + 1 + 10 + 10 + 10 + 10 + 1 = 87 us
    assert got["idle_frac.compress"] == pytest.approx(1 - 87 / 200)
    assert got["idle_frac.decompress"] == pytest.approx(1 - 70 / 100)
    # H2D 10 us + D2H 10 us over 128 MiB; the DtoD copy is no host copy
    assert got["copy_ms_per_MiB.compress"] == pytest.approx(0.020 / 128)
    assert got["copy_ms_per_MiB.decompress"] == pytest.approx(0.040 / 64)
    # PyTorch's kernels: the sort (20 us) and the elementwise (10 us)
    assert got["tables_ms_per_MiB"] == pytest.approx(0.030 / 128)
    # kernels: sort 20, walk 20, pack 10 (clipped), elementwise 10, pack 10
    bound_s = 2 * 84 * MIB / 3.35e12
    assert got["encode_roofline"] == pytest.approx(
        100 * bound_s / (70e-6))
    assert got["decode_roofline"] == pytest.approx(
        100 * (84 * MIB / 3.35e12) / 30e-6)


def test_readers_find_nothing_without_device_or_calls():
    per_layer = readers("per_layer")
    empty = TraceView(view().spans, [], [], PORT)
    for name, read in per_layer.items():
        assert read(record(empty)) is None, name
    no_decode = TraceView([s for s in view().spans if s.name == "compress"],
                          view().device, [], PORT)
    assert per_layer["decode_roofline"](record(no_decode)) is None
    assert per_layer["idle_frac.decompress"](record(no_decode)) is None
    no_calls = RunRecord([], 1.0, None)
    for name, read in readers("end_to_end").items():
        if name != "setup_s":
            assert read(no_calls) is None, name


def test_end_to_end_readers():
    e2e = readers("end_to_end")
    rec = record()
    assert e2e["compress_MBps"](rec) == \
        pytest.approx(2 * 64 * MIB / 1e6 / 0.5)
    assert e2e["decompress_MBps"](rec) == \
        pytest.approx(2 * 64 * MIB / 1e6 / 0.4)
    # walls 0.1 and 0.3 s: the 95th percentile, interpolated, 0.29 s
    assert e2e["decompress_p95_ms"](rec) == pytest.approx(290.0)
    assert e2e["ratio"](rec) == pytest.approx(42 / 128)
    assert e2e["setup_s"](rec) == 12.5
    failed = RunRecord(rec.calls + [Call("compress", 0.5, 64 * MIB, 0,
                                         False)], 1.0)
    # a failed call's time counts, its bytes do not
    assert e2e["compress_MBps"](failed) == \
        pytest.approx(2 * 64 * MIB / 1e6 / 1.0)


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    bench = benchmark()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert names == files
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_busy_window_and_breakdown():
    v = view()
    assert trace.window_s(v) == pytest.approx(500e-6)
    # every device interval lies in 5-490 us: 25+20+1+30+10+10+10+1+30+40
    assert trace.busy_s(v) == pytest.approx(177e-6)
    b = trace.breakdown(v)
    names = dict(b["device_ops"])
    assert names["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(50e-6)
    assert names["linked_cells_kernel"] == pytest.approx(30e-6)
    # the longest gap: from the DtoD copy (292 us) to the decode (410 us)
    assert b["idle_gaps"][0] == ["between calls: python",
                                 pytest.approx(118e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert ["decompress: aten::copy_", pytest.approx(10e-6)] in \
        b["idle_gaps"]
