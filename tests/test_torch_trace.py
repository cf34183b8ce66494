"""The port's counters and spans (lz4_tpu_torch.trace) on the CPU.

Outside a ``torch.profiler`` session no span is recorded and ``span``
hands back the one shared do-nothing context.  Inside one, each call of a
frame entry point records one root span with the host's steps nested under
it, and the root's counter deltas are the counters' change over the call.
Port spans share Kineto's clock, the span list is bounded, and the counters
stay where the kernel wrappers and the tests have always read them.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from lz4_tpu_torch import device, trace
from lz4_tpu_torch.frame import FramePreferences
from lz4_tpu_torch.kernels import common

CPU = "cpu"
MIB = 1 << 20
# the steps of the routes below: none joins payloads on the host
CALL_STEPS = {"compress_frame_device": set(trace.STEPS) - {"merge"},
              "compress_frame_device_hc": set(trace.STEPS) - {"merge"},
              "decompress_frame_device": set(trace.STEPS) - {"tables",
                                                            "merge"}}


def corpus(n: int) -> bytes:
    """``n`` compressible bytes: a 4 KB noise period, one byte in 7,919
    changed."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, 4096, dtype=np.uint8)
    data = np.resize(base, n)
    data[::7919] += 1
    return data.tobytes()


def prefs(**kw):
    return FramePreferences(block_size_id=4, content_checksum=True, **kw)


def recorded(fn):
    """(fn's result, the spans recorded while it ran under the profiler,
    the change of COUNTS over it)."""
    trace.take_spans()
    trace.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    spans, dropped = trace.take_spans()
    assert dropped == 0
    return out, spans, {k: trace.COUNTS[k] for k in trace.COUNT_KEYS}


def check_tree(spans, entry: str, steps=None) -> trace.Span:
    """One root ``call`` of ``entry``; every other span nested inside its
    parent, in the root's call; the steps recorded are ``steps`` (by
    default those of ``entry``'s routes above)."""
    roots = [s for s in spans if s.parent is None]
    assert [(r.name, r.attrs["entry"]) for r in roots] == [("call", entry)]
    root = roots[0]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.call == root.id and s.t0 <= s.t1
        if s is not root:
            up = by_id[s.parent]
            assert up.t0 <= s.t0 and s.t1 <= up.t1
            assert s.name in trace.STEPS
            if s.name == "tables":
                assert up.name == "launch"
    assert {s.name for s in spans if s is not root} == \
        (CALL_STEPS[entry] if steps is None else steps)
    return root


def test_off_records_nothing():
    trace.take_spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("copy") is trace.OFF
    assert trace.span("walk") is trace.span("link")
    with trace.span("copy") as s:
        assert s is None
    frame = device.compress_frame_device(corpus(100_000), prefs(),
                                         device=CPU)
    device.decompress_frame_device(frame, device=CPU)
    assert trace.take_spans() == ([], 0)


@pytest.fixture(scope="module")
def big_frame():
    """9 MiB through the chunked route (DeviceFrameCompressor)."""
    data = corpus(9 * MIB + 12345)
    assert len(data) > device.CHUNKED_ABOVE
    return data, device.compress_frame_device(data, prefs(
        block_independent=False), device=CPU)


def test_on_chunked_compress(big_frame):
    data, frame = big_frame
    out, spans, counts = recorded(lambda: device.compress_frame_device(
        data, prefs(block_independent=False), device=CPU))
    assert out == frame
    root = check_tree(spans, "compress_frame_device")
    assert root.attrs["content"] == len(data)
    assert root.attrs["frame"] == len(frame)
    assert root.attrs["counts"] == counts
    assert counts["h2d_bytes"] >= len(data)
    assert counts["xxh32_bytes"] >= len(data)
    assert counts["host_copy_bytes"] >= len(data)    # the chunks' slices
    # each of the 4 dispatches: its upload and the fetch of its body
    assert counts["syncs"] >= 8
    # the plain versions ran: no launch on the CPU
    assert root.attrs["launches"] == 0 and root.attrs["launches_by_name"] \
        == {}
    # kernel A's tables: the whole blocks of 3 chunks, then the remainder
    assert sum(s.name == "tables" for s in spans) == 4
    assert counts["merged_bytes"] == 0


def test_on_hc_compress():
    data = corpus(300_000)
    out, spans, counts = recorded(lambda: device.compress_frame_device_hc(
        data, prefs(block_independent=True), level=9, device=CPU))
    root = check_tree(spans, "compress_frame_device_hc")
    assert root.attrs["content"] == len(data)
    assert root.attrs["frame"] == len(out)
    assert root.attrs["counts"] == counts
    assert counts["h2d_bytes"] >= len(data)
    assert counts["xxh32_bytes"] >= len(data)
    # the 64 KB slices and the rows they are written into
    assert counts["host_copy_bytes"] >= 2 * len(data)
    assert counts["merged_bytes"] == 0


def test_on_decompress(big_frame):
    data, frame = big_frame
    (content, used), spans, counts = recorded(
        lambda: device.decompress_frame_device(frame, device=CPU))
    assert content == data and used == len(frame)
    root = check_tree(spans, "decompress_frame_device")
    assert root.attrs["content"] == len(data)
    assert root.attrs["frame"] == len(frame)
    assert root.attrs["counts"] == counts
    assert counts["d2h_bytes"] >= len(data)
    assert counts["xxh32_bytes"] >= len(data)
    # the payloads sliced out of the frame and written into rows, then the
    # decoded rows fetched into the landing and copied out of it once
    info = device.decode_frame_header(frame)
    _, sizes, stored, _ = device._read_blocks(frame, info.header_size, info)
    assert not any(stored)
    assert counts["host_copy_bytes"] == 2 * sum(sizes) + len(data)
    assert counts["pinned_d2h_bytes"] == len(data)
    assert counts["merged_bytes"] == 0


def test_on_long_block_compress():
    """A ``-B7`` frame: each 4 MB block one chain of kernel A, its payloads
    joined on the host in a ``merge`` step; ``merged_bytes`` counts the
    joined blocks' bytes, each a host copy too."""
    data = corpus(4 * MIB + 300_000)
    p = prefs(block_independent=True)
    p.block_size_id = 7
    out, spans, counts = recorded(lambda: device.compress_frame_device(
        data, p, block_size=4 * MIB, device=CPU))
    root = check_tree(spans, "compress_frame_device", set(trace.STEPS))
    assert root.attrs["counts"] == counts
    merges = [s for s in spans if s.name == "merge"]
    assert len(merges) == 2 and all(s.parent == root.id for s in merges)
    groups, _ = device.chain_payloads(data, 4 * MIB, None, False,
                                      device=CPU)
    joined = [len(device.merge_payloads(v, t)) for v, t in groups]
    assert counts["merged_bytes"] == sum(joined)
    # neither block is stored: each record holds the join
    info = device.decode_frame_header(out)
    _, sizes, stored, _ = device._read_blocks(out, info.header_size, info)
    assert sizes == joined and not any(stored)
    assert counts["host_copy_bytes"] >= sum(joined)
    assert counts["h2d_bytes"] >= len(data)
    assert sum(s.name == "tables" for s in spans) == 1    # one launch


@pytest.mark.parametrize("route", ["independent", "linked", "hc",
                                   "decompress_long"])
def test_merged_bytes_stay_zero_off_the_long_block_route(route):
    data = corpus(300_000)
    if route == "decompress_long":
        p = prefs(block_independent=True)
        p.block_size_id = 6
        frame = device.compress_frame_device(data, p, block_size=MIB,
                                             device=CPU)
    trace.reset_counts()
    if route == "independent":
        device.compress_frame_device(data, prefs(block_independent=True),
                                     device=CPU)
    elif route == "linked":
        device.compress_frame_device(data, prefs(block_independent=False),
                                     device=CPU)
    elif route == "hc":
        device.compress_frame_device_hc(data, prefs(block_independent=True),
                                        device=CPU)
    else:
        assert device.decompress_frame_device(frame, device=CPU)[0] == data
    assert trace.COUNTS["merged_bytes"] == 0
    assert trace.COUNTS["h2d_bytes"] > 0


def test_stored_blocks_never_cross_the_link_on_decompress():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 3 * 65536, dtype=np.uint8).tobytes() + \
        corpus(65536)
    frame = device.compress_frame_device_hc(data, prefs(
        block_independent=True), device=CPU)
    trace.reset_counts()
    assert device.decompress_frame_device(frame, device=CPU)[0] == data
    # the one compressed block goes up and comes back; the 3 stored ones
    # are sliced out of the frame on the host
    assert 0 < trace.COUNTS["h2d_bytes"] < 65536
    assert 65536 <= trace.COUNTS["d2h_bytes"] < 2 * 65536
    assert trace.COUNTS["xxh32_bytes"] >= len(data)


def test_counts_are_the_same_with_and_without_the_profiler():
    data = corpus(200_000)

    def calls():
        frame = device.compress_frame_device(
            data, prefs(block_independent=False), device=CPU)
        device.decompress_frame_device(frame, device=CPU)

    trace.reset_counts()
    calls()
    off = dict(trace.COUNTS)
    _, spans, on = recorded(calls)
    assert len([s for s in spans if s.parent is None]) == 2
    assert off == on
    assert on["syncs"] > 0
    assert on["pinned_d2h_bytes"] == len(data)


def test_port_spans_share_kinetos_clock():
    trace.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("walk"):
            with record_function("probe"):
                torch.zeros(4).sum()
    (walk,), _ = trace.take_spans()
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe"]
    assert len(probe) == 1
    t0 = probe[0].start_ns()
    assert walk.t0 <= t0 and t0 + probe[0].duration_ns() <= walk.t1
    assert walk.parent is None and walk.call is None


def test_a_full_list_drops_and_counts(monkeypatch):
    trace.take_spans()
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with trace.span("copy"):
                pass
    spans, dropped = trace.take_spans()
    assert len(spans) == 3 and dropped == 2
    assert trace.take_spans() == ([], 0)


def test_reset_counts_clears_every_counter():
    assert common.LAUNCHES is trace.LAUNCHES
    assert common.PLAIN_CALLS is trace.PLAIN_CALLS
    assert common.reset_counts is trace.reset_counts
    common.LAUNCHES["encode"] += 1
    common.PLAIN_CALLS["pack"] += 1
    trace.COUNTS["syncs"] += 1
    trace.COUNTS["pinned_d2h_bytes"] += 1
    common.reset_counts()
    assert not common.LAUNCHES and not common.PLAIN_CALLS
    assert trace.COUNTS == dict.fromkeys(trace.COUNT_KEYS, 0)


def test_copied_counts_new_objects_only():
    trace.reset_counts()
    data = b"abcdefgh"
    assert trace.copied(data[:], data) is data           # a whole slice
    assert trace.copied(b"".join([data]), data) is data  # a join of one
    trace.copied(data[2:], data)
    trace.copied(bytes(memoryview(data)))
    assert trace.COUNTS["host_copy_bytes"] == 6 + 8
