"""Kernels A and B as the card runs them: three phases, held to the scan.

csrc/encode.cu splits the greedy scan into probe words (every position at
once), a walk of the decisions (a warp per block) and emission (a warp per
sequence).  ``encode_kernel.probe_words_plain``, ``walk_plain`` and
``emit_plain`` model those phases; here they must give, byte for byte, the
payloads and lengths of the port's plain scan (``_scan_plain``, through the
wrappers on CPU tensors) and of lz4_tpu's kernels in interpret mode, on
inputs that reach every edge of the decomposition: runs past the caps,
backward runs stopped by the anchor and by ``low``, matches ending at
matchlimit, blocks of 0, 12, 13 and 14 bytes.

    python -m tests.test_torch_encode

prints, per 64 KB block of bytes 4-8 MiB of the stdlib corpus (the chunk
``chip_smoke.py`` times kernel A on, behind its window; min_match 8 and 4),
the decisions on the walk's critical path (its longest speculative walk,
then its serial walk) as the model schedules the walks (``walk_plain``),
the decisions of the serial scan, and the sequences; then the critical path per block of each chunk of 4 MB that
compress_frame_device makes of the corpus (min_match 8; the corpus is the
first 64 MiB of the stdlib sources, or all of them where there are fewer).
"""

import functools
import sysconfig
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu.kernels import encode_kernel as jenc
from lz4_tpu.tpu import _chunk_windows, fetch_byte_rows, linked_val_rows
from lz4_tpu_torch.kernels import encode_kernel as tenc

from .test_torch_kernels import _assert_rows_equal, stdlib_text, val32

W = 65536


# ---------------------------------------------------------------------------
# inputs (numpy seeds)
# ---------------------------------------------------------------------------

def _rnd(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _decoys(rng, s: bytes, count: int) -> bytes:
    """Each of the first ``count`` 5-grams of ``s`` followed by 3 random
    bytes: a nearer candidate for every position of a later copy of ``s``
    that matches 5 bytes only, so at min_match 8 the table drops it."""
    return b"".join(s[i:i + 5] + _rnd(rng, 3) for i in range(count))


def back_run_anchor(seed: int) -> bytes:
    """A backward run of 350 bytes that only the anchor stops: P2 (a copy
    of P's tail with its own nearer match) ends exactly where R' starts, and
    the bytes before R' equal those before R."""
    rng = np.random.default_rng(seed)
    p, r, u = _rnd(rng, 40), _rnd(rng, 100), _rnd(rng, 300)
    return (p + r + u + _rnd(rng, 200) + p[10:] + _rnd(rng, 5)
            + _rnd(rng, 100) + _decoys(rng, r, 100) + _decoys(rng, u, 250)
            + _rnd(rng, 100) + p[10:] + r + u + _rnd(rng, 300))


def back_run_low(seed: int) -> bytes:
    """A backward run of 350 bytes that ``low`` stops: R starts the
    block, so the run back from U'[250] meets the block start on R's side
    while the anchor is still far behind on the copy's side."""
    rng = np.random.default_rng(seed)
    r, u = _rnd(rng, 100), _rnd(rng, 300)
    return (r + u + _rnd(rng, 500) + _decoys(rng, r, 100)
            + _decoys(rng, u, 250) + _rnd(rng, 100) + r + u + _rnd(rng, 300))


def period(seed: int, n: int, p: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    return (_rnd(rng, p) * (n // p + 1))[:n]


def charmaps() -> bytes:
    """The stdlib's charmap codecs ``encodings/cp1*.py``: tables whose lines
    recur across files, so a long match carries one walk past where the
    next walk's parse ends, and the two never join."""
    enc = Path(sysconfig.get_paths()["stdlib"]) / "encodings"
    return b"".join(p.read_bytes() for p in sorted(enc.glob("cp1*.py")))


@functools.lru_cache(maxsize=None)
def make_data(kind: str, n: int) -> bytes:
    """``n`` bytes of one kind of input."""
    if kind == "text":
        return stdlib_text(n + 3 * W)[3 * W:]
    if kind == "zeros":
        return bytes(n)
    if kind == "period7":
        return period(7, n)
    if kind == "random":
        return _rnd(np.random.default_rng(11), n)
    if kind == "repeat":      # a block, then the same block: matches to
        half = stdlib_text(W // 2 + 5000)[5000:]  # matchlimit, past the cap
        return ((half + half) * (n // W + 1))[:n]
    if kind == "back_anchor":
        return (back_run_anchor(3) * (n // 4000 + 1))[:n]
    if kind == "back_low":
        return (back_run_low(4) + stdlib_text(n))[:n]
    if kind == "charmap":
        return (charmaps() * (n // len(charmaps()) + 1))[:n]
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the three-phase model
# ---------------------------------------------------------------------------

def model_block(buf: torch.Tensor, start: int, n: int, low: int, ip: int,
                delta: torch.Tensor, jump: torch.Tensor, linked: bool,
                acc: int, mm: int, rs: int):
    """(payload, steps) of one block through the three modelled phases."""
    words = tenc.probe_words_plain(buf, start, n, low, delta,
                                   None if linked else jump)
    raw = buf.numpy().tobytes()
    recs, olen, steps = tenc.walk_plain(
        words.tolist(), jump.tolist() if linked else None, raw, start, n,
        low, ip, linked, acc, mm, rs)
    return bytes(tenc.emit_plain(raw, start, recs, olen)), steps


def model_linked(stream, lens, prefix, delta, jump, acc, mm, rs):
    """Kernel A's payloads and walk steps from the model, row by row."""
    S, NB = lens.shape
    payloads, steps = [], []
    for s in range(S):
        for k in range(NB):
            n = min(int(lens[s, k]), W)
            if n <= 0:
                payloads.append(b"")
                continue
            start = (k + 1) * W
            pre = min(max(int(prefix[s]), 0), W) if k == 0 else W
            r = s * NB + k
            payload, st = model_block(stream[s], start, n, start - pre,
                                      start + (0 if pre else 1), delta[r],
                                      jump[r], True, acc, mm, rs)
            payloads.append(payload)
            steps.append(st)
    return payloads, steps


def _assert_payloads(payloads, out, olen):
    olen = olen.reshape(-1).tolist()
    out = out.reshape(len(olen), -1)
    assert [len(p) for p in payloads] == olen
    for i, p in enumerate(payloads):
        assert out[i, :len(p)].numpy().tobytes() == p, i


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

def _linked_inputs(data: bytes, S: int, NB: int, prefix: bytes,
                   zero: bool):
    """The port's stream, lengths and prefixes, and lz4_tpu's val32 rows,
    for ``data`` split over S x NB linked blocks (one stream when there is
    a prefix): lz4_tpu's row (s, 0) window is the data before it."""
    flat = np.zeros(((S * NB + 1) * W,), np.uint8)
    flat[W:W + len(data)] = np.frombuffer(data, np.uint8)
    flat[W - len(prefix):W] = np.frombuffer(prefix, np.uint8)
    stream = np.stack([flat[s * NB * W:((s + 1) * NB + 1) * W]
                       for s in range(S)])
    lens = np.zeros((S, NB), np.int32)
    for g in range(-(-len(data) // W)):
        lens[g // NB, g % NB] = min(W, len(data) - g * W)
    if zero:
        tail = flat[:W].copy()
        packed = flat[W:].view("<i4").reshape(NB, W // 4)
        val = _chunk_windows(jnp.asarray(packed),
                             jnp.asarray(tail.view("<i4").reshape(1, -1)),
                             jnp.int32(len(prefix)), NB=NB, BS=W)
    elif prefix:
        rows = np.stack([flat[k * W:(k + 2) * W] for k in range(NB)])
        val = jnp.asarray(val32(rows)).reshape(1, NB, 2 * W)
    else:
        val, _ = linked_val_rows(data, S, NB)
    pre = np.full((S,), 0, np.int32)
    pre[0] = len(prefix)
    return torch.from_numpy(stream), torch.from_numpy(lens), \
        torch.from_numpy(pre), val


# (kind, bytes, streams, prefix bytes, zero_window_lanes, mm, rs, acc)
LINKED_CASES = [
    ("text", 2 * W + 14, 1, 0, False, 8, 1, 1),
    ("text", 2 * W + 13, 1, W, False, 4, 2, 1),
    ("text", 2 * W + 12, 1, 0, False, 4, 1, 4),
    ("text", 2 * W, 1, 30_000, True, 8, 2, 1),
    ("text", 3 * W - 5000, 2, 0, False, 8, 1, 4),  # stream 1: a padding row
    ("zeros", W + 100, 1, 0, False, 4, 1, 1),
    ("zeros", 2 * W, 1, W, False, 8, 2, 4),
    ("period7", 2 * W - 1, 1, 0, False, 4, 2, 1),
    ("period7", 2 * W, 1, 20_000, True, 8, 1, 1),
    ("random", W + 14, 1, 0, False, 4, 1, 4),
    ("random", 2 * W, 1, W, False, 8, 1, 1),
    ("repeat", 2 * W, 1, 0, False, 4, 1, 1),
    ("repeat", 2 * W, 1, W, False, 8, 2, 4),
    ("back_anchor", W, 1, 0, False, 8, 1, 1),
    ("back_anchor", W, 1, W, False, 8, 2, 1),
    ("back_low", W, 1, 0, False, 8, 1, 1),
    ("back_low", W - 3000, 1, 0, False, 4, 1, 1),
    ("charmap", 2 * W, 1, 0, False, 8, 1, 1),
    ("charmap", 2 * W + 5000, 1, W, True, 4, 2, 1),
]


@pytest.mark.parametrize("kind,n,S,plen,zero,mm,rs,acc", LINKED_CASES,
                         ids=[f"{c[0]}-{c[1]}-S{c[2]}-pre{c[3]}"
                              f"{'-zero' if c[4] else ''}-mm{c[5]}-rs{c[6]}"
                              f"-acc{c[7]}" for c in LINKED_CASES])
def test_three_phase_linked_matches_scan_and_jax(kind, n, S, plen, zero, mm,
                                                 rs, acc):
    data = make_data(kind, n)
    prefix = make_data("text", plen + 10)[10:] if plen else b""
    NB = -(-(-(-len(data) // W)) // S)
    stream, lens, pre, val = _linked_inputs(data, S, NB, prefix, zero)
    delta, jump = tenc.linked_tables(stream, NB, mm, pre if zero else None)
    payloads, steps = model_linked(stream, lens, pre, delta, jump, acc, mm,
                                   rs)
    t_out, t_olen = tenc.scan_linked(stream, lens, pre, delta, jump, acc, mm,
                                     rs)
    _assert_payloads(payloads, t_out, t_olen)
    j_out, j_olen = jenc.encode_blocks_linked(
        val, jnp.asarray(lens.numpy()), acc, prefix_lens=jnp.asarray(pre),
        min_match=mm, reject_step=rs)
    _assert_rows_equal(fetch_byte_rows(j_out.reshape(S * NB, -1)), j_olen,
                       t_out, t_olen)
    assert all(0 <= s <= W for s in steps)


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------

ROW_KINDS = ["text", "zeros", "period7", "random", "repeat", "back_anchor",
             "back_low", "charmap"]
ROW_SIZES = [0, 12, 13, 14, 100, 5000, W - 1, W]


def _model_rows(rows, lens, acc, mm, rs):
    delta, jump = tenc.independent_tables(rows, mm)
    return [model_block(rows[b], 0, int(n), 0, 1, delta[b], jump[b], False,
                        acc, mm, rs)[0] for b, n in enumerate(lens.tolist())]


@pytest.mark.parametrize("kind", ROW_KINDS)
@pytest.mark.parametrize("mm,rs,acc", [(4, 1, 1), (8, 2, 4)])
def test_three_phase_rows_match_scan_and_jax(kind, mm, rs, acc):
    data = make_data(kind, W)
    rows = np.zeros((len(ROW_SIZES), W), np.uint8)
    for i, n in enumerate(ROW_SIZES):
        rows[i, :n] = np.frombuffer(data[:n], np.uint8)
    lens = np.asarray(ROW_SIZES, np.int32)
    payloads = _model_rows(torch.from_numpy(rows), torch.from_numpy(lens),
                           acc, mm, rs)
    t_out, t_olen = tenc.encode_blocks(torch.from_numpy(rows),
                                       torch.from_numpy(lens), acc,
                                       min_match=mm, reject_step=rs)
    _assert_payloads(payloads, t_out, t_olen)
    j_out, j_olen = jenc.encode_blocks(jnp.asarray(val32(rows)),
                                       jnp.asarray(lens), acc, min_match=mm,
                                       reject_step=rs)
    _assert_rows_equal(fetch_byte_rows(j_out), j_olen, t_out, t_olen)


def test_three_phase_rows_of_256k_match_scan():
    """Kernel B's widest rows: positions and deltas past 16 bits."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    text = stdlib_text(n)
    rows = np.zeros((2, n), np.uint8)
    rows[0] = np.frombuffer(text, np.uint8)
    rows[1, :n - 7] = np.frombuffer(text[:W] + _rnd(rng, 3 * W - 7)[:-W]
                                    + text[:W], np.uint8)
    lens = torch.tensor([n, n - 7], dtype=torch.int32)
    rows = torch.from_numpy(rows)
    payloads = _model_rows(rows, lens, 1, 4, 1)
    _assert_payloads(payloads, *tenc.encode_blocks(rows, lens))


# ---------------------------------------------------------------------------
# the phases themselves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["zeros", "period7", "back_anchor",
                                  "back_low", "repeat"])
def test_probe_words_cap_their_runs(kind):
    """Every valid word's runs are exact below the caps and hit the caps on
    these inputs, so the walk's finishing of capped runs is exercised."""
    data = make_data(kind, W)
    rows = torch.from_numpy(np.frombuffer(data, np.uint8).copy())[None]
    delta, jump = tenc.independent_tables(rows, 8)
    words = tenc.probe_words_plain(rows[0], 0, W, 0, delta[0], jump[0])
    valid = words & tenc.PROBE_VALID != 0
    fwd = (words[valid] >> 6) & 127
    back = words[valid] & 63
    raw = data
    pos = valid.nonzero().reshape(-1)
    d = (words[valid] >> 13) & 0x3FFFF
    for p, dd, f, b in list(zip(pos.tolist(), d.tolist(), fwd.tolist(),
                                back.tolist()))[::97]:
        room_f = min(tenc.FWD_CAP, W - 5 - p - 4)
        assert f == tenc._common_run(raw, p - dd + 4, p + 4, room_f)
        k = 0
        while (k < min(tenc.BACK_CAP, p, p - dd) and
               raw[p - 1 - k] == raw[p - dd - 1 - k]):
            k += 1
        assert b == k
    capped = (fwd == tenc.FWD_CAP).any() or (back == tenc.BACK_CAP).any()
    assert bool(capped)


@pytest.mark.parametrize("ns", [13, W, 70_001, 1 << 18])
def test_scan_scratch_groups_fit_the_budget(ns):
    """The card scans as many rows at a time as their scratch fits in
    SCAN_SCRATCH (one at least), each row with room for every walk's
    matches and every sequence."""
    row = tenc.scan_row_bytes(ns)
    seg = -(-ns // tenc.WALKERS)
    for rows in (1, 7, 10_000):
        words, lrec, rec, nrec, group = tenc._scan_scratch(rows, ns, "meta")
        assert 1 <= group <= rows
        assert group == rows or (group + 1) * row > tenc.SCAN_SCRATCH
        assert group * row <= max(tenc.SCAN_SCRATCH, row)
        assert sum(4 * t.numel() for t in (words, lrec, rec, nrec)) == \
            group * row
        assert words.shape[1] % 4 == 0 and words.shape[1] >= ns
        assert lrec.shape[1] > (seg + tenc.WALK_OVERLAP) // 4
        assert rec.shape[1] == ns // 4 + 1


def test_walk_steps_on_text():
    """On text the speculative walks meet: the walk's critical path (as
    ``walk_plain`` schedules the walks) is a small part of the serial
    scan's decisions, and no block falls back to walking most of itself
    serially."""
    steps, serial, seqs = walk_steps(stdlib_text(4 * W), 8)
    for k in range(len(steps)):
        assert seqs[k] < serial[k] <= W
        assert steps[k] * 8 < serial[k]


@pytest.mark.parametrize("mm", [8, 4])
def test_walk_rejoins_where_walks_do_not_join(monkeypatch, mm):
    """On the charmap tables some joins fail; the serial walk then goes
    back onto the recorded walks at the next match end they share, so the
    critical path stays a small part of the serial scan."""
    failed = []
    sync = tenc._sync

    def spy(matches, s_next, ends_next):
        at, nxt = sync(matches, s_next, ends_next)
        failed.append(at < 0 and bool(matches) and matches[-1][1] > s_next)
        return at, nxt

    monkeypatch.setattr(tenc, "_sync", spy)
    steps, serial, seqs = walk_steps(make_data("charmap", 2 * W), mm)
    assert any(failed)
    for k in range(len(steps)):
        assert seqs[k] < serial[k] <= W
        assert steps[k] * 8 < serial[k]


def walk_steps(data: bytes, mm: int, window: bytes = b"",
               serial: bool = True):
    """(critical-path steps of the modelled walk, steps of the serial scan,
    sequences) per block of ``data`` as one linked stream behind
    ``window`` (its candidate table as the main path builds it); without
    ``serial`` the serial scan is not counted (its list is empty)."""
    NB = -(-len(data) // W)
    stream, lens, pre, _ = _linked_inputs(data, 1, NB, window, False)
    delta, jump = tenc.linked_tables(stream, NB, mm,
                                     pre if window else None)
    raw = stream[0].numpy().tobytes()
    steps, scan, seqs = [], [], []
    for k in range(NB):
        start, n = (k + 1) * W, int(lens[0, k])
        low = start - (len(window) if k == 0 else W)
        ip = start + (0 if low < start else 1)
        words = tenc.probe_words_plain(stream[0], start, n, low,
                                       delta[k]).tolist()
        args = (words, jump[k].tolist(), raw, start, n, low)
        recs, _, st = tenc.walk_plain(*args, ip, True, 1, mm, 1)
        steps.append(st)
        if serial:
            scan.append(tenc._walk_from(*args, (ip, start, 64), start + n,
                                        True, 1, mm, 1)[2])
        seqs.append(len(recs) - 1)
    return steps, scan, seqs


def _summary(v) -> str:
    return f"mean {sum(v) / len(v):.1f} (min {min(v)}, max {max(v)})"


if __name__ == "__main__":
    corpus = stdlib_text(64 << 20)
    chunk = 4 << 20
    for mm in (8, 4):
        steps, scan, seqs = walk_steps(corpus[chunk:2 * chunk], mm,
                                       corpus[chunk - W:chunk])
        print(f"min_match {mm}, bytes 4-8 MiB, 64 blocks of 64 KB, per "
              f"block: card walk, critical path {_summary(steps)}; serial "
              f"scan {_summary(scan)}; sequences {_summary(seqs)}",
              flush=True)
    # the main path's chunks of 4 MB (16 of a 64 MiB corpus; fewer where
    # the stdlib is smaller), each behind its 64 KB window: the slowest
    # block of a chunk sets its walk's time
    print(f"corpus: {len(corpus)} bytes of stdlib sources", flush=True)
    for c in range(-(-len(corpus) // chunk)):
        steps = walk_steps(corpus[c * chunk:(c + 1) * chunk], 8,
                           corpus[max(c * chunk - W, 0):c * chunk],
                           serial=False)[0]
        print(f"min_match 8, chunk {c}: critical path per block "
              f"{_summary(steps)}, slowest block {steps.index(max(steps))}",
              flush=True)
