"""The port's mesh (lz4_tpu_torch.parallel.mesh) held against
lz4_tpu.parallel.mesh on the 8-device virtual CPU mesh that conftest.py
forces, and the device guard every kernel wrapper launches under.

Both packages get the same bytes, made from seeds.  The port's mesh is
eight entries of the CPU, where every kernel runs its plain version; the
JAX kernels run in interpret mode, so inputs are small.  Every compared
output is an integer: every comparison is exact.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu import sg as jsg
from lz4_tpu.frame import decompress_frame
from lz4_tpu.kernels import destsize_kernel as jdsk
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.parallel import mesh as jm
from lz4_tpu.tpu import linked_val_rows
from lz4_tpu.utils.datagen import gen_buffer, incompressible
from lz4_tpu_torch import device as tdev
from lz4_tpu_torch import sg as tsg
from lz4_tpu_torch.kernels import build, common
from lz4_tpu_torch.kernels import decode_kernel as tdec
from lz4_tpu_torch.kernels import destsize_kernel as tdsk
from lz4_tpu_torch.kernels import encode_kernel as tenc
from lz4_tpu_torch.kernels import hc_kernel as thc
from lz4_tpu_torch.kernels import pack_kernel as tpack
from lz4_tpu_torch.kernels import xxh32_kernel as txxh32
from lz4_tpu_torch.kernels import xxh64_kernel as txxh64
from lz4_tpu_torch.parallel import mesh as tm

from .test_torch_sg import split, trim_to_filled
from .test_torch_stream import sparse_data

W = 65536


@pytest.fixture(scope="module")
def meshes():
    return jm.default_mesh(8), tm.default_mesh(8, device="cpu")


def _rows(bufs, width):
    """The same buffers as JAX's val32 rows and the port's uint8 rows."""
    packed, lens = np_pack_rows(bufs, width)
    arr = np.zeros((len(bufs), width), np.uint8)
    for i, b in enumerate(bufs):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    return packed, lens, torch.from_numpy(arr), torch.from_numpy(lens)


def _payloads(out, olen):
    out, olen = np.asarray(out).astype(np.uint8), np.asarray(olen)
    return [out[i, :n].tobytes() for i, n in enumerate(olen.reshape(-1))]


# -- the mesh itself ----------------------------------------------------------

def test_mesh_shapes_and_sharding():
    mesh = tm.default_mesh(8, device="cpu")
    assert mesh.shape == {tm.AXIS: 8} and mesh.size == 8
    assert set(mesh.devices) == {torch.device("cpu")}
    assert tm.pad_batch(13, mesh) == 16 and tm.pad_batch(16, mesh) == 16
    t = torch.arange(32).reshape(16, 2)
    shards = tm.shard_rows(mesh, t)
    assert len(shards) == 8 and all(s.shape == (2, 2) for s in shards)
    assert all(s.is_contiguous() for s in shards)
    assert torch.equal(tm.gather_rows(shards), t)
    with pytest.raises(ValueError):
        tm.shard_rows(mesh, torch.zeros((7, 3)))          # uneven rows
    with pytest.raises(ValueError):
        tm.encode_blocks_sharded(mesh, shards[:3], shards[:3])
    with pytest.raises(ValueError):
        tm.Mesh(())


def test_default_mesh_never_replaces_cards(monkeypatch):
    """Without a card the default mesh raises; with one visible card, two
    asked for raise, and the default takes every visible card."""
    with pytest.raises(RuntimeError):
        tm.default_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError):
        tm.default_mesh(2)
    assert tm.default_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError):
        tm.default_mesh(0, device="cpu")


# -- independent blocks -------------------------------------------------------

def test_sharded_encode_decode_match_jax(meshes):
    """test_tpu_pipeline.py's shapes: 8 rows of 1 KB over 8 positions, then
    decoded, also with each row's dictionary row."""
    jmesh, tmesh = meshes
    bufs = [gen_buffer(1024, 0.6, 50 + i) for i in range(8)]
    packed, lens, rows, tlens = _rows(bufs, 1024)
    val = bytes_to_val32_rows(jnp.asarray(packed), 1024)
    j_comp, j_clen = jm.encode_blocks_sharded(
        jmesh, jm.shard_rows(jmesh, val), jm.shard_rows(jmesh,
                                                        jnp.asarray(lens)))
    common.reset_counts()
    comp, clen = tm.encode_blocks_sharded(tmesh, rows, tlens)
    assert common.PLAIN_CALLS["encode"] == 8
    assert len(comp) == 8 and all(c.shape[0] == 1 for c in comp)
    comp, clen = tm.gather_rows(comp), tm.gather_rows(clen)
    assert clen.tolist() == np.asarray(j_clen).tolist()
    assert _payloads(comp, clen) == _payloads(j_comp, j_clen)

    j_out, j_olen = jm.decode_blocks_sharded(jmesh, j_comp, j_clen, 1024)
    out, olen = tm.decode_blocks_sharded(tmesh, comp, clen, 1024)
    out, olen = tm.gather_rows(out), tm.gather_rows(olen)
    assert olen.tolist() == np.asarray(j_olen).tolist() == lens.tolist()
    assert _payloads(out, olen) == _payloads(j_out, j_olen) == bufs

    # each row's 1 KB dictionary is the row before it (the last row's for
    # row 0): encoded with the dictionary by the JAX package's host codec.
    # The JAX mesh's dictionary route raises (its partial binds out_cap by
    # name, then passes the dictionaries by position), so the port's shards
    # are held against lz4_tpu's decode_blocks over the whole batch.
    from lz4_tpu.kernels.decode_kernel import decode_blocks as j_decode
    from lz4_tpu.ops import block_np
    dicts = [bufs[i - 1] for i in range(8)]
    comps = [block_np.compress_block(b, dict_=d)
             for b, d in zip(bufs, dicts)]
    c_packed, c_lens, c_rows, c_tlens = _rows(comps, 1152)
    d_packed, d_lens, d_rows, d_tlens = _rows(dicts, 1024)
    c_lanes = jnp.asarray(c_rows.numpy().astype(np.int32))
    d_lanes = jnp.asarray(d_rows.numpy().astype(np.int32))
    with pytest.raises(TypeError):
        jm.decode_blocks_sharded(jmesh, c_lanes, jnp.asarray(c_lens), 1024,
                                 dict_rows=d_lanes,
                                 dict_lens=jnp.asarray(d_lens))
    j_out, j_olen = j_decode(c_lanes, jnp.asarray(c_lens), 1024,
                             dict_rows=d_lanes, dict_lens=jnp.asarray(d_lens))
    out, olen = tm.decode_blocks_sharded(tmesh, c_rows, c_tlens, 1024,
                                         dict_rows=d_rows, dict_lens=d_tlens)
    out, olen = tm.gather_rows(out), tm.gather_rows(olen)
    assert olen.tolist() == np.asarray(j_olen).tolist() == lens.tolist()
    assert _payloads(out, olen) == _payloads(j_out, j_olen) == bufs
    with pytest.raises(ValueError):
        tm.decode_blocks_sharded(tmesh, c_rows, c_tlens, 1024,
                                 dict_rows=d_rows)


def test_roundtrip_step_matches_jax(meshes):
    """test_tpu_pipeline.py's step: 16 rows of 512 bytes over 8 positions."""
    jmesh, tmesh = meshes
    bufs = [gen_buffer(512, 0.7, i) for i in range(16)]
    packed, lens, rows, tlens = _rows(bufs, 512)
    j_clen, j_olen, j_bad = jm.roundtrip_step(
        jmesh, jm.shard_rows(jmesh, jnp.asarray(packed)),
        jm.shard_rows(jmesh, jnp.asarray(lens)), 512)
    clen, olen, bad = tm.roundtrip_step(tmesh, rows, tlens, 512)
    assert bad == int(np.asarray(j_bad)) == 0
    assert tm.gather_rows(clen).tolist() == np.asarray(j_clen).tolist()
    assert tm.gather_rows(olen).tolist() == np.asarray(j_olen).tolist() \
        == lens.tolist()
    # rows shorter than their width
    clen, olen, bad = tm.roundtrip_step(tmesh, rows, tlens.clamp(max=300),
                                        512)
    assert bad == 0
    with pytest.raises(ValueError):
        tm.roundtrip_step(tmesh, rows[:, :256], tlens, 512)


# -- one linked frame over the mesh -------------------------------------------

def _periodic():
    """test_tpu_pipeline.py's input: repeats at distance 65,535, visible to
    the linked window and invisible inside any one block; 6 blocks over 8
    positions, so that two positions get none."""
    return (incompressible(65_535, 55) * 9)[:5 * W + 12345]


def test_encode_linked_sharded_matches_jax():
    """Four streams of two blocks each over a 4-position mesh, each behind
    the 64 KB before it (none for the first), as compress_frame_mesh builds
    them."""
    data = gen_buffer(7 * W + 4000, 0.6, 31)
    S, NB = 4, 2
    jmesh = jm.default_mesh(4)
    val, lens = linked_val_rows(data, S, NB)
    prefix = np.array([0] + [W] * (S - 1), np.int32)
    j_out, j_olen = jm.encode_linked_sharded(
        jmesh, jm.shard_rows(jmesh, val), jnp.asarray(lens),
        jnp.asarray(prefix))
    streams = []
    for s in range(S):
        a = s * NB * W
        st, ln = tdev.linked_stream(data[a:a + NB * W],
                                    data[max(a - W, 0):a], "cpu")
        assert (ln == lens[s]).all()
        streams.append(st)
    out, olen = tm.encode_linked_sharded(
        tm.default_mesh(4, device="cpu"), torch.cat(streams),
        torch.from_numpy(lens), torch.from_numpy(prefix))
    out, olen = tm.gather_rows(out), tm.gather_rows(olen)
    assert olen.tolist() == np.asarray(j_olen).tolist()
    assert _payloads(out.reshape(S * NB, -1), olen) == \
        _payloads(np.asarray(j_out).reshape(S * NB, -1), j_olen)


FRAME_INPUTS = {
    "periodic_6_blocks": _periodic,
    "empty": lambda: b"",
    "one_block": lambda: gen_buffer(40_000, 0.5, 8),
    "text_9_blocks": lambda: gen_buffer(8 * W + 999, 0.7, 9),
}


@pytest.mark.parametrize("case", sorted(FRAME_INPUTS))
def test_compress_frame_mesh_matches_jax(case, meshes, monkeypatch):
    """Byte-identical frames on 8 positions; on 3 positions; and on one
    position in chunks of 2 blocks, each behind the 64 KB before it."""
    jmesh, tmesh = meshes
    data = FRAME_INPUTS[case]()
    want = jm.compress_frame_mesh(jmesh, data)
    common.reset_counts()
    frame = tm.compress_frame_mesh(tmesh, data)
    assert frame == want
    if data:
        assert common.PLAIN_CALLS["encode_linked"] > 0
        assert common.PLAIN_CALLS["pack"] == common.PLAIN_CALLS[
            "encode_linked"]
    assert tm.compress_frame_mesh(tm.default_mesh(3, device="cpu"),
                                  data) == want
    monkeypatch.setattr(tm, "CHUNK", 2 * W)
    assert tm.compress_frame_mesh(tm.default_mesh(device="cpu"),
                                  data) == want
    assert decompress_frame(frame) == (data, len(frame))
    assert tdev.decompress_frame_device(frame, device="cpu") == \
        (data, len(frame))
    assert tm.compress_frame_mesh(tmesh, data, content_checksum=False) == \
        jm.compress_frame_mesh(jmesh, data, content_checksum=False)


def test_compress_frame_mesh_refuses_2gb_streams(monkeypatch):
    monkeypatch.setattr(tm, "MAX_STREAM", 1000)
    with pytest.raises(ValueError):
        tm.compress_frame_mesh(tm.default_mesh(device="cpu"), bytes(1000))


# -- scatter-gather lists over the mesh ---------------------------------------

def _uniform_lists():
    """test_sg.py's uniform lists: 4 lists of 4 x 2 KB, 5 caps of 2,304."""
    lists = [split(gen_buffer(8192, 0.8, 4_000 + i), [2048] * 4)
             for i in range(4)]
    return lists, [2048 + 256] * 5, [2048] * 4


def _ragged_lists():
    """test_sg.py's ragged lists: 6 lists of three layouts."""
    layouts = [[2048, 2048], [1024, 3072], [4096]]
    caps_per = [[2048 + 256] * 3, [3072 + 256] * 2, [4096 + 256, 512]]
    lists = [split(gen_buffer(4096, 0.8, 9_000 + i), layouts[i % 3])
             for i in range(6)]
    return (lists, [caps_per[i % 3] for i in range(6)],
            [layouts[i % 3] for i in range(6)])


SG_LISTS = {"uniform": _uniform_lists, "ragged": _ragged_lists}


@pytest.mark.parametrize("case", sorted(SG_LISTS))
def test_sg_mesh_matches_jax(case, meshes):
    """Frames, consumed and decoded lists equal the JAX package's; kernel G
    runs once per bucket and position, kernel F once per frame."""
    jmesh, tmesh = meshes
    lists, caps, sizes = SG_LISTS[case]()
    want = jm.sg_compress_mesh(jmesh, lists, caps)
    common.reset_counts()
    got = tm.sg_compress_mesh(tmesh, lists, caps)
    assert got == want
    n_buckets = 1 if case == "uniform" else 3
    per_list = [caps] * len(lists) if case == "uniform" else caps
    assert common.PLAIN_CALLS["sg_encode_chain_batch"] == \
        (4 if case == "uniform" else n_buckets * 2)
    assert common.PLAIN_CALLS["encode_dest_size"] == 0
    comp = [trim_to_filled(outs, c, total)
            for (total, _, outs), c in zip(got, per_list)]
    for (total, consumed, _), lst, c in zip(got, lists, comp):
        assert consumed == sum(map(len, lst)) and total > 0
        assert decompress_frame(b"".join(c))[0] == b"".join(lst)
    j_dec = jm.sg_decompress_mesh(jmesh, comp, sizes)
    common.reset_counts()
    dec = tm.sg_decompress_mesh(tmesh, comp, sizes)
    assert dec == j_dec
    assert [outs for _, outs in dec] == lists
    assert dict(common.PLAIN_CALLS) == {"decode_sg": len(lists)}


def test_sg_mesh_list_past_the_records_goes_over_h(meshes, monkeypatch):
    """A difference on purpose: where a list leaves kernel G's records the
    JAX package finishes the walk with its host codec, the port over kernel
    H.  Both consume the whole list, both packages decode the frame, and
    its size is within the 5 % that test_torch_sg.py holds for H's parse."""
    jmesh, tmesh = meshes
    lists, caps, sizes = _uniform_lists()
    want = jm.sg_compress_mesh(jmesh, lists, caps)
    real = tdsk.sg_chain_statics
    monkeypatch.setattr(tdsk, "sg_chain_statics",
                        lambda *a: (3, real(*a)[1]))
    common.reset_counts()
    got = tm.sg_compress_mesh(tmesh, lists, caps)
    assert common.PLAIN_CALLS["sg_encode_chain_batch"] == 4
    assert common.PLAIN_CALLS["encode_dest_size"] > 0
    for (total, consumed, outs), (j_total, j_consumed, _), lst in zip(
            got, want, lists):
        assert consumed == j_consumed == sum(map(len, lst))
        assert abs(total - j_total) <= 0.05 * j_total, (total, j_total)
        comp = trim_to_filled(outs, caps, total)
        assert jsg.sg_decompress(comp, sizes) == (consumed, lst)
        assert tm.sg_decompress_mesh(tmesh, [comp], sizes) == \
            [(consumed, lst)]


def test_sg_mesh_large_block_chain_goes_through_e(meshes):
    """A difference on purpose: a chain with a 256 KB block goes through
    kernel E on its device, where the JAX package walks it on the host;
    beside it, a chain of 4 KB blocks takes kernel F.  Equal results."""
    jmesh, tmesh = meshes
    big = sparse_data(256 << 10, 41)
    b_caps = [len(big) + 4096]
    total, consumed, outs = jsg.sg_compress([big], b_caps)
    assert consumed == len(big)
    big_comp = trim_to_filled(outs, b_caps, total)
    lists, caps, sizes = _uniform_lists()
    total, _, outs = tsg.sg_compress(lists[0], caps, device="cpu")
    small_comp = trim_to_filled(outs, caps, total)
    frames, out_caps = [big_comp, small_comp], [[len(big)], sizes]
    want = jm.sg_decompress_mesh(jmesh, frames, out_caps)
    common.reset_counts()
    got = tm.sg_decompress_mesh(tmesh, frames, out_caps)
    assert got == want == [(len(big), [big]), (8192, lists[0])]
    assert common.PLAIN_CALLS["decode_stream"] > 0
    assert common.PLAIN_CALLS["decode_sg"] == 1


def test_sg_mesh_errors_match_jax(meshes, monkeypatch):
    """An empty list and content over the envelope (2^28, cut here) raise
    ValueError, as in the JAX package; a frame with a bad header raises
    SgError with the same code in both; a corrupt chain raises in both
    (SgChainError in the port)."""
    jmesh, tmesh = meshes
    with pytest.raises(ValueError):
        tm.sg_compress_mesh(tmesh, [[]], [4096])
    with pytest.raises(ValueError):
        jm.sg_compress_mesh(jmesh, [[]], [4096])
    monkeypatch.setattr(tdsk, "MAX_TOTAL", 1000)
    with pytest.raises(ValueError):
        tm.sg_compress_mesh(tmesh, [[bytes(600), bytes(600)]], [4096])
    assert tm.sg_compress_mesh(tmesh, [], [4096]) == []
    assert tm.sg_decompress_mesh(tmesh, [], [4096]) == []
    with pytest.raises(ValueError):
        tm.sg_compress_mesh(tmesh, [[b"x"]], [[4096], [4096]])
    lists, caps, sizes = _uniform_lists()
    total, _, outs = tsg.sg_compress(lists[0], caps, device="cpu")
    comp = trim_to_filled(outs, caps, total)
    bad_magic = [b"\x00" + comp[0][1:]] + comp[1:]
    with pytest.raises(tsg.SgError) as t_err:
        tm.sg_decompress_mesh(tmesh, [bad_magic], sizes)
    with pytest.raises(jsg.SgError) as j_err:
        jm.sg_decompress_mesh(jmesh, [bad_magic], sizes)
    assert t_err.value.code == j_err.value.code == -1
    # the first block's first match pointed before the frame's content
    from .test_torch_sg import _corrupt_chain_frame
    corrupt, c_sizes = _corrupt_chain_frame()
    with pytest.raises(tsg.SgChainError):
        tm.sg_decompress_mesh(tmesh, [corrupt], c_sizes)
    with pytest.raises(Exception):
        jm.sg_decompress_mesh(jmesh, [corrupt], c_sizes)


# -- kernel G with a list axis ------------------------------------------------

def test_sg_encode_chain_batch_matches_single_lists_and_jax():
    """The plain version of the batched walk equals a walk per list, and
    lz4_tpu's chain kernel, on three lists of one layout (capacity stops
    and zero-pads included)."""
    sizes = [3000, 5000, 2000, 6000]
    lists = [split(gen_buffer(16_000, p, 60 + i), sizes)
             for i, p in enumerate((0.7, 0.3, 0.9))]
    caps = [1500] * 12
    total = sum(sizes)
    rows = torch.zeros((3, total + tdsk.TAIL + 5), dtype=torch.uint8)
    for i, lst in enumerate(lists):
        rows[i, :total] = torch.frombuffer(bytearray(b"".join(lst)),
                                           dtype=torch.uint8)
    in_ends = np.concatenate([[0], np.cumsum(sizes)])
    common.reset_counts()
    blocks, boff, *recs = tdsk.sg_encode_chain_batch(rows, in_ends, caps,
                                                     sum(caps))
    assert dict(common.PLAIN_CALLS) == {"sg_encode_chain_batch": 1}
    T, M = tdsk.sg_chain_statics(total, len(sizes), len(caps))
    assert blocks.shape == (3, min(sum(caps), T * M) + 2 * M)
    assert boff.shape == (3, T) and all(r.shape == (3, T) for r in recs)
    for i, lst in enumerate(lists):
        flat, ends = tdsk.sg_chain_input(lst, "cpu")
        assert (ends == in_ends).all()
        s_blocks, s_boff, *s_recs = tdsk.sg_encode_chain(flat, ends, caps,
                                                         sum(caps))
        assert boff[i].tolist() == s_boff.tolist()
        assert [r[i].tolist() for r in recs] == [r.tolist() for r in s_recs]
        n = len(s_blocks)
        assert torch.equal(blocks[i, :n], s_blocks)
        vals, j_ends, _ = jsg.sg_chain_vals(lst)
        j_out, *j_recs = jdsk.sg_encode_chain(
            vals, j_ends, np.asarray(caps, np.int32), sum(caps))
        assert [np.asarray(j).tolist() for j in j_recs] == \
            [r[i].tolist() for r in recs]
        j_out = np.asarray(j_out).astype(np.uint8)
        blen = recs[0][i].tolist()
        for t in range(T):
            if blen[t] >= 0:
                b = int(boff[i, t])
                assert blocks[i, b:b + blen[t]].numpy().tobytes() == \
                    j_out[t, :blen[t]].tobytes()
    with pytest.raises(ValueError):
        tdsk.sg_encode_chain_batch(rows[:, :total], in_ends, caps, sum(caps))
    with pytest.raises(tdsk.ChainEnvelopeError):
        tdsk.sg_encode_chain_batch(rows, [0, 0], caps, sum(caps))


# -- the device guard of every kernel wrapper ---------------------------------

class _FakeLib:
    """Stands in for the kernel library: records, for each C entry point
    called, the device that was current."""

    def __init__(self, current):
        self.calls, self._current = [], current

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, self._current[-1]))
            return 0
        return call


def test_every_wrapper_launches_under_its_tensors_device(monkeypatch):
    """Each C entry point is called while its tensors' device is current
    (``common.on_device``): the entry points launch on the current device,
    so tensors on cuda:1 must not launch on card 0.  The wrappers run on
    CPU tensors with the kernel path forced and the library stubbed."""
    current = [None]

    @contextlib.contextmanager
    def fake_device(dev):
        current.append(dev)
        try:
            yield
        finally:
            current.pop()

    lib = _FakeLib(current)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(build, "kernels_lib", lambda: lib)
    for mod in (tenc, tdec, tdsk, thc, tpack, txxh32, txxh64):
        monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
    cpu = torch.device("cpu")
    rows = torch.zeros((2, 4096), dtype=torch.uint8)
    lens = torch.full((2,), 4096, dtype=torch.int32)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    tenc.encode_blocks(rows, lens)
    stream = torch.zeros((1, 3 * W), dtype=torch.uint8)
    tenc.encode_blocks_linked(stream, i32(W, W).reshape(1, 2),
                              mm_rows=i32(4, 8).reshape(1, 2))
    tpack.pack_frame_payloads(rows, i32(10, 10), rows, lens)
    tdec.decode_blocks_linked(rows, i32(10, 10), 4096)
    tdec.decode_blocks(rows, i32(10, 10), 4096)
    flat = torch.zeros((64,), dtype=torch.uint8)
    for linked in (True, False):
        tdec.decode_stream_raw(flat, [0], [10], [0], W, W, linked)
    tdec.decode_blocks_sg_raw(flat, [0], [10], [100])
    tdsk.encode_blocks_dest_size(rows, lens, i32(100, 100))
    chain = torch.zeros((2, 100 + tdsk.TAIL), dtype=torch.uint8)
    tdsk.sg_encode_chain(chain[0], [0, 100], [200], 200)
    tdsk.sg_encode_chain_batch(chain, [0, 100], [200], 200)
    thc.encode_blocks_hc(rows, lens, 9)
    txxh32.xxh32_batch(rows, lens)
    txxh64.xxh64_batch(rows, lens)
    names = [n for n, _ in lib.calls]
    assert set(names) == set(build._SIGNATURES), \
        set(build._SIGNATURES) ^ set(names)
    assert all(d == cpu for _, d in lib.calls), lib.calls
