"""Worker of the two-process test of lz4_tpu_torch.parallel.multihost
(run by tests/test_torch_multihost.py); imports torch and lz4_tpu_torch
only.

    python tests/torch_multihost_worker.py <rank> <world> <store> <dir>

Each process joins a gloo group through the ``file://`` store, takes its
contiguous slice of the 4 KB blocks of ``<dir>/plain.bin``, compresses it
with kernel B's plain version (the compressed lengths all-gathered), writes
its frame segment and the gathered lengths, then decodes its blocks with
kernel D's (the decoded lengths all-gathered) and writes its decoded
segment and its launch counts.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

BS = 4096


def main():
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    from lz4_tpu_torch.kernels import common
    from lz4_tpu_torch.parallel import multihost as mh

    dev = mh.initialize(f"file://{store}", world, rank, device="cpu")
    mesh = mh.global_mesh()
    assert mesh.size == world and dev == mh.local_device()
    with open(os.path.join(outdir, "plain.bin"), "rb") as f:
        data = f.read()
    B = -(-len(data) // BS)
    lo, hi = mh.process_block_range(B)
    local = np.zeros((hi - lo, BS), np.uint8)
    block_lens = [min(BS, len(data) - g * BS) for g in range(B)]
    for j, g in enumerate(range(lo, hi)):
        local[j, :block_lens[g]] = np.frombuffer(
            data[g * BS:g * BS + block_lens[g]], np.uint8)
    rows, first = mh.global_blocks(mesh, local)
    assert first == lo, (first, lo)
    lens = torch.tensor(block_lens[lo:hi], dtype=torch.int32, device=dev)

    common.reset_counts()
    comp, all_len = mh.encode_blocks_multihost(mesh, rows, lens)
    seg = mh.frame_segment(comp, all_len, block_lens, lo, hi)
    clens = torch.from_numpy(all_len[lo:hi].astype(np.int32)).to(dev)
    out, all_olen = mh.decode_blocks_multihost(mesh, comp, clens, BS)
    assert all_olen.tolist() == block_lens, all_olen
    dec = mh.decoded_segment(out, all_olen, lo, hi)
    for name, blob in ((f"seg{rank}.bin", seg), (f"dec{rank}.bin", dec)):
        with open(os.path.join(outdir, name), "wb") as f:
            f.write(blob)
    np.save(os.path.join(outdir, f"lens{rank}.npy"), all_len)
    with open(os.path.join(outdir, f"counts{rank}.json"), "w") as f:
        json.dump({"plain": dict(common.PLAIN_CALLS),
                   "launches": dict(common.LAUNCHES)}, f)
    dist.destroy_process_group()
    print(f"rank {rank}: blocks [{lo},{hi}) seg {len(seg)} B dec "
          f"{len(dec)} B")


if __name__ == "__main__":
    main()
