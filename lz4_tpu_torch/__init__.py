"""lz4_tpu_torch: the LZ4F frame codec on PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

A port of ``lz4_tpu`` (JAX/Pallas, the reference it is tested against).  The
main path is ``device.compress_frame_device`` and
``device.decompress_frame_device``; see ``device`` for the frames it covers,
``io`` for files, ``cli`` for the ``lz4``-compatible command line, ``sg`` for
scatter-gather lists, and ``block``, ``stream`` and ``frame`` for the
library API of ``lz4.h`` and ``lz4frame.h`` (one-shot blocks, dictionary
streams, streaming frames).  The kernel-level
entry points (destSize encode and resumable decode, batched XXH32 and
XXH64) are in ``kernels``.
It imports neither jax nor lz4_tpu.
"""

__version__ = "0.1.0"
