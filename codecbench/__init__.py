"""The benchmark of ``lz4_tpu_torch``, the PyTorch and CUDA port: frame
compress and decompress of whole objects, host bytes in and host bytes out,
on one card.  ``run.py`` runs one cell; ``BENCHMARK.json`` at the root of
the repository lists the cells and metrics.  Nothing here imports JAX or
the JAX package ``lz4_tpu``; ``reference/`` imports nothing of the port.
"""
