"""The plain reference that decides ``correct``: an LZ4 frame parser and
block checker (``lz4frame``) and XXH32 (``xxh32``), in NumPy and Python.
It imports nothing of ``lz4_tpu_torch``, ``lz4_tpu`` or JAX."""
