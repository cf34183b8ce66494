"""From the harness's first line to the first timed call: importing
PyTorch and the port, the CUDA context, loading (and, in a new checkout,
building) the kernels, making the pool of objects, and one warm call of
each kind on each object."""


def read(run):
    return run.setup_s
