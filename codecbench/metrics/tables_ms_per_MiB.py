"""Device time of the kernels inside the compress calls' spans that are no
__global__ function of lz4_tpu_torch/csrc/ (PyTorch's own sort, scatter,
scan and elementwise kernels, which build the candidate tables), in ms per
MiB of content."""

from codecbench import trace


def read(run):
    tables = [d for d in run.trace.inside("compress")
              if d.kind == "kernel" and not run.trace.is_port_kernel(d.name)]
    if not tables:
        return None
    return trace.per_mib(run.trace.spans_of("compress"),
                         trace.total_ns(tables))
