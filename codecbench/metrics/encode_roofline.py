"""(content bytes + frame bytes) at 3.35 TB/s, over the device time of all
kernels inside the compress calls' spans, the port's and PyTorch's
together, in %: the same work, whatever implements it."""

from codecbench import trace


def read(run):
    kernels = [d for d in run.trace.inside("compress") if d.kind == "kernel"]
    return trace.roofline_pct(run.trace.spans_of("compress"),
                              trace.total_ns(kernels))
