"""(frame bytes + content bytes) at 3.35 TB/s, over the device time of all
kernels inside the decompress calls' spans, in %."""

from codecbench import trace


def read(run):
    kernels = [d for d in run.trace.inside("decompress")
               if d.kind == "kernel"]
    return trace.roofline_pct(run.trace.spans_of("decompress"),
                              trace.total_ns(kernels))
