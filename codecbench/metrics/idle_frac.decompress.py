"""1 - the union of kernel, memcpy and memset intervals inside the
decompress calls' spans, over the sum of the spans' walls (the arithmetic of
the repository's chip_profile.py).  Tracing adds host time, so this is an
upper bound for an untraced call."""

from codecbench import trace


def read(run):
    spans = run.trace.spans_of("decompress")
    wall = trace.span_ns(spans)
    if not spans or wall <= 0 or not run.trace.device:
        return None
    return 1.0 - trace.union_ns(run.trace.inside("decompress")) / wall
