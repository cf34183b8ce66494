"""The time between the CUDA events that the port's ``tables`` spans record
around the candidate tables of kernels A and I, bubbles between the table
ops included, in ms per MiB of the compress calls' content."""

from codecbench import portspans, trace


def read(run):
    s = portspans.split(run)
    if s is None or s.tables_ms is None:
        return None
    return trace.per_mib(run.trace.spans_of("compress"), s.tables_ms * 1e6)
