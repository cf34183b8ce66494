"""Device time of the host-to-device and device-to-host memcpys inside
the decompress calls' spans, in ms per MiB of content."""

from codecbench import trace


def read(run):
    copies = [d for d in run.trace.inside("decompress")
              if trace.is_host_copy(d)]
    if not copies:
        return None
    return trace.per_mib(run.trace.spans_of("decompress"),
                         trace.total_ns(copies))
