"""Device time of the host-to-device and device-to-host memcpys inside
the compress calls' spans, in ms per MiB of content."""

from codecbench import trace


def read(run):
    copies = [d for d in run.trace.inside("compress")
              if trace.is_host_copy(d)]
    if not copies:
        return None
    return trace.per_mib(run.trace.spans_of("compress"),
                         trace.total_ns(copies))
