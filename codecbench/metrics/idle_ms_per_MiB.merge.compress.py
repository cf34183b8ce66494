"""Device-idle time of the compress calls while the port's innermost open
step span was ``merge`` (the host's join of kernel payloads into one
block), in ms per MiB of content (read by ``codecbench/portspans.py``)."""

from codecbench import portspans


def read(run):
    return portspans.idle_ms_per_mib(run, "compress", "merge")
