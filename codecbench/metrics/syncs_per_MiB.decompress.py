"""Waits of the host on the card (the port's counter ``syncs``) per MiB of
content, summed over the decompress calls' root spans."""

from codecbench import portspans


def read(run):
    per_byte = portspans.counts_per_byte(run, "decompress", "syncs")
    return None if per_byte is None else per_byte * (1 << 20)
