"""Bytes the port fetched from the card into pinned host memory (its
counter ``pinned_d2h_bytes``) over content bytes, summed over the
decompress calls' root spans.  None on a port without the counter."""

from codecbench import portspans


def read(run):
    return portspans.counts_per_byte(run, "decompress", "pinned_d2h_bytes")
