"""Bytes the port copied between host and card (its counters ``h2d_bytes``
and ``d2h_bytes``) over content bytes, summed over the decompress calls'
root spans."""

from codecbench import portspans


def read(run):
    return portspans.counts_per_byte(run, "decompress", "h2d_bytes",
                                     "d2h_bytes")
