"""Bytes the port copied between host and card (its counters ``h2d_bytes``
and ``d2h_bytes``) over content bytes, summed over the compress calls'
root spans."""

from codecbench import portspans


def read(run):
    return portspans.counts_per_byte(run, "compress", "h2d_bytes",
                                     "d2h_bytes")
