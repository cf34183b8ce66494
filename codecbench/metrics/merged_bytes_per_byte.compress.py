"""Bytes of the blocks the port joined on the host from kernel payloads
(its counter ``merged_bytes``) over content bytes, summed over the
compress calls' root spans; None for a port without the counter."""

from codecbench import portspans


def read(run):
    return portspans.counts_per_byte(run, "compress", "merged_bytes")
