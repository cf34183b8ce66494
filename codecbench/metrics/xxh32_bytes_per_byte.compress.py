"""Bytes the port hashed on the host (its counter ``xxh32_bytes``) over
content bytes, summed over the compress calls' root spans."""

from codecbench import portspans


def read(run):
    return portspans.counts_per_byte(run, "compress", "xxh32_bytes")
