"""Bytes the port copied on the host (its counter ``host_copy_bytes``)
over content bytes, summed over the compress calls' root spans."""

from codecbench import portspans


def read(run):
    return portspans.host_copy_per_byte(run, "compress")
