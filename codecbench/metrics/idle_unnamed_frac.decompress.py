"""The share of the decompress calls' device-idle time in which no step span
of the port was open (``codecbench/portspans.py``)."""

from codecbench import portspans


def read(run):
    return portspans.unnamed_frac(run, "decompress")
