"""Sharding over devices: ``mesh`` (one process, several devices) and
``multihost`` (one process per card, on torch.distributed)."""
