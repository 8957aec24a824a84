"""Tenant layer, StarCoder2's training cell: the VMM's host time per train
step (us)."""
from portbench import readers


def read(rec):
    return readers.vmm_tax_us(rec)
