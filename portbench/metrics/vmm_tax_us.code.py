"""Tenant layer, code-completion cell: the VMM's host time per data-plane
op (us)."""
from portbench import readers


def read(rec):
    return readers.vmm_tax_us(rec)
