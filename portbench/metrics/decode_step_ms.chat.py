"""Model step: a fused decode call between two synchronisations (ms)."""
from portbench import readers


def read(rec):
    return readers.call_ms(rec, "decode_paged_fused")
