"""Model step: a monolithic prefill call between two synchronisations, per
1000 prompt tokens (ms)."""
from portbench import readers


def read(rec):
    return readers.call_ms_per_ktok(rec, "prefill")
