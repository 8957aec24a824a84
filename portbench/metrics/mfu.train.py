"""Device, StarCoder2's training cell: model FLOPs of the completed steps
over their time at the bf16 peak (%)."""
from portbench import readers


def read(rec):
    return readers.mfu_window(rec)
