"""Device: model FLOPs over the window at the bf16 peak (%)."""
from portbench import readers


def read(rec):
    return readers.mfu_window(rec)
