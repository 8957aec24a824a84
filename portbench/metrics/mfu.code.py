"""Device: model FLOPs over the busy engine steps' time at the bf16 peak
(%)."""
from portbench import readers


def read(rec):
    return readers.mfu_busy_steps(rec)
