"""Engine layer: the window over the engine steps it ran (ms)."""
from portbench import readers


def read(rec):
    return readers.engine_step_ms(rec)
