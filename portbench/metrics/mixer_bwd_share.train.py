"""Training layer, StarCoder2's training cell: share of the device time
under the mixer's autograd backward (%)."""
from portbench import readers


def read(rec):
    return readers.mixer_bwd_share(rec)
