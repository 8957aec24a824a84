"""Device, RWKV-6's training cell: share of the traced window with nothing
running on the card (%)."""
from portbench import readers


def read(rec):
    return readers.idle_share(rec)
