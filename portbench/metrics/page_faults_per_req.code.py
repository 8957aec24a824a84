"""Paging layer: the engine's page faults per completed request."""
from portbench import readers


def read(rec):
    return readers.page_faults_per_req(rec)
