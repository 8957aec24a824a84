"""Kernels, StarCoder2's training cell: ``flash_attention``'s share of
its roofline in the train step's forward and recomputation (%), each
call at the cell's (B, S) (``counts.attention``)."""
from portbench import readers
from portbench.counts import attention, peaks

KERNEL = "flash_fwd"


def bound_s(conf, mix):
    f, b = attention.causal_gqa(mix["batch"], mix["seq_len"],
                                conf["n_heads"], conf["n_kv_heads"],
                                conf["d_head"])
    return peaks.bound_s(f, b)


def read(rec):
    return readers.roofline(rec, KERNEL, bound_s)
