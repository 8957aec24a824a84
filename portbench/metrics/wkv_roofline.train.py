"""Kernels, RWKV-6's training cell: ``rwkv6_wkv``'s share of its roofline
in the train step's forward and recomputation (%), each call at the
cell's (B, S) (``counts.wkv``); its FLOPs against the fp32 peak outside
the tensor cores, where the kernel computes."""
from portbench import readers
from portbench.counts import peaks, wkv

KERNEL = "wkv_chunk"


def bound_s(conf, mix):
    K = conf["rwkv_head_dim"]
    f, b = wkv.forward(mix["batch"], conf["d_model"] // K, mix["seq_len"], K)
    return peaks.bound_s(f, b, peaks.FP32_FLOPS)


def read(rec):
    return readers.roofline(rec, KERNEL, bound_s)
