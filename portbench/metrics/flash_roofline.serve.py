"""Kernels, code-completion cell: ``flash_attention``'s share of its
roofline in the served prefills (%). Each kernel of the trace is matched
to the prefill call it ran in, and bounded by causal GQA attention's
work over that call's prompt (``counts.attention``)."""
from portbench import readers
from portbench.counts import attention, peaks

#: the kernel symbols this metric reads (``csrc/flash_attention.cu``)
KERNEL = "flash_fwd"


def bound_s(conf, tokens):
    f, b = attention.causal_gqa(1, tokens, conf["n_heads"],
                                conf["n_kv_heads"], conf["d_head"])
    return peaks.bound_s(f, b)


def read(rec):
    return readers.roofline(rec, KERNEL, bound_s, call_kind="prefill")
