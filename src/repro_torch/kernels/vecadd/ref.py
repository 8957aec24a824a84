"""Plain PyTorch version of the vecadd kernel: the CPU path of
``ops.vecadd_op`` and the yardstick the CUDA kernel is held against."""


def vecadd_ref(x, y):
    """x + y, output in the input dtype (bf16 rounds once, from fp32)."""
    return x + y
