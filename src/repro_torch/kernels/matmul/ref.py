"""Plain PyTorch version of the matmul kernel: the CPU path of
``ops.matmul_op`` and the yardstick the CUDA kernel is held against."""
import torch


def matmul_ref(x, y):
    """(M,K) @ (K,N) summed in fp32, output in the input dtype."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)
