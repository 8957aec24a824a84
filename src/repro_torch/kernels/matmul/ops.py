"""Wrapper of the matmul kernel, with the call contract of
``repro.kernels.matmul.ops.matmul_op``: (M,K) @ (K,N) with an fp32
accumulator, output in the input dtype. A CUDA tensor launches
``csrc/matmul.cu`` on the current stream (ragged edges masked in the
kernel, nothing padded); a CPU tensor runs :func:`matmul_ref`."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.matmul.ref import matmul_ref

NAME = "matmul"


def matmul_op(x, y):
    require = common.require
    require(x.dim() == 2 and y.dim() == 2 and x.shape[1] == y.shape[0],
            f"bad matmul shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    require(x.dtype == y.dtype, "x/y dtypes differ")
    if common.on_cpu(x, y):
        return matmul_ref(x, y)
    common.check_contiguous(x=x, y=y)
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = common.entry(NAME, "matmul", "pppiiiip")
    code = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, K, N,
              common.dtype_code(x), common.stream_of(x))
    common.check(code, "matmul")
    common.LAUNCHES[NAME] += 1
    return out
