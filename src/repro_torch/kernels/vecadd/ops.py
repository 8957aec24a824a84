"""Wrapper of the vecadd kernel, with the call contract of
``repro.kernels.vecadd.ops.vecadd_op``: two 1-D tensors of one dtype →
``x + y``. A CUDA tensor launches ``csrc/vecadd.cu`` on the current
stream (any length, no padding); a CPU tensor runs :func:`vecadd_ref`."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.vecadd.ref import vecadd_ref

NAME = "vecadd"


def vecadd_op(x, y):
    require = common.require
    require(x.dim() == 1 and x.shape == y.shape,
            f"vecadd takes two equal 1-D shapes, got {tuple(x.shape)} and "
            f"{tuple(y.shape)}")
    require(x.dtype == y.dtype, "x/y dtypes differ")
    where = common.path(x, y)
    if where == "cpu":
        return vecadd_ref(x, y)
    common.refuse_grad(NAME, x.device, x, y)
    if where == "meta":
        out = torch.empty_like(x)
        common.record(NAME, 0, (x, y), (out,))
        return out
    common.check_contiguous(x=x, y=y)
    out = torch.empty_like(x)
    fn = common.entry(NAME, "vecadd", "ppplip")
    code = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
              common.dtype_code(x), common.stream_of(x))
    common.check(code, "vecadd")
    common.LAUNCHES[NAME] += 1
    common.record(NAME, 0, (x, y), (out,))
    return out
