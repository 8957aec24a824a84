"""Wrapper of the Sobel kernel, with the call contract of
``repro.kernels.sobel.ops.sobel_op``: an (H, W) image → its 3×3 Sobel
gradient magnitude with zero borders. A CUDA tensor launches
``csrc/sobel.cu`` on the current stream (which supplies the zero border
itself: no padded copy); a CPU tensor runs :func:`sobel_ref`."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.sobel.ref import sobel_ref

NAME = "sobel"


def sobel_op(x):
    common.require(x.dim() == 2, f"sobel takes an (H, W) image, got "
                                 f"{tuple(x.shape)}")
    where = common.path(x)
    if where == "cpu":
        return sobel_ref(x)
    common.refuse_grad(NAME, x.device, x)
    if where == "meta":
        out = torch.empty_like(x)
        common.record(NAME, 0, (x,), (out,))
        return out
    common.check_contiguous(x=x)
    H, W = x.shape
    out = torch.empty_like(x)
    fn = common.entry(NAME, "sobel", "ppiiip")
    code = fn(x.data_ptr(), out.data_ptr(), H, W, common.dtype_code(x),
              common.stream_of(x))
    common.check(code, "sobel")
    common.LAUNCHES[NAME] += 1
    common.record(NAME, 0, (x,), (out,))
    return out
