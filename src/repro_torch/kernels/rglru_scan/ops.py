"""Wrapper of the RG-LRU scan kernel, with the call contract of
``repro.kernels.rglru_scan.ops.rglru_scan_op``: fp32 ``a``, ``b``
(B, S, D) and ``h0`` (B, D) → ``h`` (B, S, D), any S and D.

A CUDA tensor launches ``csrc/rglru_scan.cu`` on the current stream (the
kernel masks ragged S and D itself: no padding copy like the reference
wrapper's ``a=1, b=0``); a CPU tensor runs :func:`rglru_scan_ref`. The
kernel keeps the serial order of the recurrence, so its output is
bit-equal to the plain version's. Its tile (16 channels a CTA) and its
ring of stages are constants of the kernel source, the same at every
shape."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

NAME = "rglru_scan"


def rglru_scan_op(a, b, h0):
    require = common.require
    require(a.dim() == 3 and b.shape == a.shape
            and h0.shape == (a.shape[0], a.shape[2]),
            f"rglru_scan takes a, b (B,S,D) and h0 (B,D), got "
            f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(h0.shape)}")
    require(a.dtype == b.dtype == h0.dtype == torch.float32,
            "rglru_scan takes fp32 a, b and h0")
    if common.on_cpu(a, b, h0):
        return rglru_scan_ref(a, b, h0)
    B, S, D = a.shape
    require(B > 0 and S > 0 and D > 0, "empty scan")
    common.check_contiguous(a=a, b=b, h0=h0)
    out = torch.empty_like(a)
    fn = common.entry(NAME, "rglru_scan", "ppppiiip")
    code = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), B,
              S, D, common.stream_of(a))
    common.check(code, "rglru_scan")
    common.LAUNCHES[NAME] += 1
    return out
