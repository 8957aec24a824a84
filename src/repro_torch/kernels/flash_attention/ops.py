"""Wrapper of the flash-attention forward kernel, with the call contract
of ``repro.kernels.flash_attention.ops.flash_attention_op``: model
layout (B, S, H, hd) in and out, causal and sliding-window masks, GQA
by head arithmetic.

A CUDA tensor launches ``csrc/flash_attention.cu`` on the current
stream; a CPU tensor runs :func:`flash_attention_ref`. The kernel masks
the ragged Sq/Sk edge itself, so nothing is padded here. bf16 runs on
the tensor cores, fp32 on the SIMT instance (see the source note)."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)


def flash_attention_op(q, k, v, *, causal=True, window=0):
    """q: (B,Sq,Hq,hd); k/v: (B,Sk,Hkv,hd) → (B,Sq,Hq,hd)."""
    require = common.require
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
            f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    require(k.shape[0] == B and k.shape[3] == hd and Hq % Hkv == 0,
            f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    require(q.dtype == k.dtype == v.dtype, "q/k/v dtypes differ")
    if common.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    require(hd in HEAD_DIMS, f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    require(Sq > 0 and Sk > 0, "empty sequence")
    common.check_contiguous(q=q, k=k, v=v)
    require(q.dtype != torch.bfloat16
            or all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "the bf16 flash kernel reads 16-byte chunks: q/k/v bases must "
            "be 16-byte aligned")
    out = q.new_empty(q.shape)
    fn = common.entry(NAME, "flash_attention_fwd", "ppppiiiiiiiiifp")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              common.dtype_code(q), B, Sq, Sk, Hq, Hkv, hd, int(causal),
              int(window), hd ** -0.5, common.stream_of(q))
    common.check(code, "flash_attention_fwd")
    common.LAUNCHES[NAME] += 1
    return out
