"""Wrapper of the flash-attention forward kernel, with the call contract
of ``repro.kernels.flash_attention.ops.flash_attention_op``: model
layout (B, S, H, hd) in and out, causal and sliding-window masks, GQA
by head arithmetic, and a gradient.

A CUDA tensor launches ``csrc/flash_attention.cu`` on the current
stream; a CPU tensor runs :func:`flash_attention_ref`. The kernel masks
the ragged Sq/Sk edge itself, so nothing is padded here. bf16 runs on
the tensor cores, fp32 on the SIMT instance (see the source note).

Both devices go through one ``torch.autograd.Function``, the counterpart
of the reference's ``custom_vjp`` (``_fa``/``_fa_fwd``/``_fa_bwd``): its
forward is the kernel (or the plain version on the CPU) and saves q, k
and v; its backward recomputes the attention with the plain formula
under ``torch.enable_grad()`` and returns its vector-Jacobian product,
as ``_fa_bwd`` does through ``jax.vjp`` of ``flash_attention_ref``. The
reference has no backward Pallas kernel (its backward is XLA autodiff of
that formula), so neither has the port: the recompute in torch ops is
the counterpart of that XLA code. The forward launches the kernel on
every call, also in a rematerialised layer's recompute."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs import spans as obs_spans

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
    return _Flash.apply(q, k, v, bool(causal), int(window))


#: the reference's XLA attention (``repro.models.attention``): one dense
#: score tensor up to this many keys, else chunks of this many queries
DIRECT_MAX = 2048
CHUNK_Q = 512


def flops(q_shape, Sk, window=0):
    """The dot FLOPs of one forward call as the reference's XLA form of
    the same call counts them (``attention_core``: the dense scores and
    p·v up to :data:`DIRECT_MAX` keys, every chunk of ``_chunked_full``
    past it, and ``_banded_swa``'s band of keys a query chunk when
    ``0 < window < Sk``), masked entries included."""
    B, Sq, Hq, hd = q_shape
    keys = Sk
    if Sk > DIRECT_MAX and 0 < window < Sk:
        cq = min(CHUNK_Q, Sq)
        keys = min(Sk, (-(-window // cq) + 1) * cq)
    return 4 * B * Hq * Sq * keys * hd


class _Flash(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU). Backward: the
    plain formula recomputed from the saved q, k, v and differentiated
    (reference ``ops.py:_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        where = common.path(q, k, v)
        if where == "cpu":
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        out = q.new_empty(q.shape) if where == "meta" else \
            _kernel(q, k, v, causal, window)
        common.record(NAME, flops(q.shape, k.shape[1], window), (q, k, v),
                      (out,))
        return out

    @staticmethod
    def backward(ctx, g):
        tl = obs_spans.ACTIVE
        sid = tl.open("mixer.backward", tag="attn") if tl is not None else 0
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_ref(*qkv, causal=ctx.causal,
                                      window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        if sid:
            tl.close(sid)
        return dq, dk, dv, None, None


def _kernel(q, k, v, causal, window):
    require = common.require
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
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
