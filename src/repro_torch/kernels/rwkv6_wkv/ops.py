"""Wrapper of the RWKV-6 WKV kernel, with the call contract of
``repro.kernels.rwkv6_wkv.ops.rwkv6_wkv_op``: fp32 r, k, v, logw
(B, H, S, K), u (H, K), s0 (B, H, K, K) → (o (B, H, S, K), s_final
(B, H, K, K)), any S, K a multiple of 16 up to 128.

A CUDA tensor launches ``csrc/rwkv6_wkv.cu`` (the chunked form) on the
current stream, one launch a call with no sequence padding; a CPU tensor
runs :func:`rwkv6_wkv_ref`. :func:`wkv_split` picks how many CTAs share
a head's state columns from static shapes and the SM count only.

Both devices go through one ``torch.autograd.Function``: its forward is
the kernel (the plain version on the CPU) and saves the inputs; its
backward recomputes the chunked form (:func:`wkv_chunked`, the
reference's ``_wkv_chunk_scan``) under ``torch.enable_grad()`` and
returns its vector-Jacobian product for r, k, v, logw, u and s0. The
reference trains through XLA autodiff of that function and has no
backward Pallas kernel, so neither has the port: the backward is torch
ops, a loop over the chunks for the carried state only."""

import torch

from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_wkv.chunked import WKV_CHUNK, wkv_chunked
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
from repro_torch.obs import spans as obs_spans

NAME = "rwkv6_wkv"
HEAD_DIMS = tuple(range(16, 129, 16))
SPLITS = (1, 2, 4)


def wkv_split(B, H, K, sm_count):
    """Slices of the state's K columns a (batch, head), each its own CTA:
    doubled (up to 4) while the doubled grid still fits one CTA an SM
    (at rwkv6-7b's B=1, 64 heads: 2 on 132 SMs; at B=4: 1). Each slice
    recomputes the chunk's scores, so more slices than that cost more
    than the CTAs they add (tools/wkv_variants.py; PERF.md, the WKV row)."""
    nv = 1
    while (nv < SPLITS[-1] and B * H * nv * 2 <= sm_count
           and K % (8 * nv) == 0):
        nv *= 2
    return nv


def rwkv6_wkv_op(r, k, v, logw, u, s0):
    require = common.require
    require(r.dim() == 4 and k.shape == v.shape == logw.shape == r.shape,
            f"rwkv6_wkv takes r, k, v, logw (B,H,S,K), got {tuple(r.shape)}")
    B, H, S, K = r.shape
    require(u.shape == (H, K) and s0.shape == (B, H, K, K),
            f"u must be {(H, K)} and s0 {(B, H, K, K)}")
    require(all(t.dtype == torch.float32 for t in (r, k, v, logw, u, s0)),
            "rwkv6_wkv takes fp32 inputs")
    return _Wkv.apply(r, k, v, logw, u, s0)


def flops(shape):
    """The dot FLOPs of one call as the reference's chunked scan
    (``repro.models.recurrent._wkv_chunk_scan``, chunks of
    ``WKV_CHUNK``, a ragged tail padded) compiles them, for r of
    ``shape`` (B, H, S, K): a chunk's read of its initial state, its
    intra-chunk scores (r·D·k over K for every pair: XLA fuses the
    decay into one operand), the scores times v, the bonus and the state
    update."""
    B, H, S, K = shape
    c = min(WKV_CHUNK, S)
    n = -(-S // c)
    per_chunk = (2 * B * c * H * K * K          # r_dec · s
                 + 2 * B * c * c * H * K        # (r·D)·k over K
                 + 2 * B * c * c * H * K        # scores · v
                 + 2 * B * c * H * K            # bonus r·u·k over K
                 + 2 * B * c * H * K * K)       # k_decᵀ · v
    return n * per_chunk


class _Wkv(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU), saving the inputs.
    Backward: the chunked form recomputed and differentiated."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.save_for_backward(r, k, v, logw, u, s0)
        where = common.path(r, k, v, logw, u, s0)
        if where == "cpu":
            return rwkv6_wkv_ref(r, k, v, logw, u, s0)
        if where == "meta":
            o, s_fin = torch.empty_like(r), torch.empty_like(s0)
        else:
            o, s_fin = _kernel(r, k, v, logw, u, s0)
        common.record(NAME, flops(r.shape), (r, k, v, logw, u, s0),
                      (o, s_fin))
        return o, s_fin

    @staticmethod
    def backward(ctx, go, gs):
        tl = obs_spans.ACTIVE
        sid = tl.open("mixer.backward", tag="rwkv") if tl is not None else 0
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            o, s_fin = wkv_chunked(*ins)
            grads = torch.autograd.grad((o, s_fin), ins, (go, gs))
        if sid:
            tl.close(sid)
        return grads


def _kernel(r, k, v, logw, u, s0):
    require = common.require
    B, H, S, K = r.shape
    require(K in HEAD_DIMS, f"kernel takes K in {HEAD_DIMS}, got {K}")
    require(B * H > 0 and S > 0, "empty WKV")
    common.check_contiguous(r=r, k=k, v=v, logw=logw, u=u, s0=s0)
    require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, logw, s0)),
            "the WKV kernel reads 16-byte vectors: r/k/v/logw/s0 bases "
            "must be 16-byte aligned")
    o = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    nv = wkv_split(B, H, K, common.sm_count(r.device))
    fn = common.entry(NAME, "rwkv6_wkv", "ppppppppiiiiip")
    code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
              u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
              B, H, S, K, nv, common.stream_of(r))
    common.check(code, "rwkv6_wkv")
    common.LAUNCHES[NAME] += 1
    return o, s_fin
