"""Wrapper of the RWKV-6 WKV kernel, with the call contract of
``repro.kernels.rwkv6_wkv.ops.rwkv6_wkv_op``: fp32 r, k, v, logw
(B, H, S, K), u (H, K), s0 (B, H, K, K) → (o (B, H, S, K), s_final
(B, H, K, K)), any S, K ∈ {32, 64}.

A CUDA tensor launches ``csrc/rwkv6_wkv.cu`` on the current stream (no
sequence padding); a CPU tensor runs :func:`rwkv6_wkv_ref`."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref

NAME = "rwkv6_wkv"
HEAD_DIMS = (32, 64)


def rwkv6_wkv_op(r, k, v, logw, u, s0):
    require = common.require
    require(r.dim() == 4 and k.shape == v.shape == logw.shape == r.shape,
            f"rwkv6_wkv takes r, k, v, logw (B,H,S,K), got {tuple(r.shape)}")
    B, H, S, K = r.shape
    require(u.shape == (H, K) and s0.shape == (B, H, K, K),
            f"u must be {(H, K)} and s0 {(B, H, K, K)}")
    require(all(t.dtype == torch.float32 for t in (r, k, v, logw, u, s0)),
            "rwkv6_wkv takes fp32 inputs")
    if common.on_cpu(r, k, v, logw, u, s0):
        return rwkv6_wkv_ref(r, k, v, logw, u, s0)
    require(K in HEAD_DIMS, f"kernel takes K in {HEAD_DIMS}, got {K}")
    require(B * H > 0 and S > 0, "empty WKV")
    common.check_contiguous(r=r, k=k, v=v, logw=logw, u=u, s0=s0)
    o = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    fn = common.entry(NAME, "rwkv6_wkv", "ppppppppiiiip")
    code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
              u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
              B, H, S, K, common.stream_of(r))
    common.check(code, "rwkv6_wkv")
    common.LAUNCHES[NAME] += 1
    return o, s_fin
