"""Wrappers of the fused paged decode kernel and the sampler, with the
call contracts of ``repro.kernels.decode_attention.ops``
(``fused_decode_step_op``, ``sample_tokens_op``).

A CUDA tensor launches ``csrc/fused_paged_decode.cu`` /
``csrc/sample_tokens.cu`` on the current stream; a CPU tensor runs the
plain version in ``ref.py``."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.ref import (fused_paged_decode_ref,
                                                      sample_tokens_ref)

DECODE = "fused_paged_decode"
SAMPLE = "sample_tokens"
HEAD_DIMS = (16, 32, 64, 128)


def fused_decode_step_op(q, k_new, v_new, k_pages, v_pages, lengths,
                         block_tables, *, window=0):
    """q: (B,1,Hq,hd); k_new/v_new: (B,1,Hkv,hd) this step's projected
    and roped K/V (logical index ``lengths-1``); pages: (P,ps,Hkv,hd)
    pools *without* the new token; lengths (B,) int32 include the new
    token; block_tables (B,nb) int32 → (B,1,Hq,hd)."""
    require = common.require
    B, one, Hq, hd = q.shape
    P, ps, Hkv, hd_p = k_pages.shape
    require(one == 1 and hd_p == hd and Hq % Hkv == 0,
            f"q{tuple(q.shape)} does not match pools{tuple(k_pages.shape)}")
    require(k_new.shape == v_new.shape == (B, 1, Hkv, hd),
            f"k_new/v_new must be {(B, 1, Hkv, hd)}")
    require(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    require(lengths.shape == (B,) and block_tables.dim() == 2
            and block_tables.shape[0] == B, "bad lengths/block_tables")
    require(q.dtype == k_new.dtype == v_new.dtype == k_pages.dtype
            == v_pages.dtype, "q/k/v/pool dtypes differ")
    if common.on_cpu(q, k_new, v_new, k_pages, v_pages, lengths,
                     block_tables):
        return fused_paged_decode_ref(q, k_new, v_new, k_pages, v_pages,
                                      lengths, block_tables, window=window)
    require(hd in HEAD_DIMS, f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    require(lengths.dtype == torch.int32
            and block_tables.dtype == torch.int32,
            "lengths and block_tables must be int32")
    common.check_contiguous(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                            v_pages=v_pages, lengths=lengths,
                            block_tables=block_tables)
    out = torch.empty_like(q)
    fn = common.entry(DECODE, "fused_paged_decode_attention",
                      "ppppppppiiiiiiiifp")
    code = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
              k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
              block_tables.data_ptr(), out.data_ptr(), common.dtype_code(q),
              B, Hq, Hkv, hd, ps, block_tables.shape[1], int(window),
              hd ** -0.5, common.stream_of(q))
    common.check(code, "fused_paged_decode_attention")
    common.LAUNCHES[DECODE] += 1
    return out


def sample_tokens_op(logits, temps, noise):
    """On-device argmax/Gumbel-max sampling: (B,V) + (B,) + (B,V) → (B,)
    int32. Inputs are taken in fp32, as the reference kernel takes
    them."""
    require = common.require
    require(logits.dim() == 2 and noise.shape == logits.shape
            and temps.shape == logits.shape[:1], "bad sampler shapes")
    if common.on_cpu(logits, temps, noise):
        return sample_tokens_ref(logits, temps, noise)
    logits = logits.float().contiguous()
    noise = noise.float().contiguous()
    temps = temps.float().contiguous()
    B, V = logits.shape
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    fn = common.entry(SAMPLE, "sample_tokens", "ppppiip")
    code = fn(logits.data_ptr(), noise.data_ptr(), temps.data_ptr(),
              out.data_ptr(), B, V, common.stream_of(logits))
    common.check(code, "sample_tokens")
    common.LAUNCHES[SAMPLE] += 1
    return out
