"""The pure-Python parts of the Hopper kernels' redesign, on the CPU.

- The matmul wrapper's TMA padding: the bf16 kernel reads its tiles with
  TMA, which needs 16-byte row strides, so K and N are padded to a
  multiple of 8 with zeros; the padded product, sliced back and computed
  with the plain version, equals the reference's Pallas matmul in
  interpret mode under tests/test_kernels.py's rule (1e-5·√k absolute /
  1e-5 relative in fp32, 2e-1·√k / 2e-1 in bf16).
- The build's ptxas report parser (registers and spills per kernel).
- Flash attention at the tile edges of the tensor-core instance (S = 1,
  64 = one q tile, 65) and at recurrentgemma's hd 256 with 10/1 and a
  window, plain version against the reference's Pallas kernel in
  interpret mode: fp32 at 2e-5 (reassociation only), bf16 at 3e-2 (one
  bf16 rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op as jax_flash
from repro.kernels.matmul.ops import matmul_op as jax_matmul
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.matmul.ops import pad_operands, tma_padding
from repro_torch.kernels.matmul.ref import matmul_ref

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(x, dtype):
    """One numpy array → (jax array, torch tensor) with identical bits."""
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                  dtype)))


# ---------------------------------------------------------------------------
# matmul: TMA padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,want", [
    (4096, 4096, 4096, (4096, 4096)),
    (1000, 1000, 1000, (1000, 1000)),
    (33, 17, 9, (24, 16)),
    (129, 4104, 257, (4104, 264)),
])
def test_tma_padding_rounds_k_and_n_to_eight(m, k, n, want):
    assert tma_padding(k, n) == want


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (1000, 1000, 1000)])
def test_pad_operands_leaves_aligned_shapes_alone(m, k, n):
    x = torch.empty((m, k), dtype=torch.bfloat16)
    y = torch.empty((k, n), dtype=torch.bfloat16)
    xp, yp = pad_operands(x, y)
    assert xp is x and yp is y


def test_pad_operands_copies_a_misaligned_view():
    """A contiguous view whose base is not 16-byte aligned is copied,
    though its shape needs no padding."""
    buf = torch.arange(8 * 16 + 1, dtype=torch.float32).to(torch.bfloat16)
    x = buf[1:].view(8, 16)
    y = torch.ones((16, 8), dtype=torch.bfloat16)
    xp, yp = pad_operands(x, y)
    assert xp is not x and xp.data_ptr() % 16 == 0 and yp is y
    assert torch.equal(xp, x)


@pytest.mark.parametrize("m,k,n,dtype", [(33, 17, 9, "bfloat16"),
                                         (129, 4104, 257, "bfloat16"),
                                         (33, 17, 9, "float32")])
def test_padded_product_matches_pallas(m, k, n, dtype):
    """Zeros in the padded rows and columns add nothing: the padded
    product sliced back equals the reference's matmul."""
    rng = np.random.default_rng(m + k + n)
    jx, tx = _pair(rng.standard_normal((m, k), np.float32), dtype)
    jy, ty = _pair(rng.standard_normal((k, n), np.float32), dtype)
    xp, yp = pad_operands(tx, ty)
    kp, np_ = tma_padding(k, n)
    assert xp.shape == (m, kp) and yp.shape == (kp, np_)
    assert bool((xp[:, k:] == 0).all()) and bool((yp[k:] == 0).all())
    assert bool((yp[:, n:] == 0).all())
    got = matmul_ref(xp, yp)[:m, :n]
    tol = 1e-5 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jax_matmul(jx, jy), np.float32),
                               atol=tol * np.sqrt(k), rtol=tol)


# ---------------------------------------------------------------------------
# the build's ptxas report
# ---------------------------------------------------------------------------

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelAv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelAv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelBv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelBv
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 392 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills():
    assert common.ptxas_usage(PTXAS_LOG) == [("_Z6kernelAv", 168, 0, 0),
                                             ("_Z6kernelBv", 255, 12, 8)]
    assert common.ptxas_usage("") == []


# ---------------------------------------------------------------------------
# flash attention at the tensor-core instance's tile edges
# ---------------------------------------------------------------------------

def _flash_case(B, S, Hq, Hkv, hd, window, dtype, seed):
    rng = np.random.default_rng(seed)
    q, tq = _pair(rng.standard_normal((B, S, Hq, hd), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((B, S, Hkv, hd), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((B, S, Hkv, hd), np.float32), dtype)
    want = jax_flash(q, k, v, causal=True, window=window)
    got = flash_attention_op(tq, tk, tv, causal=True, window=window)
    assert got.shape == (B, S, Hq, hd) and got.dtype == tq.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 64, 65])
def test_flash_at_q_tile_edges_matches_pallas(S, dtype):
    """One row, exactly one 64-row q tile, and one row past it."""
    _flash_case(2, S, 4, 2, 64, 0, dtype, seed=S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd256_mqa_window_matches_pallas(dtype):
    """recurrentgemma's attention: hd 256, 10 q heads on one KV head, a
    window shorter than the sequence."""
    _flash_case(1, 80, 10, 1, 256, 48, dtype, seed=256)
