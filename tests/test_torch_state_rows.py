"""State rows that own their storage: after a recurrent prefill
(``recurrentgemma-2b``'s RG-LRU ``h`` and conv tail, ``rwkv6-7b``'s two
token-shift rows and WKV state) every leaf the caches hold is a tensor
of its own size, not a view that keeps a whole (B, S, d) activation
alive for as long as the caches live; and decoding from those caches
still follows the reference's JAX ``Model`` on the same weights.

Reduced configs on the CPU. Tolerances as ``tests/test_torch_ring_recurrent.py``:
logits at 1e-5 in fp32 compute (the reference with ``use_pallas=True``,
its kernels in interpret mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.models import Model

torch.set_num_threads(2)

ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
TOL = 1e-5
B, S, N_DECODE = 2, 21, 6


def _toks(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _own_storage(caches):
    """→ the paths of the leaves whose storage is larger than the leaf."""
    return [path for path, t in flatten_with_path(caches)
            if t.untyped_storage().nbytes() != t.numel() * t.element_size()]


@pytest.mark.parametrize("capacity", [None, 32, 16])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_state_rows_own_their_storage(arch, cd, capacity):
    """Every leaf of the prefill's caches — recurrent rows and rings —
    holds storage of exactly its own bytes (a view of the layer's
    activation would hold S times the row's), with and without ring
    capacities below and above S."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=cd)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    _, caches = m.prefill(params, {"tokens": torch.from_numpy(
        _toks(1, cfg.vocab))}, capacity=capacity)
    assert caches["rows"], "a recurrent stack keeps rows"
    assert _own_storage(caches) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_owned_rows_follows_the_reference(arch):
    """The reference's ``prefill(capacity=S)`` and ``N_DECODE`` decode
    steps against the port's, fp32 compute: the rows are copies of the
    same values, so every step's logits agree as before."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32", use_pallas=True)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    m, p = Model(cfg, device="cpu"), params_from_jax(jax.device_get(jp))
    toks = _toks(2, cfg.vocab)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=S)
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, capacity=S)
    assert _own_storage(tc) == []
    jdec = jax.jit(jm.decode)
    for pos in range(S, S + N_DECODE):
        np.testing.assert_allclose(
            tl[:, :cfg.vocab].numpy(), np.asarray(jl)[:, :cfg.vocab],
            atol=TOL, rtol=TOL)
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = m.decode(p, tc, torch.from_numpy(tok),
                          torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(tl[:, :cfg.vocab].numpy(),
                               np.asarray(jl)[:, :cfg.vocab], atol=TOL,
                               rtol=TOL)
