"""The AdamW pieces and the loss of the port against the reference's JAX
package on the CPU: ``schedule``, ``global_norm`` and ``_decay_mask``
over the trees of every family (reduced configs, the reference's init
carried over by ``repro_torch.bridge``), ``softmax_cross_entropy``, and
the bridge's optimizer-state converter.

Tolerances: ``schedule`` 1e-7 relative (one fp32 cosine);
``global_norm`` 1e-6 relative (fp32 sums in another order); the decay
decision equal, leaf by leaf; ``softmax_cross_entropy`` 1e-6; the
optimizer state byte-exact through the bridge and back.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.optim.adamw import _decay_mask as jax_decay_mask
from repro_torch import optim
from repro_torch.bridge import (opt_state_from_jax, opt_state_to_numpy,
                                params_from_jax)
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.optim.adamw import _decay_mask

torch.set_num_threads(2)


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch, reduced=True),
                                compute_dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype="float32"))


def _init(jcfg, seed):
    jm = jax_build_model(jcfg)
    return jm, jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed)))


def test_schedule_matches_reference():
    opt, jopt = (optim.OptConfig(warmup_steps=7, decay_steps=50),
                 jax_optim.OptConfig(warmup_steps=7, decay_steps=50))
    for step in (0, 1, 6, 7, 8, 20, 49, 50, 51, 1000):
        want = float(jax_optim.schedule(jopt, jnp.int32(step)))
        got = float(optim.schedule(opt, torch.tensor(step,
                                                     dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-7, abs=0), step


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "kimi-k2-1t-a32b", "recurrentgemma-2b",
                                  "rwkv6-7b", "whisper-medium",
                                  "internvl2-2b"])
def test_global_norm_and_decay_mask_match_reference(arch):
    """On the reference's init tree carried into the port's layout: the
    same global norm, and for every leaf the decay decision the
    reference's ``_decay_mask`` takes on its path (norm scales and
    biases, the recurrent mu/lam/decay_base/bonus leaves, ``bq``'s
    substring miss)."""
    jcfg, _ = _cfgs(arch)
    _, jp = _init(jcfg, 1)
    tp = params_from_jax(jp)
    want = float(jax_optim.global_norm(jp))
    assert float(optim.global_norm(tp)) == pytest.approx(want, rel=1e-6)

    flags = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), jax_decay_mask(path),
                                   np.float32), jp)
    want_flags = flatten_with_path(params_from_jax(flags))
    got = flatten_with_path(tp)
    assert [p for p, _ in got] == [p for p, _ in want_flags]
    decided = set()
    for (path, _), (_, flag) in zip(got, want_flags):
        assert bool(flag.all()) == bool(flag.any()), path
        assert _decay_mask(path) == bool(flag.all()), path
        decided.add(_decay_mask(path))
    assert decided == {True, False}


@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_softmax_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = {"none": None,
            "some": (rng.random((3, 7)) < 0.6).astype(np.float32),
            "all": np.zeros((3, 7), np.float32)}[masked]
    want, wn = jax_layers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got, n = layers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert float(n) == float(wn)
    assert float(got) == pytest.approx(float(want), abs=1e-6, rel=1e-6)


def test_opt_state_round_trip():
    """The bridge's optimizer-state converter, both ways, byte-exact."""
    jcfg, cfg = _cfgs("qwen1.5-0.5b")
    _, jp = _init(jcfg, 0)
    st = jax.device_get(jax_optim.init(jax_optim.OptConfig(), jp))
    st = {"m": jax.tree.map(lambda x: x + 0.5, st["m"]),
          "v": jax.tree.map(lambda x: x + 0.25, st["v"]),
          "step": np.int32(3)}
    back = opt_state_to_numpy(opt_state_from_jax(st), cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(st)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
