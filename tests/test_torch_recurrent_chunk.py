"""The reduced recurrent models in the port against the reference's JAX
``Model`` (continued from tests/test_torch_recurrent.py, whose helpers
it uses; split so that each file stays short): chunked prefill against
one-shot prefill with a 1-token last chunk, and one slot's per-slot rows
in the reference's leaf order. fp32 compute; tolerances as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recurrent import (ARCHS, NB, PS, TOL, _build, _close,
                                  _paged_pair, _prompt, _state_close)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' reduced model, fp32 compute, same weights."""
    return _build(request.param, "float32")


def test_chunked_prefill_matches_one_shot(pair):
    """Chunks of 8 into slot 1 of two (8 + 8 + a 1-token last chunk):
    the port agrees with the reference chunk for chunk, its last chunk's
    logits agree with its own one-shot prefill, and slot 0's rows are
    never touched."""
    arch, cd, cfg, jm, jp, m, p = pair
    plen, chunk = 17, 8
    block_row = np.asarray([2, 0, 3, 1], np.int32)
    prompt = _prompt(plen, 3, cfg.vocab)
    js = jm.init_paged_state(2, NB, PS)
    ts = m.init_paged_state(2, NB, PS)
    for start in range(0, plen, chunk):
        t = prompt[None, start:start + chunk]
        want, js = jm.prefill_chunk_paged(jp, js, jnp.asarray(t),
                                          jnp.int32(1),
                                          jnp.asarray(block_row),
                                          jnp.int32(start))
        got, ts = m.prefill_chunk_paged(p, ts, torch.from_numpy(t).long(), 1,
                                        torch.from_numpy(block_row), start)
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], TOL[cd])
    one, _ = m.prefill(p, {"tokens": torch.from_numpy(prompt[None]).long()})
    tol = 1e-3 if cd == "float32" else TOL[cd]
    _close(got[:, :cfg.vocab], one[:, :cfg.vocab].float().numpy(), tol)
    assert not any(bool(leaf.any()) for leaf in m.read_state_row(ts, 0))
    _state_close(cfg, ts, js, tol)


def test_state_rows_round_trip_in_reference_order(pair):
    """read/write/reset of one slot's rows: the leaf list matches the
    reference's ``gather_state_row`` leaf for leaf (shape, dtype,
    value), writes land in that slot only, reset zeroes it."""
    arch, cd, cfg, jm, jp, m, p = pair
    bt, js, ts = _paged_pair(cfg, jm, jp, m, p, [9, 14])
    want = jax.device_get(jm.read_state_row(js, 1))
    got = m.read_state_row(ts, 1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
        _close(a, np.asarray(b, np.float32), TOL[cd])
    keep = [leaf.clone() for leaf in m.read_state_row(ts, 0)]
    ts = m.reset_state_row(ts, 1)
    assert not any(bool(leaf.any()) for leaf in m.read_state_row(ts, 1))
    ts = m.write_state_row(ts, 1, got)
    for a, b in zip(m.read_state_row(ts, 1), got):
        assert torch.equal(a, b)
    for a, b in zip(m.read_state_row(ts, 0), keep):
        assert torch.equal(a, b)
