"""The sampler's order and the streamed scan's launch plans, on the CPU.

- The sampler's rule is ``np.argmax``'s: scores ordered totally, a NaN
  above +inf, the lowest index winning among equal scores and among NaNs,
  -0.0 equal to +0.0, an all -inf row picking 0. The port's
  ``sample_tokens_op`` (on the CPU its plain version, the same rule as its
  CUDA kernel) against ``np.argmax(l + n·T)`` on rows of NaN, ±inf and
  signed zeros, exact.
- The reference's Pallas sampler (interpret mode, as tests/test_kernels.py
  runs it) on the same rows: it skips a 2048-wide block whose maximum is
  NaN, and never takes a maximum of -inf (ROADMAP, faults queue). Its
  answers are pinned as they are, not as they should be: a change to them
  is a change to the reference.
- The scan's plain version against the reference's Pallas scan at S = 1,
  S = 2, a ragged D and S on the CUDA kernel's stage edges, fp32 at 2e-4
  (tests/test_torch_recurrent_layers.py's tolerance).
- The sampler's launch plan: its slices cover [0, V) exactly once with
  16-byte interior edges.
- What chip_smoke.py and tools/scan_sample_variants.py read from the two
  kernel sources: the scan's tile, steps and stages, and every variant's
  text substitution, each found where the tool expects it.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    sample_tokens_op as jax_sample
from repro.kernels.rglru_scan.ops import rglru_scan_op as jax_rglru
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.ops import (
    CLUSTER_MAX, SAMPLE_MIN_SHARE, sample_plan, sample_tokens_op)
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import chip_smoke  # noqa: E402
import scan_sample_variants as variants  # noqa: E402

torch.set_num_threads(2)

NAN, INF = float("nan"), float("inf")
V = 4096                                 # two of the reference's blocks


def _base():
    """A row whose block maxima are known: 20 at 7 (block 0), 10 at 3118
    (block 1), every other score below 6."""
    x = np.random.default_rng(0).standard_normal(V).astype(np.float32)
    x[7], x[3118] = 20.0, 10.0
    return x


def _row(sets=(), fill=None):
    x = _base() if fill is None else np.full(V, fill, np.float32)
    for i, v in sets:
        x[i] = v
    return x


def _zeros_neg_first():
    x = np.zeros(V, np.float32)
    x[:100] = -0.0
    return x


_INF_NOISE = np.zeros(V, np.float32)
_INF_NOISE[3000] = INF
_NINF_NOISE = np.zeros(V, np.float32)
_NINF_NOISE[2000] = -INF

#: name → (logits, temp, noise or None, np.argmax's answer, the reference's)
ROWS = {
    "a NaN at 100": (_row([(100, NAN)]), 0.0, None, 100, 3118),
    "a NaN at 0": (_row([(0, NAN)]), 0.0, None, 0, 3118),
    "two NaNs": (_row([(2100, NAN), (3000, NAN)]), 0.0, None, 2100, 7),
    "all NaN": (_row(fill=NAN), 0.0, None, 0, 0),
    "all -inf": (_row(fill=-INF), 0.0, None, 0, 0),
    "+inf before a NaN": (_row([(10, INF), (2500, NAN)]), 0.0, None, 2500,
                          10),
    "a NaN before +inf": (_row([(10, NAN), (2500, INF)]), 0.0, None, 10,
                          2500),
    "-0.0 before +0.0": (_row([(5, -0.0), (9, 0.0)], fill=-INF), 0.0, None,
                         5, 5),
    "zero row, -0.0 first": (_zeros_neg_first(), 0.0, None, 0, 0),
    "T=0, +inf in the noise": (_base(), 0.0, _INF_NOISE, 3000, 7),
    "T=0, -inf in the noise": (_base(), 0.0, _NINF_NOISE, 2000, 3118),
    "T=0.5, a NaN logit": (_row([(3500, NAN)]), 0.5, np.ones(V, np.float32),
                           3500, 7),
}


def _batch(name):
    logits, temp, noise, want_np, want_ref = ROWS[name]
    noise = np.zeros(V, np.float32) if noise is None else noise
    return logits[None], np.asarray([temp], np.float32), noise[None], \
        want_np, want_ref


@pytest.mark.parametrize("name", list(ROWS))
def test_sampler_follows_np_argmax(name):
    logits, temps, noise, want, _ = _batch(name)
    with np.errstate(invalid="ignore"):                # 0 · inf is NaN
        host = np.argmax(logits + noise * temps[:, None], axis=-1)
    assert int(host[0]) == want
    got = sample_tokens_op(torch.from_numpy(logits), torch.from_numpy(temps),
                           torch.from_numpy(noise))
    assert got.dtype == torch.int32 and got.tolist() == [want]


@pytest.mark.parametrize("name", list(ROWS))
def test_reference_sampler_skips_nan_blocks(name):
    """What the reference's Pallas sampler returns on the same rows today
    (a NaN block max matches no column and never beats the running max;
    a -inf block max never beats the -1e30 start)."""
    logits, temps, noise, _, want = _batch(name)
    got = jax_sample(jnp.asarray(logits), jnp.asarray(temps),
                     jnp.asarray(noise))
    assert int(np.asarray(got)[0]) == want


def test_sampler_rows_mixed_in_one_batch():
    """Every row of :data:`ROWS` at once, each against ``np.argmax``."""
    names = list(ROWS)
    batches = [_batch(n) for n in names]
    logits = np.concatenate([b[0] for b in batches])
    temps = np.concatenate([b[1] for b in batches])
    noise = np.concatenate([b[2] for b in batches])
    got = sample_tokens_op(torch.from_numpy(logits), torch.from_numpy(temps),
                           torch.from_numpy(noise))
    assert got.tolist() == [b[3] for b in batches]


# ---------------------------------------------------------------------------
# the scan's plain version against the reference
# ---------------------------------------------------------------------------

#: the kernel's stage (32 steps) and ring (3 stages) edges, at a D ragged
#: against its tile of 16
STAGE_EDGES = [(2, S, 300) for S in (31, 32, 33, 95, 96, 97)]


@pytest.mark.parametrize("B,S,D", [(2, 1, 128), (2, 2, 256), (3, 37, 300),
                                   (1, 33, 20), (2, 70, 12)] + STAGE_EDGES)
def test_rglru_scan_short_and_ragged_matches_pallas(B, S, D):
    rng = np.random.default_rng(B * S + D)
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    want = jax_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = rglru_scan_op(*map(torch.from_numpy, (a, b, h0)))
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


# ---------------------------------------------------------------------------
# the sampler's launch plan
# ---------------------------------------------------------------------------

def _covers_once(spans, n):
    """Adjacent, non-empty spans from 0 to n."""
    assert spans and spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < e for a, e in spans)
    assert all(e == a2 for (_, e), (a2, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("sm", [132, 114])
@pytest.mark.parametrize("B", [1, 4, 16, 64, 300])
@pytest.mark.parametrize("V", [1, 5, 1000, 4096, 65536, 152061, 152064,
                               256000])
def test_sample_plan_covers_the_row_once(V, B, sm):
    ctas, share = sample_plan(B, V, sm)
    assert 1 <= ctas <= CLUSTER_MAX and share % 4 == 0
    _covers_once([(r * share, min(V, (r + 1) * share)) for r in range(ctas)],
                 V)
    # one wave of two CTAs an SM, and no slice below the minimum unless
    # the row is one slice
    assert ctas == 1 or (B * ctas <= 2 * sm and share >= SAMPLE_MIN_SHARE)


def test_sample_plan_at_the_served_shapes():
    assert sample_plan(4, 152064, 132) == (16, 9504)
    assert sample_plan(4, 256000, 132) == (16, 16000)
    assert sample_plan(4, 65536, 132) == (16, 4096)
    assert sample_plan(64, 152064, 132) == (4, 38016)


# ---------------------------------------------------------------------------
# what the chip check and the variant tool read from the kernel sources
# ---------------------------------------------------------------------------

def test_scan_geometry_read_from_the_source():
    """chip_smoke.py's scan check puts S on the stages' edges it reads
    here."""
    assert [chip_smoke.cu_constant("rglru_scan", n)
            for n in ("TILE", "STEPS", "STAGES")] == [16, 32, 3]
    assert [s for _, s, _ in STAGE_EDGES] == [31, 32, 33, 95, 96, 97]


def _variant_cases():
    cases = []
    for kernel, named in variants.VARIANTS.items():
        ablate = (variants.SCAN_ABLATE if kernel == "rglru_scan"
                  else variants.SAMPLE_ABLATE)
        cases += [(kernel, name, subs) for name, subs in named.items()]
        cases += [(kernel, f"ablate-{name}", subs)
                  for name, subs in ablate.items()]
    return cases


@pytest.mark.parametrize("kernel,name,subs", _variant_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_variant_substitutions_apply(kernel, name, subs):
    """Every substitution of the tool is found in the kernel's source as
    many times as it says (``_substitute`` raises otherwise)."""
    text = (common.CSRC / f"{kernel}.cu").read_text()
    out = variants._substitute(name, text, subs)
    assert out != text or not name.startswith("ablate-")
