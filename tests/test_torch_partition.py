"""The port's partition rules against the reference's, for every
architecture of the repo at full size on the production meshes (16×16
and 2×16×16, given by their axis sizes: no ranks needed).

* ``param_specs`` equals ``param_pspecs`` leaf by leaf through the
  bridge's layout map (a scanned reference leaf drops its leading None;
  the port keeps one dict per layer);
* ``cache_specs`` equals ``cache_pspecs`` for B=128 (heads or split-KV
  over "model") and B=1 (the sequence over ("data", "model")); the
  port's stacked K/V leaves lead with an unsharded layer axis;
* ``batch_specs`` equals ``batch_pspecs`` for a train cell of B=256 and
  of B=1;
* every proposed axis divides its dimension; ``_sanitize`` agrees with
  the reference's on random specs; ``placements`` maps a spec to DTensor
  placements, a tuple of axes to ``Shard`` on each.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.models import build_model as jax_build_model
from repro.parallel import partition as ref
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.models import Model, lm
from repro_torch.parallel import partition as part

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = sorted(list_archs())
CAP = 4096


def ref_mesh(sizes):
    return types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))


def spec_tuple(p):
    return tuple(p)


def _site_specs(port_layers, ref_segments, cfg, specs, port_leaf_spec):
    """(port spec, reference spec with a scan's periods axis dropped)
    for every leaf of every layer."""
    for si, li, idx, spec, scan in lm.layout_layers(cfg, specs):
        site = ref_segments[si][li]
        for layer in idx:
            for path, leaf_spec in _leaves(port_layers[layer]):
                want = site
                for k in path:
                    want = want[k]
                want = spec_tuple(want)
                if scan:
                    assert want[0] is None, (path, want)
                    want = want[1:]
                yield (layer,) + path, port_leaf_spec(leaf_spec), want


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _is_p(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.fixture(scope="module")
def abstract():
    """Per arch: the port's meta parameters and the reference's
    abstract ones (``jax.eval_shape`` of ``init``)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        out[arch] = (Model(cfg, device="meta").init(None),
                     jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                                    jax.random.PRNGKey(0)))
    return out


def _check_divides(tree, specs, sizes):
    for (path, t), (_, spec) in zip(_leaves(tree), _leaves(specs)):
        assert len(spec) == t.dim(), (path, spec, tuple(t.shape))
        for d, e in enumerate(spec):
            n = int(np.prod([sizes[a] for a in part.spec_axes(e)]))
            assert t.shape[d] % n == 0, (path, d, e, tuple(t.shape))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(abstract, arch, mesh):
    sizes = MESHES[mesh]
    cfg = get_config(arch)
    port_p, ref_p = abstract[arch]
    got = part.param_specs(cfg, port_p, sizes)
    want = ref.param_pspecs(jax_get_config(arch), ref_p, ref_mesh(sizes))
    _check_divides(port_p, got, sizes)
    for k in got:
        if k in ("layers", "encoder"):
            continue
        for (path, g), (_, w) in zip(_leaves(got[k]), _leaves(
                jax.tree.map(spec_tuple, want[k], is_leaf=_is_p))):
            assert g == w, (k, path, g, w)
    n = 0
    for path, g, w in _site_specs(got["layers"], want["segments"], cfg,
                                  lm.layer_specs(cfg), lambda s: s):
        assert g == w, (path, g, w)
        n += 1
    assert n == len(list(_leaves(got["layers"])))
    if cfg.is_encdec:
        for path, g, w in _site_specs(got["encoder"]["layers"],
                                      want["encoder"]["segments"], cfg,
                                      lm.encoder_specs(cfg), lambda s: s):
            assert g == w, ("encoder",) + path
        assert got["encoder"]["final_norm"]["scale"] == spec_tuple(
            want["encoder"]["final_norm"]["scale"])


@pytest.mark.parametrize("batch", (128, 1))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh, batch):
    sizes = MESHES[mesh]
    cfg = get_config(arch)
    caches = Model(cfg, device="meta").init_cache(batch, CAP)
    got = part.cache_specs(cfg, caches, sizes, batch)
    jm = jax_build_model(jax_get_config(arch))
    want = ref.cache_pspecs(jax_get_config(arch),
                            jax.eval_shape(lambda: jm.init_cache(batch, CAP)),
                            ref_mesh(sizes), batch)
    _check_divides(caches, got, sizes)
    specs = lm.layer_specs(cfg)
    aidx = lm.attn_index(specs)
    n = 0
    for si, li, idx, spec, scan in lm.layout_layers(cfg, specs):
        site = want[si][li]
        for layer in idx:
            pairs = []
            if spec.is_attn:
                pairs += [(got[k][1:], site["mixer"][k]) for k in ("k", "v")]
                assert got["k"][0] is None and aidx[layer] is not None
            rows = got["rows"][layer] if "rows" in got else {}
            pairs += [(rows[key][name], site[key][name])
                      for key in rows for name in rows[key]]
            for g, w in pairs:
                w = spec_tuple(w)
                if scan:
                    assert w[0] is None
                    w = w[1:]
                assert g == w, (layer, g, w)
                n += 1
    assert n > 0


@pytest.mark.parametrize("batch", (256, 1))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, mesh, batch):
    sizes = MESHES[mesh]
    cfg = get_config(arch)
    got = part.batch_specs(cfg, Model(cfg, device="meta").input_specs(
        ShapeCell("t", 4096, batch, "train")), sizes)
    jm = jax_build_model(jax_get_config(arch))
    want = ref.batch_pspecs(jax_get_config(arch), jm.input_specs(
        JaxShapeCell("t", 4096, batch, "train")), ref_mesh(sizes))
    assert set(got) == set(want)
    for k in got:
        assert got[k] == spec_tuple(want[k]), (k, got[k], want[k])


def test_sanitize_equals_the_reference():
    rng = np.random.default_rng(0)
    choices = [None, "data", "model", "pod", ("data", "model"),
               ("pod", "data")]
    sizes = MESHES["2x16x16"]
    for _ in range(500):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 16, 32, 48, 256, 384, 512]))
                      for _ in range(nd))
        spec = tuple(choices[int(rng.integers(len(choices)))]
                     for _ in range(nd))
        assert part._sanitize(spec, shape, sizes) == \
            ref._sanitize(spec, shape, sizes), (spec, shape)


def test_placements_shard_each_named_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert part.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert part.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        part.placements((("model", "data"),), mesh)


def test_local_block_takes_major_to_minor():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 get_coordinate=lambda: [1, 0],
                                 size=lambda i: (2, 4)[i])
    t = torch.arange(16).reshape(16, 1)
    got = part.local_block(t, (("data", "model"), None), mesh)
    assert got[:, 0].tolist() == [8, 9]           # block 1·4 + 0 of 8


def test_meshes_raise_without_a_card_or_a_group():
    """No fallback: a mesh is on the card unless the caller asks for the
    CPU, and needs an initialised process group with enough ranks."""
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no process group"):
        make_local_mesh((1, 1), device_type="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
