"""The expert-parallel MoE regimes and the split-KV decode on 4 CPU ranks
(gloo), each against the reference's ``shard_map`` path on 4 forced host
devices, in fp32:

* token routing (``_apply_moe_token_routing``): reduced mixtral with 4
  experts on (2, 2) and (1, 4);
* expert-TP (``_apply_moe_expert_tp``): reduced mixtral with 2 experts
  on (1, 4);
* the 2-D inference regime (the reference's ``_apply_moe_inference_2d``,
  the port's ``_apply_moe_gather_mesh`` with ``mean_aux``): reduced
  kimi-k2 with ``shard_experts_data`` on (2, 2);
* split-KV decode (``_attn_decode_splitk``): reduced recurrentgemma's
  single K/V head on (2, 2) and (1, 4), B=4 (the sequence over "model")
  and B=1 (over ("data", "model") on (2, 2)), full attention and a
  window of 6 over a ring of 16, before and past the wrap.

Every MoE case runs at capacity factor 0.5, so assignments are dropped
(checked against the same call at factor 4, which drops none): outputs
within 2e-5 of the reference's show the same drops, as a different drop
moves a token's row by the size of an expert's output. The aux losses
agree within 2e-5 too, and so does the gradient of sum(y · w) + aux
with respect to every expert leaf, the router, the shared experts and
the input (``jax.grad`` of the reference's path).

The reference's (1, 4) mixtral decode step fails to lower on jax 0.9.0
(a ``ShardingTypeError`` at a gather); that is pinned here, and the
port's (1, 4) mixtral decode is held to the reference's one-device
decode instead. So is the reference's 2-D regime on a mesh with a "pod"
axis, which sums the routed output over "pod" too; the port's there
equals the gather dispatch (reduced kimi-k2 on (2, 1, 2)).
"""
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import test_torch_sharded_steps as base

MOE_CASES = {
    "token-routing-2x2": ("mixtral-8x7b", (2, 2), 4, False),
    "token-routing-1x4": ("mixtral-8x7b", (1, 4), 4, False),
    "expert-tp-1x4": ("mixtral-8x7b", (1, 4), 2, False),
    "inference-2d-2x2": ("kimi-k2-1t-a32b", (2, 2), None, True),
}
SPLITK_CASES = [(mesh, b, w, pos) for mesh in ((2, 2), (1, 4))
                for b in (4, 1) for w in (0, 6) for pos in (5, 21)]
SPLITK_IDS = [f"{m[0]}x{m[1]}-B{b}-w{w}-pos{p}"
              for m, b, w, p in SPLITK_CASES]
B_MOE, S_MOE, C_RING = 4, 8, 16
DEC_ARCH, DEC_STEPS = "mixtral-8x7b", 2
POD_ARCH, POD_MESH = "kimi-k2-1t-a32b", (2, 1, 2)


def moe_cfg(get_config, arch, E, data_split, cf):
    """The reduced config with ``moe_impl="ep"``, ``E`` experts (None:
    the config's), ``shard_experts_data`` and capacity factor ``cf`` —
    one function for both packages (the reference's copy is its
    source)."""
    cfg = get_config(arch, reduced=True)
    moe = dataclasses.replace(cfg.moe, capacity_factor=cf,
                              **({"n_experts": E} if E else {}))
    sharding = dataclasses.replace(cfg.sharding, moe_impl="ep",
                                   shard_experts_data=data_split)
    return dataclasses.replace(cfg, compute_dtype="float32", moe=moe,
                               sharding=sharding)


REFERENCE = "import dataclasses\n" + inspect.getsource(moe_cfg) + \
    textwrap.dedent('''
    import pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.models import attention as attn
    from repro.models.moe import apply_moe, apply_moe_gather, init_moe
    from repro.parallel.steps import build_step_for_cell

    (out, moe_cases, splitk_cases, B, S, C, DEC_ARCH, DEC_STEPS, POD_ARCH,
     POD_MESH) = (sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3]),
                  *map(int, sys.argv[4:7]), sys.argv[7], int(sys.argv[8]),
                  sys.argv[9], eval(sys.argv[10]))
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    sds = lambda t: jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype), t)
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_local_mesh(shape)
        return meshes[shape]

    def run(fn, *args):
        return jax.jit(fn).lower(*sds(args)).compile()(*args)

    rng = np.random.default_rng(3)
    res = {"moe": {}, "splitk": {}}
    for name, (arch, shape, E, data_split) in moe_cases.items():
        cfg = moe_cfg(get_config, arch, E, data_split, 0.5)
        p = to_np(init_moe(cfg, jax.random.PRNGKey(7)))
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        mesh = mesh_of(shape)
        y, aux = run(lambda p, x: apply_moe(cfg, p, x, mesh=mesh), p, x)
        wy = rng.standard_normal(x.shape).astype(np.float32)

        def loss(p, x):
            y, aux = apply_moe(cfg, p, x, mesh=mesh)
            return jnp.sum(y * wy) + aux
        gp, gx = run(jax.grad(loss, argnums=(0, 1)), p, x)
        res["moe"][name] = {"p": p, "x": x, "y": to_np(y),
                            "aux": float(aux), "wy": wy, "gp": to_np(gp),
                            "gx": to_np(gx)}

    cfg = dataclasses.replace(get_config("recurrentgemma-2b", reduced=True),
                              compute_dtype="float32")
    ap = to_np(attn.init_attn(cfg, jax.random.PRNGKey(5)))
    for shape, b, w, pos in splitk_cases:
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        cache = {k: rng.standard_normal(
            (b, C, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
            for k in ("k", "v")}
        mesh = mesh_of(shape)
        y, new = run(lambda p, x1, c, pos: attn.attn_decode(
            cfg, p, x1, c, pos, window=w, mesh=mesh),
            ap, x1, cache, np.int32(pos))
        res["splitk"][(shape, b, w, pos)] = {
            "x1": x1, "cache": cache, "y": to_np(y), "new": to_np(new)}
    res["attn_params"] = ap

    # the 2-D regime on a mesh with a pod axis: the reference also sums
    # over "pod", which splits no weight
    cfg = moe_cfg(get_config, POD_ARCH, None, True, 0.5)
    p = to_np(init_moe(cfg, jax.random.PRNGKey(11)))
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mesh = make_local_mesh(POD_MESH, ("pod", "data", "model"))
    y, _ = run(lambda p, x: apply_moe(cfg, p, x, mesh=mesh), p, x)
    yg, _ = jax.jit(lambda p, x: apply_moe_gather(cfg, p, x))(p, x)
    sh = p["shared"]
    ysh = jnp.dot(jax.nn.silu(x @ sh["w_gate"]) * (x @ sh["w_up"]),
                  sh["w_down"])
    res["pod"] = {"p": p, "x": x, "y": to_np(y), "gather": to_np(yg),
                  "shared": to_np(ysh)}

    # mixtral decode: (1, 4) does not lower; the one-device decode does
    cfg = dataclasses.replace(get_config(DEC_ARCH, reduced=True),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = to_np(model.init(jax.random.PRNGKey(0)))
    toks = rng.integers(0, cfg.vocab, (B, 12)).astype(np.int32)
    dec_toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                for _ in range(DEC_STEPS)]
    dec, _ = build_step_for_cell(cfg, mesh_of((1, 4)),
                                 ShapeCell("d", C, B, "decode"))
    caches0 = to_np(model.init_cache(B, C))
    try:
        dec.lower(*sds((params, caches0, dec_toks[0], np.int32(12))))
        fault = None
    except Exception as e:
        fault = (type(e).__name__, str(e)[:300])
    logits, caches = jax.jit(lambda p, b: model.prefill(p, b, capacity=C))(
        params, {"tokens": toks})
    steps = []
    for i, tok in enumerate(dec_toks):
        logits, caches = jax.jit(model.decode)(params, caches, tok,
                                               np.int32(12 + i))
        steps.append(to_np(logits))
    res["decode"] = {"fault": fault, "params": params, "tokens": toks,
                     "dec_tokens": dec_toks, "logits": steps}
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def start_reference(out):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = base.SRC
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, out, repr(MOE_CASES),
         repr(SPLITK_CASES), str(B_MOE), str(S_MOE), str(C_RING), DEC_ARCH,
         str(DEC_STEPS), POD_ARCH, repr(POD_MESH)], env=env, cwd=base.ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _gathered(local, spec, mesh, shape):
    from repro_torch.parallel import partition as part
    return part.from_local(local.contiguous(), spec, mesh,
                           shape).full_tensor().clone()


def _gathered_tree(local, specs, full, mesh):
    if isinstance(specs, dict):
        return {k: _gathered_tree(local[k], specs[k], full[k], mesh)
                for k in specs}
    return _gathered(local, specs, mesh, tuple(full.shape))


def rank_main(rank, store, ref_path, out_path):
    """Every case of this file on one rank; rank 0 writes the results."""
    import torch.distributed as dist

    from repro_torch.bridge import batch_from_numpy, params_from_jax
    from repro_torch.checkpointing.checkpoint import (flatten_with_path,
                                                      tree_map, unflatten)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import steps
    from repro_torch.parallel.rank_mesh import RankMesh
    base.init_rank(rank, store)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_local_mesh(shape, device_type="cpu")
        return meshes[shape]

    out = {"moe": {}, "splitk": {}}
    for name, (arch, shape, E, data_split) in MOE_CASES.items():
        mesh = mesh_of(shape)
        r = ref["moe"][name]
        p = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in r["p"].items()}
        x = torch.from_numpy(r["x"])
        got = {}
        for cf in (0.5, 4.0):
            cfg = moe_cfg(get_config, arch, E, data_split, cf)
            spec = part.param_specs(cfg, {"layers": [{"ffn": p}]},
                                    mesh)["layers"][0]["ffn"]
            rm = RankMesh(mesh, x.shape[0], specs=spec)
            xs = part.batch_specs(cfg, {"x": x}, mesh)["x"]
            lp = tree_map(lambda t: t.detach().requires_grad_(),
                          part.to_local(part.distribute(p, spec, mesh)))
            lx = part.local_block(x, xs, mesh).detach().requires_grad_()
            y, aux = moe.apply_moe(cfg, lp, lx, rm)
            got[cf] = (_gathered(y.detach(), xs, mesh, tuple(x.shape)),
                       float(aux))
        # the gradient of sum(y · wy) + aux at cf 0.5: each rank's share,
        # seeded 1/n, summed over the axes its leaf is replicated on
        cfg = moe_cfg(get_config, arch, E, data_split, 0.5)
        y, aux = moe.apply_moe(cfg, lp, lx, rm)
        wy = part.local_block(torch.from_numpy(r["wy"]), xs, mesh)
        total = rm.all_reduce((y * wy).sum(), rm.batch_spec_axes()) + aux
        flat = flatten_with_path(lp)
        grads = torch.autograd.grad(
            total, [t for _, t in flat] + [lx],
            grad_outputs=torch.full_like(total, 1.0 / rm.n_ranks))
        gp = steps._reduce_grads(rm, unflatten(lp, {
            path: g for (path, _), g in zip(flat, grads)}), spec)
        gx = rm.all_reduce(grads[-1], [a for a in rm.sizes if a not in
                                       part.sharded_axes(xs)])
        out["moe"][name] = {
            "y": got[0.5][0], "aux": got[0.5][1], "y_no_drops": got[4.0][0],
            "gx": _gathered(gx, xs, mesh, tuple(x.shape)),
            "gp": _gathered_tree(gp, spec, p, mesh)}

    cfg = base.cfg_of("recurrentgemma-2b")
    ap = {k: torch.from_numpy(v) for k, v in ref["attn_params"].items()}
    for case in SPLITK_CASES:
        shape, b, w, pos = case
        mesh = mesh_of(shape)
        r = ref["splitk"][case]
        a_spec = part.param_specs(cfg, {"layers": [{"mixer": ap}]},
                                  mesh)["layers"][0]["mixer"]
        cache = {k: torch.from_numpy(v.copy()) for k, v in r["cache"].items()}
        c_spec = part.cache_specs(cfg, {"k": cache["k"][None]}, mesh,
                                  b)["k"][1:]
        x1 = torch.from_numpy(r["x1"])
        xs = part.batch_specs(cfg, {"x": x1}, mesh)["x"]
        lc = {k: part.local_block(v, c_spec, mesh).clone()
              for k, v in cache.items()}
        rm = RankMesh(mesh, b, capacity=C_RING, specs=a_spec)
        y = attn.attn_decode(cfg, part.to_local(part.distribute(ap, a_spec,
                                                                mesh)),
                             part.local_block(x1, xs, mesh), lc,
                             torch.tensor(pos, dtype=torch.int32),
                             torch.tensor([pos]), window=w, mesh=rm)
        out["splitk"][case] = {
            "y": _gathered(y, xs, mesh, tuple(x1.shape)),
            "new": {k: _gathered(v, c_spec, mesh, tuple(cache[k].shape))
                    for k, v in lc.items()},
            "seq_split": c_spec[1] is not None}

    r = ref["pod"]
    cfg = moe_cfg(get_config, POD_ARCH, None, True, 0.5)
    mesh = make_local_mesh(POD_MESH, ("pod", "data", "model"),
                           device_type="cpu")
    p = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in r["p"].items()}
    x = torch.from_numpy(r["x"])
    spec = part.param_specs(cfg, {"layers": [{"ffn": p}]},
                            mesh)["layers"][0]["ffn"]
    xs = part.batch_specs(cfg, {"x": x}, mesh)["x"]
    y, _ = moe.apply_moe(cfg, part.to_local(part.distribute(p, spec, mesh)),
                         part.local_block(x, xs, mesh),
                         RankMesh(mesh, x.shape[0], specs=spec))
    out["pod"] = _gathered(y, xs, mesh, tuple(x.shape))

    d = ref["decode"]
    cfg = base.cfg_of(DEC_ARCH)
    mesh = mesh_of((1, 4))
    params = params_from_jax(d["params"])
    pf, _ = steps.build_prefill(cfg, mesh,
                                ShapeCell("p", C_RING, B_MOE, "prefill"))
    dp = part.distribute(params, pf.specs[0], mesh)
    _, caches = pf(dp, part.distribute(
        batch_from_numpy({"tokens": d["tokens"]}), pf.specs[1], mesh))
    dec, _ = steps.build_decode(cfg, mesh,
                                ShapeCell("d", C_RING, B_MOE, "decode"))
    out["decode"] = []
    for i, tok in enumerate(d["dec_tokens"]):
        tok = part.distribute({"t": torch.from_numpy(tok)},
                              {"t": dec.specs[2]}, mesh)["t"]
        logits, caches = dec(dp, caches, tok,
                             torch.tensor(12 + i, dtype=torch.int32))
        out["decode"].append(base.full(logits))
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("moe_ep"))
    ref_path = os.path.join(tmp, "ref.pkl")
    out_path = os.path.join(tmp, "port.pkl")
    base.wait(start_reference(ref_path))
    store = tempfile.mktemp(dir=tmp)
    ctx = mp.start_processes(rank_main, nprocs=base.N_RANKS, join=False,
                             start_method="spawn",
                             args=(store, ref_path, out_path))
    base.join_ranks(ctx)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(out_path, "rb") as f:
        port = pickle.load(f)
    return ref, port


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_ep_regime_equals_reference_shard_map(runs, name):
    ref, port = runs
    r, p = ref["moe"][name], port["moe"][name]
    base.close(p["y"], r["y"], 2e-5, f"{name} output")
    base.close(p["aux"], r["aux"], 2e-5, f"{name} aux")
    # assignments were dropped: the same call without drops differs
    assert float((p["y"] - p["y_no_drops"]).abs().max()) > 1e-2, name


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_ep_regime_gradients_equal_reference(runs, name):
    """The gradient of sum(y · w) + aux through each regime's collectives
    (``all_to_all``'s backward the reverse exchange, a gather's a
    reduce-scatter) against ``jax.grad`` of the reference's
    ``shard_map`` path: every expert leaf, the router, the shared
    experts and the input."""
    ref, port = runs
    r, p = ref["moe"][name], port["moe"][name]
    base.close(p["gx"], r["gx"], 2e-5, f"{name} d/dx")
    for path, g in base.leaves(p["gp"]):
        want = r["gp"]
        for k in path:
            want = want[k]
        base.close(g, want, 2e-5, f"{name} d/d{path}")


@pytest.mark.parametrize("case", SPLITK_CASES, ids=SPLITK_IDS)
def test_split_kv_decode_equals_reference(runs, case):
    ref, port = runs
    r, p = ref["splitk"][case], port["splitk"][case]
    assert p["seq_split"], "the rules must split this ring's sequence"
    base.close(p["y"], r["y"], 2e-5, "split-KV output")
    for k in ("k", "v"):
        base.close(p["new"][k], r["new"][k], 2e-5, f"split-KV cache {k}")


def test_reference_mixtral_decode_1x4_does_not_lower(runs):
    """The reference's fault (jax 0.9.0), and the port's (1, 4) mixtral
    decode (the gather MoE with E over "model", split-KV attention)
    held to the reference's one-device decode."""
    ref, port = runs
    fault = ref["decode"]["fault"]
    assert fault is not None and fault[0] == "ShardingTypeError", fault
    for i, (got, want) in enumerate(zip(port["decode"],
                                        ref["decode"]["logits"])):
        base.close(got, want, 2e-5, f"mixtral (1, 4) decode step {i}")


def test_reference_2d_regime_sums_twice_over_pod(runs):
    """The reference's 2-D regime on a (pod 2, data 1, model 2) mesh
    returns twice the routed experts' output (its ``psum`` over "pod",
    ``moe.py:242-243``, adds two copies; d_e is split over "data" only);
    the port's equals the gather dispatch."""
    ref, port = runs
    r = ref["pod"]
    routed = r["gather"] - r["shared"]
    base.close(r["y"] - r["shared"], 2 * routed, 2e-5, "reference 2-D")
    assert float(np.abs(routed).max()) > 1e-2
    base.close(port["pod"], r["gather"], 2e-5, "port 2-D on the pod mesh")
