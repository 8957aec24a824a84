"""The mesh step builders on 4 CPU ranks (gloo) against the reference's
sharded steps and the port's one-device steps: reduced qwen1.5-0.5b in
fp32 on (2, 2) and (1, 4) ("data", "model") meshes (the recurrent
families: ``test_torch_sharded_steps_{recurrentgemma,rwkv}.py``, which
share this file's harness).

Reference subprocesses (one a mesh, 4 forced host devices, as
``tests/test_integration.py`` runs them) makes the parameters, the
prompt, the decode tokens and the train batches from seeds, and runs
``repro.parallel.steps.build_step_for_cell`` on each mesh, lowered and
compiled ahead of time from fp32 abstract args: a prefill of S=12 into
rings of 16 slots, 6 decode steps from its caches (positions 12-17:
the ring wraps), 2 train steps at S=16. One
spawn of 4 ranks runs the port's mesh builders on the same inputs
(carried over by the bridge and placed by ``partition.distribute``) and
records each rank's parameter bytes and the collectives by kind.

Tolerances, on |Δ| / (1 + |want|) (absolute below 1, relative above: the
WKV state reaches ~20): the sharded steps equal the reference's within
2e-5 and the port's one-device steps within 1e-5 (logits, caches,
losses, gradient norms, AdamW's m and v); parameters after the 2 train
steps within that plus 2·(lr₁ + lr₂), since AdamW's first updates are
±lr wherever a gradient is near zero (``tests/test_torch_train.py``).
Besides, per leaf by relative norm, m and v within 1e-3 and the update
over the 2 steps within 1e-2 (:func:`check_train`).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
MESHES = ((2, 2), (1, 4))
B, S, CAP, S_TRAIN, N_DEC, N_TRAIN = 4, 12, 16, 16, 6, 2
N_RANKS = 4
#: per leaf, by relative norm: AdamW's m and v against the other run's.
#: Rounding alone moves some leaves by ~1e-4: reduced rwkv6's
#: ``bonus_u`` gradient moves by 1.1e-4 to 1.8e-4 when every parameter
#: moves by 1e-7 (one device, fp32), as the mesh's other product
#: blockings move it (measured: m within 4.9e-5, v within 1.9e-5)
REL_TOL = 1e-3
#: per leaf, by relative norm: the update over the train steps. AdamW's
#: first updates are ±lr wherever a gradient is near rounding, so a few
#: elements may go either way (measured: within 1.2e-3, rwkv6's
#: ``mix_B``); a skipped update is off by 1, one of the wrong sign by 2
UPDATE_TOL = 1e-2

REFERENCE = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np, jax
    from repro import optim
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.parallel.steps import build_step_for_cell

    arch, inp, out, meshes, sharding, B, S, CAP, S_TRAIN, N_DEC, N_TRAIN = (
        sys.argv[1], sys.argv[2], sys.argv[3], eval(sys.argv[4]),
        eval(sys.argv[5]), *map(int, sys.argv[6:]))
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              sharding=dataclasses.replace(cfg.sharding,
                                                           **sharding))
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    if not meshes:                  # the inputs, made from seeds
        params = to_np(build_model(cfg).init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        ints = lambda *shape: rng.integers(0, cfg.vocab, shape).astype(
            np.int32)
        inputs = {"params": params, "tokens": ints(B, S),
                  "dec_tokens": [ints(B, 1) for _ in range(N_DEC)],
                  "train": [{"tokens": ints(B, S_TRAIN),
                             "labels": ints(B, S_TRAIN),
                             "mask": (rng.random((B, S_TRAIN)) > 0.2
                                      ).astype(np.float32)}
                            for _ in range(N_TRAIN)]}
        with open(inp, "wb") as f:
            pickle.dump(inputs, f)
        sys.exit(0)
    with open(inp, "rb") as f:
        inputs = pickle.load(f)
    params = inputs["params"]
    sds = lambda t: jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype), t)

    def compiled(jitted, *args):
        return jitted.lower(*sds(args)).compile()

    def counts(comp):
        txt = comp.as_text()
        return {k: txt.count(k + "(") for k in
                ("all-reduce", "all-gather", "all-to-all")}

    runs = {}
    for shape in meshes:
        mesh = make_local_mesh(shape)
        r = {}
        pf, _ = build_step_for_cell(cfg, mesh,
                                    ShapeCell("p", CAP, B, "prefill"))
        comp = compiled(pf, params, {"tokens": inputs["tokens"]})
        logits, caches = comp(params, {"tokens": inputs["tokens"]})
        r["prefill_hlo"] = counts(comp)
        r["prefill_logits"], caches = to_np(logits), to_np(caches)
        r["prefill_caches"] = caches
        dec, _ = build_step_for_cell(cfg, mesh,
                                     ShapeCell("d", CAP, B, "decode"))
        comp, r["decode_logits"] = None, []
        for i, tok in enumerate(inputs["dec_tokens"]):
            pos = np.int32(S + i)
            comp = comp or compiled(dec, params, caches, tok, pos)
            logits, caches = comp(params, caches, tok, pos)
            r["decode_logits"].append(to_np(logits))
            caches = to_np(caches)
        r["decode_hlo"], r["decode_caches"] = counts(comp), caches
        tr, _ = build_step_for_cell(cfg, mesh,
                                    ShapeCell("t", S_TRAIN, B, "train"))
        p = params
        o = to_np(optim.init(optim.OptConfig(state_dtype=cfg.opt_dtype), p))
        comp, r["losses"], r["gnorms"] = None, [], []
        for bt in inputs["train"]:
            comp = comp or compiled(tr, p, o, bt)
            p, o, met = comp(p, o, bt)
            p, o = to_np(p), to_np(o)
            r["losses"].append(float(met["loss"]))
            r["gnorms"].append(float(met["grad_norm"]))
        r["params"], r["opt"] = p, o
        runs[shape] = r
    with open(out, "wb") as f:
        pickle.dump(runs, f)
''')


def start_reference(arch, inp, out, meshes=MESHES, sharding=None):
    """The reference on ``meshes`` (none: write the inputs to ``inp``),
    its ``ShardingProfile`` with ``sharding``'s fields."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_RANKS}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    args = [str(v) for v in (B, S, CAP, S_TRAIN, N_DEC, N_TRAIN)]
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, arch, inp, out, repr(tuple(meshes)),
         repr(sharding or {}), *args], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def wait(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"subprocess failed:\n{out}\n{err[-4000:]}")


def cfg_of(arch, sharding=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=True)
    return dataclasses.replace(cfg, compute_dtype="float32",
                               sharding=dataclasses.replace(
                                   cfg.sharding, **(sharding or {})))


def init_rank(rank, store):
    """One gloo rank of ``N_RANKS`` over a ``file://`` store (no ports)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=N_RANKS)


def full(tree):
    """DTensor leaves → full CPU tensors (test-side gathers)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [full(v) for v in tree]
    return tree.full_tensor().clone() if isinstance(tree, DTensor) \
        else tree


def rank_main(rank, store, arch, inp_path, out_path, meshes=MESHES,
              sharding=None):
    """The port's mesh builders on one rank: prefill, decode from its
    caches, train; rank 0 writes the gathered results."""
    import torch.distributed as dist

    from repro_torch.bridge import batch_from_numpy, params_from_jax
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import steps
    from repro_torch.parallel.rank_mesh import COUNTS
    init_rank(rank, store)
    with open(inp_path, "rb") as f:
        inputs = pickle.load(f)
    cfg = cfg_of(arch, sharding)
    params = params_from_jax(inputs["params"])
    runs = {}
    for shape in meshes:
        mesh = make_local_mesh(shape, device_type="cpu")
        r = {}
        pf, _ = steps.build_prefill(cfg, mesh,
                                    ShapeCell("p", CAP, B, "prefill"))
        dp = part.distribute(params, pf.specs[0], mesh)
        r["bytes"] = (part.local_bytes(dp),
                      part.share_bytes(params, pf.specs[0], mesh))
        batch = part.distribute(
            batch_from_numpy({"tokens": inputs["tokens"]}), pf.specs[1],
            mesh)
        COUNTS.clear()
        logits, caches = pf(dp, batch)
        r["prefill_counts"] = dict(COUNTS)
        r["prefill_logits"] = full(logits)
        r["prefill_caches"] = full(caches)
        dec, _ = steps.build_decode(cfg, mesh,
                                    ShapeCell("d", CAP, B, "decode"))
        COUNTS.clear()
        r["decode_logits"] = []
        for i, tok in enumerate(inputs["dec_tokens"]):
            tok = part.distribute({"t": torch.from_numpy(tok)},
                                  {"t": dec.specs[2]}, mesh)["t"]
            logits, caches = dec(dp, caches, tok,
                                 torch.tensor(S + i, dtype=torch.int32))
            r["decode_logits"].append(full(logits))
        r["decode_counts"] = dict(COUNTS)
        r["decode_caches"] = full(caches)
        tr, _ = steps.build_train(cfg, mesh,
                                  ShapeCell("t", S_TRAIN, B, "train"))
        from repro_torch import optim
        p = part.distribute(params, tr.specs[0], mesh)
        o = part.distribute(
            optim.init(optim.OptConfig(state_dtype=cfg.opt_dtype), params),
            tr.specs[1], mesh)
        r["losses"], r["gnorms"] = [], []
        for bt in inputs["train"]:
            p, o, met = tr(p, o, part.distribute(batch_from_numpy(bt),
                                                 tr.specs[2], mesh))
            r["losses"].append(float(met["loss"]))
            r["gnorms"].append(float(met["grad_norm"]))
        r["params"], r["opt"] = full(p), full(o)
        r["train_bytes"] = (part.local_bytes(p),
                            part.share_bytes(params, tr.specs[0], mesh))
        per_rank = [None] * N_RANKS
        dist.all_gather_object(per_rank, (r.pop("bytes"),
                                          r.pop("train_bytes")))
        r["bytes"] = per_rank
        runs[shape] = r
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(runs, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(arch, inp_path, out_path, meshes=MESHES, sharding=None):
    """Start ``N_RANKS`` spawned ranks (returns their context)."""
    import torch.multiprocessing as mp
    store = tempfile.mktemp(dir=os.path.dirname(out_path))
    return mp.start_processes(rank_main, nprocs=N_RANKS, join=False,
                              start_method="spawn",
                              args=(store, arch, inp_path, out_path, meshes,
                                    sharding))


def join_ranks(ctx, timeout=300):
    import time
    end = time.time() + timeout
    while not ctx.join(timeout=max(1.0, end - time.time())):
        if time.time() > end:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("ranks did not finish in time")


def one_device(arch, inputs, sharding=None):
    """The port's one-device builders on the same inputs."""
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy, params_from_jax
    from repro_torch.configs.base import ShapeCell
    from repro_torch.parallel import steps
    cfg = cfg_of(arch, sharding)
    cpu = torch.device("cpu")
    params = params_from_jax(inputs["params"])
    pf, _ = steps.build_prefill(cfg, cpu, ShapeCell("p", CAP, B, "prefill"))
    logits, caches = pf(params, batch_from_numpy(
        {"tokens": inputs["tokens"]}))
    r = {"prefill_logits": logits,
         "prefill_caches": steps_copy(caches), "decode_logits": []}
    dec, _ = steps.build_decode(cfg, cpu, ShapeCell("d", CAP, B, "decode"))
    for i, tok in enumerate(inputs["dec_tokens"]):
        logits, caches = dec(params, caches, torch.from_numpy(tok),
                             torch.tensor(S + i, dtype=torch.int32))
        r["decode_logits"].append(logits)
    r["decode_caches"] = caches
    tr, _ = steps.build_train(cfg, cpu, ShapeCell("t", S_TRAIN, B, "train"))
    p = params
    o = optim.init(optim.OptConfig(state_dtype=cfg.opt_dtype), p)
    r["losses"], r["gnorms"] = [], []
    for bt in inputs["train"]:
        p, o, met = tr(p, o, batch_from_numpy(bt))
        r["losses"].append(float(met["loss"]))
        r["gnorms"].append(float(met["grad_norm"]))
    r["params"], r["opt"] = p, o
    return r


def steps_copy(tree):
    """A copy of a cache tree (decode updates caches in place)."""
    if isinstance(tree, dict):
        return {k: steps_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [steps_copy(v) for v in tree]
    return tree.clone()


def run_all(archs, tmp, meshes=MESHES, sharding=None):
    """Every arch's reference subprocess and rank spawn, in parallel, the
    configs' ``ShardingProfile`` with ``sharding``'s fields → {arch:
    {"inputs", "ref": {mesh: run}, "port": {mesh: run}, "one": run}}."""
    def path(what, a, m=None):
        tag = f"-{m[0]}x{m[1]}" if m else ""
        return os.path.join(tmp, f"{what}-{a}{tag}.pkl")
    for proc in [start_reference(a, path("inputs", a), "-", ())
                 for a in archs]:
        wait(proc)
    # one reference process a mesh, beside the ranks
    refs = [start_reference(a, path("inputs", a), path("ref", a, m), (m,),
                            sharding) for a in archs for m in meshes]
    ctxs = {a: spawn_ranks(a, path("inputs", a), path("port", a), meshes,
                           sharding) for a in archs}
    out = {}
    for a in archs:
        with open(path("inputs", a), "rb") as f:
            inputs = pickle.load(f)
        out[a] = {"inputs": inputs, "one": one_device(a, inputs, sharding),
                  "start": ref_params(inputs["params"]), "ref": {}}
    for proc in refs:
        wait(proc)
    for a in archs:
        for m in meshes:
            with open(path("ref", a, m), "rb") as f:
                out[a]["ref"].update(pickle.load(f))
    for a in archs:
        join_ranks(ctxs[a])
        with open(path("port", a), "rb") as f:
            out[a]["port"] = pickle.load(f)
    return out


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def close(got, want, tol, what):
    got = np.asarray(got.detach().float().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach().float().numpy()
                      if isinstance(want, torch.Tensor) else want,
                      np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want) / (1.0 + np.abs(want)))) \
        if got.size else 0.0
    assert err <= tol, f"{what}: max |Δ| / (1 + |want|) {err:.3g} > {tol}"


def leaves(tree, prefix=()):
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    return flatten_with_path(tree, prefix)


def close_trees(got, want, tol, what):
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        close(a, b, tol, f"{what} {path}")


def ref_caches(run, key, arch):
    from repro_torch.bridge import caches_from_jax
    return caches_from_jax(run[key], cfg_of(arch))


def ref_params(tree):
    from repro_torch.bridge import params_from_jax
    return params_from_jax(tree)


def lr_bound():
    """2·(lr₁ + lr₂): AdamW's first updates near a zero gradient."""
    from repro_torch import optim
    opt = optim.OptConfig()
    return 2 * sum(float(optim.schedule(opt, torch.tensor(i + 1)))
                   for i in range(N_TRAIN))


def rel_err(got, want):
    """||got - want|| / ||want|| in fp64 (inf for a nonzero error
    against zero, 0 for two zeros)."""
    g, w = (t.detach().double() for t in (got, want))
    d, n = float((g - w).norm()), float(w.norm())
    return d / n if n else (float("inf") if d else 0.0)


def check_prefill(r, want, arch, tol, from_ref):
    close(r["prefill_logits"], want["prefill_logits"], tol,
          "prefill logits")
    w = ref_caches(want, "prefill_caches", arch) if from_ref \
        else want["prefill_caches"]
    close_trees(r["prefill_caches"], w, tol, "prefill caches")


def check_decode(r, want, arch, tol, from_ref):
    for i, (a, b) in enumerate(zip(r["decode_logits"],
                                   want["decode_logits"])):
        close(a, b, tol, f"decode {i} logits")
    w = ref_caches(want, "decode_caches", arch) if from_ref \
        else want["decode_caches"]
    close_trees(r["decode_caches"], w, tol, "decode caches")


def check_train(r, want, start, tol, from_ref):
    """Losses, gradient norms, AdamW's m and v elementwise within
    ``tol`` and the parameters within ``tol`` + :func:`lr_bound` (AdamW's
    first updates are ±lr wherever a gradient is near zero); then, per
    leaf by relative norm, m, v and the update (the
    parameters after the steps less ``start``) within :data:`REL_TOL`
    and :data:`UPDATE_TOL`, so that an update skipped (off by 1), of the
    wrong sign (by 2) or mis-scaled fails. A leaf whose reference m is
    zero to rounding (its norm at most 1e-6 of the largest leaf's) has
    no direction to compare and is held to the elementwise checks
    only."""
    from repro_torch.bridge import opt_state_from_jax
    close(r["losses"], want["losses"], tol, "train losses")
    close(r["gnorms"], want["gnorms"], tol, "grad norms")
    wp = ref_params(want["params"]) if from_ref else want["params"]
    wo = opt_state_from_jax(want["opt"]) if from_ref else want["opt"]
    close_trees(r["opt"]["m"], wo["m"], tol, "AdamW m")
    close_trees(r["opt"]["v"], wo["v"], tol, "AdamW v")
    close_trees(r["params"], wp, tol + lr_bound(), "params after training")
    want_m = leaves(wo["m"])
    scale = max(float(m.double().norm()) for _, m in want_m)
    worst = {}
    for (path, p), (_, w), (_, a), (_, m), (_, wm), (_, v), (_, wv) in zip(
            leaves(r["params"]), leaves(wp), leaves(start),
            leaves(r["opt"]["m"]), want_m, leaves(r["opt"]["v"]),
            leaves(wo["v"])):
        if float(wm.double().norm()) <= 1e-6 * scale:
            continue
        for what, err, bound in (
                ("m", rel_err(m, wm), REL_TOL), ("v", rel_err(v, wv), REL_TOL),
                ("update", rel_err(p.double() - a.double(),
                                   w.double() - a.double()), UPDATE_TOL)):
            worst[what] = max(worst.get(what, 0.0), err)
            assert err <= bound, f"{path}: {what} off by {err:.3g} > {bound}"
    print(f"train: the worst relative error of a leaf {worst}")


def check_bytes(r, mesh):
    """Each rank holds its blocks only, before and after a train step."""
    whole = sum(t.numel() * t.element_size() for _, t in
                leaves(r["one"]["params"]))
    for rank, (serve, train) in enumerate(r["port"][mesh]["bytes"]):
        assert serve[0] == serve[1], (rank, serve)
        assert train[0] == train[1], (rank, train)
        assert serve[0] < whole, (rank, serve, whole)


ARCHS = ("qwen1.5-0.5b",)
CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(ARCHS, str(tmp_path_factory.mktemp("sharded")))


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_prefill_equals_reference(runs, arch, mesh):
    check_prefill(runs[arch]["port"][mesh], runs[arch]["ref"][mesh], arch,
                  2e-5, True)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_prefill_equals_one_device(runs, arch, mesh):
    check_prefill(runs[arch]["port"][mesh], runs[arch]["one"], arch, 1e-5,
                  False)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_decode_equals_reference(runs, arch, mesh):
    check_decode(runs[arch]["port"][mesh], runs[arch]["ref"][mesh], arch,
                 2e-5, True)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_decode_equals_one_device(runs, arch, mesh):
    check_decode(runs[arch]["port"][mesh], runs[arch]["one"], arch, 1e-5,
                 False)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_train_equals_reference(runs, arch, mesh):
    check_train(runs[arch]["port"][mesh], runs[arch]["ref"][mesh],
                runs[arch]["start"], 2e-5, True)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_train_equals_one_device(runs, arch, mesh):
    check_train(runs[arch]["port"][mesh], runs[arch]["one"],
                runs[arch]["start"], 1e-5, False)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_resident_parameter_bytes_are_the_rules_share(runs, arch, mesh):
    check_bytes(runs[arch], mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{m[0]}x{m[1]}"
                                              for m in MESHES])
@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_qwen_serving_steps_issue_no_all_gather(runs, kind, mesh):
    """As the reference's compiled HLO shows: heads, FFN columns and the
    vocab split over "model" leave nothing to gather."""
    r = runs["qwen1.5-0.5b"]
    hlo = r["ref"][mesh][f"{kind}_hlo"]
    counts = r["port"][mesh][f"{kind}_counts"]
    steps = N_DEC if kind == "decode" else 1
    print(f"qwen {kind} {mesh}: the port's collectives {counts} over "
          f"{steps} step(s); the reference's compiled HLO {hlo}")
    assert hlo["all-gather"] == 0
    assert counts.get("all_gather", 0) == 0, counts
    assert counts.get("all_reduce", 0) > 0, counts
