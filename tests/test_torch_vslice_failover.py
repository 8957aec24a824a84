"""The reference's ``examples/elastic_failover.py`` on a (2, 2) pod mesh
of 4 CPU ranks (gloo) with (1, 2) slices, against the same sequence of
the reference's VMM on a (2, 2) mesh of 4 forced host devices: reduced
internlm2-1.8b trains 6 steps through a tenant's train program (S=64,
B=4, from the reference's initial weights), its state is checkpointed
and its slice marked failed, ``migrate_tenant(..., shardings_fn=)``
moves it to a fresh (1, 2) slice (first fit gives origin (0, 0) back, as
in the reference), 6 steps, ``elastic.resize`` grows it to the whole
pod (ranks 2 and 3 restore what rank 0 wrote), 6 steps.

Checked: every step's loss within 1e-2 relative of the reference's
(bf16 compute on both sides); the 18 losses equal, bit for bit, an
uninterrupted port run of the same steps on raw meshes of the same
ranks (steps 0-11 on a (1, 2) mesh, 12-17 on the (2, 2) pod, the state
carried over whole); ``compile_hits 1, compile_misses 2`` and the
slices' origins, as the reference's; the ``slice_failed`` IRQ reaches
the tenant's status handler; every rank's control plane agrees.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import pytest
import torch

import test_torch_sharded_steps as base

ARCH = "internlm2-1.8b"
POD, SLICE = (2, 2), (1, 2)
S, B, PHASE = 64, 4, 6
HBM = 1 << 26
REL_TOL = 1e-2

REFERENCE = textwrap.dedent('''
    import pickle, sys, tempfile
    import numpy as np, jax, jax.numpy as jnp
    from repro import optim
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.core import VMM, ProgramRequest, elastic
    from repro.data import pipeline_for
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model

    out_path, S, B, PHASE = sys.argv[1], *map(int, sys.argv[2:])
    ARCH = "internlm2-1.8b"
    vmm = VMM(make_local_mesh((2, 2)), policy="hybrid",
              ckpt_root=tempfile.mkdtemp())
    tenant = vmm.create_vm("trainer", (1, 2))
    tenant.device.open()
    cfg = get_config(ARCH, reduced=True)
    pipe = pipeline_for(cfg, ShapeCell("ef", S, B, "train"))
    oc = optim.OptConfig(warmup_steps=2, decay_steps=30)
    tenant.device.reprogram(ProgramRequest(ARCH, "train", S, B))
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    res = {"params": jax.tree.map(np.asarray, params), "losses": [],
           "origins": [tenant.vslice.spec.origin]}
    opt_state = optim.init(oc, params)

    def steps(first, params, opt_state):
        for step in range(first, first + PHASE):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch(step).items()}
            params, opt_state, m = tenant.device.run(params, opt_state,
                                                     batch)
            res["losses"].append(float(m["loss"]))
        return params, opt_state
    params, opt_state = steps(0, params, opt_state)
    tenant.state = {"params": params, "opt": opt_state}
    vmm.checkpoint_tenant(tenant)
    vmm.mark_slice_failed(tenant.vslice.slice_id)
    template = {"params": jax.tree.map(jnp.zeros_like, params),
                "opt": jax.tree.map(jnp.zeros_like, opt_state)}
    vmm.migrate_tenant(tenant, new_shape=(1, 2), state_template=template)
    res["origins"].append(tenant.vslice.spec.origin)
    params, opt_state = steps(PHASE, tenant.state["params"],
                              tenant.state["opt"])
    tenant.state = {"params": params, "opt": opt_state}
    elastic.resize(vmm, tenant, (2, 2), state_template=template)
    res["origins"].append(tenant.vslice.spec.origin)
    steps(2 * PHASE, tenant.state["params"], tenant.state["opt"])
    res["hits"], res["misses"] = vmm.compiler.hits, vmm.compiler.misses
    vmm.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
''')


def run_steps(run, specs, mesh, params, opt_state, pipe, first, losses):
    """``PHASE`` train steps from ``first`` through ``run`` → (params, opt
    state); a rank outside ``mesh`` passes None and gets None back."""
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.parallel import partition as part
    member = mesh.get_coordinate() is not None
    for step in range(first, first + PHASE):
        batch = part.distribute(batch_from_numpy(pipe.batch(step)),
                                specs[2], mesh) if member else None
        out = run(params, opt_state, batch)
        if out is None:
            losses.append(None)
            continue
        params, opt_state, m = out
        losses.append(float(m["loss"]))
    return params, opt_state


def rank_main(rank, store, ref_path, out_path, ckpt):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import optim
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import VMM, ProgramRequest, elastic
    from repro_torch.data import pipeline_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import abstract_params, build_train
    from repro_torch.parallel import partition as part
    from repro_torch.models import Model
    base.init_rank(rank, store)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    cfg = get_config(ARCH, reduced=True)
    pod = make_local_mesh(POD, device_type="cpu")
    pipe = pipeline_for(cfg, ShapeCell("ef", S, B, "train"))
    oc = optim.OptConfig(state_dtype=cfg.opt_dtype)
    params = params_from_jax(ref["params"])
    aparams = abstract_params(Model(cfg, device="meta"))
    template = {"params": aparams, "opt": optim.init(oc, aparams)}

    def placed(vs):
        """The state's placements on ``vs``'s mesh (``shardings_fn``)."""
        p_specs = part.param_specs(cfg, aparams, vs.mesh)
        return {"params": part.shardings(p_specs, vs.mesh),
                "opt": part.shardings(part.opt_specs(cfg, p_specs),
                                      vs.mesh)}

    def start(specs, mesh):
        if mesh.get_coordinate() is None:
            return None, None
        # the step consumes its inputs, and a replicated leaf of
        # ``distribute`` is the tensor itself: each start copies
        return (part.distribute(base.steps_copy(params), specs[0], mesh),
                part.distribute(optim.init(oc, params), specs[1], mesh))

    vmm = VMM(pod, policy="hybrid", hbm_per_chip=HBM, ckpt_root=ckpt)
    res = {"rank": rank, "losses": [], "origins": []}
    try:
        t = vmm.create_vm("trainer", SLICE)
        t.device.open()
        events = []
        t.device.set_status(lambda ev: events.append(ev.kind))
        prog = t.device.reprogram(ProgramRequest(ARCH, "train", S, B))
        res["origins"].append(t.vslice.spec.origin)
        p, o = start(prog.bitfile.compiled.specs if t.vslice.member
                     else None, t.vslice.mesh)

        def phase(first):
            specs = t.program.bitfile.compiled.specs \
                if t.vslice.member else None
            return run_steps(t.device.run, specs, t.vslice.mesh,
                             t.state.pop("params"), t.state.pop("opt"),
                             pipe, first, res["losses"])
        t.state = {"params": p, "opt": o}
        p, o = phase(0)
        t.state = {"params": p, "opt": o}
        del p, o
        vmm.checkpoint_tenant(t)
        vmm.mark_slice_failed(t.vslice.slice_id)
        vmm.migrate_tenant(t, new_shape=SLICE, state_template=template,
                           shardings_fn=placed)
        res["origins"].append(t.vslice.spec.origin)
        t.state = dict(zip(("params", "opt"), phase(PHASE)))
        elastic.resize(vmm, t, POD, state_template=template,
                       shardings_fn=placed)
        res["origins"].append(t.vslice.spec.origin)
        phase(2 * PHASE)
        st = vmm.stats()
        res["events"] = events
        res["counts"] = (st["compile_hits"], st["compile_misses"],
                         st["reconfigs"], st["oplog_records"], t.step,
                         vmm.floorplanner.snapshot())
    finally:
        vmm.shutdown()

    # uninterrupted: the same steps on raw meshes of the same ranks
    first = DeviceMesh("cpu", torch.tensor([[0, 1]]),
                       mesh_dim_names=("data", "model"))
    cell = ShapeCell("ef", S, B, "train")
    run, _ = build_train(cfg, first, cell) if rank < 2 else (None, None)
    p, o = start(run.specs, first) if rank < 2 else (None, None)
    want = []
    if rank < 2:
        p, o = run_steps(run, run.specs, first, p, o, pipe, 0, want)
        p, o = run_steps(run, run.specs, first, p, o, pipe, PHASE, want)
        whole = [base.full(p), base.full(o)]
    else:
        whole = [None, None]
    dist.broadcast_object_list(whole, src=0)
    run, _ = build_train(cfg, pod, cell)
    p = part.distribute(whole[0], run.specs[0], pod)
    o = part.distribute(whole[1], run.specs[1], pod)
    run_steps(run, run.specs, pod, p, o, pipe, 2 * PHASE, want)
    res["uninterrupted"] = want
    per_rank = [None] * base.N_RANKS
    dist.all_gather_object(per_rank, res)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(per_rank, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=base.SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count="
                             f"{base.N_RANKS}")
        ref_path = os.path.join(tmp, "ref.pkl")
        base.wait(subprocess.Popen(
            [sys.executable, "-c", REFERENCE, ref_path, str(S), str(B),
             str(PHASE)], env=env, cwd=base.ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        out = os.path.join(tmp, "port.pkl")
        ctx = mp.start_processes(
            rank_main, nprocs=base.N_RANKS, join=False, start_method="spawn",
            args=(tempfile.mktemp(dir=tmp), ref_path, out,
                  os.path.join(tmp, "ckpt")))
        base.join_ranks(ctx)
        with open(ref_path, "rb") as f, open(out, "rb") as g:
            return pickle.load(f), pickle.load(g)


def test_losses_follow_the_reference(runs):
    ref, ranks = runs
    got = ranks[0]["losses"]
    assert len(got) == len(ref["losses"]) == 3 * PHASE
    for step, (g, w) in enumerate(zip(got, ref["losses"])):
        assert g == pytest.approx(w, rel=REL_TOL), (step, g, w)


def test_losses_equal_an_uninterrupted_run_bit_for_bit(runs):
    _, ranks = runs
    for r in ranks:
        members = [r["rank"] < 2] * 2 * PHASE + [True] * PHASE
        want = [x if m else None for x, m in
                zip(ranks[0]["uninterrupted"], members)]
        assert r["losses"] == want, r["rank"]
        # ranks 2 and 3 join the uninterrupted run at the (2, 2) steps
        assert r["uninterrupted"] == ranks[0]["uninterrupted"][
            0 if r["rank"] < 2 else 2 * PHASE:]


def test_counts_and_slices_follow_the_reference(runs):
    ref, ranks = runs
    for r in ranks:
        hits, misses, *_ = r["counts"]
        assert (hits, misses) == (ref["hits"], ref["misses"]) == (1, 2)
        assert r["origins"] == ref["origins"] == [(0, 0), (0, 0), (0, 0)]
        assert r["counts"] == ranks[0]["counts"]
        assert "slice_failed" in r["events"]
