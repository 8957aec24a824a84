"""VSlices over several ranks: two tenants space-multiplexed on a (2, 2)
pod mesh of 4 CPU ranks (gloo), each on a (1, 2) slice, against the
reference's VMM on a (2, 2) mesh of 4 forced host devices (its
``test_two_tenants_space_multiplexed`` and
``test_fidelity_same_artifact_on_slice_and_raw_mesh`` at this size).

Every rank runs the same control plane: the VMM, the floorplan, the
pools, the oplog and the program cache. Alice (ranks 0, 1) and bob
(ranks 2, 3) run reduced qwen1.5-0.5b's decode program (ring of 32, B=4)
for 3 steps from the reference's weights (bf16, as the program's
abstract parameters are) and a zero cache, through ``run_async``
futures, under every plane (``hybrid``, ``fev``, ``bev``, ``wfq``,
``slo``); a rank outside a tenant's slice records each op and gets
None. Checked here:

* the slices' ranks are disjoint and match the reference's device ids
  for the same allocation; every rank's floorplan, pool sizes and
  control-plane counters are equal; compile hits and misses equal the
  reference's (1 and 1);
* each tenant's logits are within 5e-2 of the reference tenant's (bf16:
  ``tests/test_kernel_integration.py``'s tolerance), and equal across
  the planes bit for bit (each runs a tenant's ops one at a time, in
  submission order);
* the ``slo`` plane's admission gate decides alike on every rank: with
  alice's pool full her next op is denied on all four, once freed it
  runs;
* a write placed over alice's mesh reads back whole on her ranks, None
  on bob's, and a write placed on bob's mesh is refused;
* fidelity: after both leave, a (2, 2) tenant's prefill program equals
  ``build_step_for_cell`` on a raw (2, 2) mesh bit for bit, with the
  same collectives by kind.
"""
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

ARCH = "qwen1.5-0.5b"
POD, SLICE = (2, 2), (1, 2)
B, CAP, N_DEC, S_PF = 4, 32, 3, 16
POLICIES = ("hybrid", "fev", "bev", "wfq", "slo")
HBM = 1 << 26                     # one rank's memory on the CPU
LOGIT_TOL = 5e-2

REFERENCE = textwrap.dedent('''
    import pickle, sys, tempfile
    import numpy as np, jax
    from repro.configs import get_config
    from repro.core import VMM, ProgramRequest
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model

    out_path, B, CAP, N_DEC, S_PF = sys.argv[1], *map(int, sys.argv[2:])
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = jax.tree.map(np.asarray, build_model(cfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
            for _ in range(N_DEC)]
    prompt = rng.integers(0, cfg.vocab, (B, S_PF)).astype(np.int32)
    vmm = VMM(make_local_mesh((2, 2)), policy="hybrid",
              ckpt_root=tempfile.mkdtemp())
    a = vmm.create_vm("alice", (1, 2))
    b = vmm.create_vm("bob", (1, 2))
    res = {"params": params, "toks": toks, "prompt": prompt,
           "ids": {t.name: [d.id for d in t.vslice.devices.flatten()]
                   for t in (a, b)},
           "fingerprints": {t.name: t.vslice.fingerprint for t in (a, b)},
           "logits": {}}
    req = ProgramRequest("qwen1.5-0.5b", "decode", CAP, B)
    for t in (a, b):
        prog = t.device.reprogram(req)
        abs_p, abs_c = prog.bitfile.abstract_args[:2]
        p = jax.tree.map(lambda x, s: x.astype(s.dtype), params, abs_p)
        caches = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), abs_c)
        res["logits"][t.name] = []
        for pos, tok in enumerate(toks):
            logits, caches = t.device.run(p, caches, tok, np.int32(pos))
            res["logits"][t.name].append(np.asarray(logits, np.float32))
    res["hits"], res["misses"] = vmm.compiler.hits, vmm.compiler.misses
    res["snapshot"] = vmm.floorplanner.snapshot()
    res["util"] = vmm.stats()["floorplan_util"]
    vmm.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
''')


def start_reference(out_path):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={base.N_RANKS}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = base.SRC
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, out_path,
         *map(str, (B, CAP, N_DEC, S_PF))], env=env, cwd=base.ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def agreed(vmm):
    """The control-plane state every rank must hold alike."""
    st = vmm.stats()
    return {"snapshot": vmm.floorplanner.snapshot(),
            "pools": {n: t.pool.n_segments for n, t in vmm.tenants.items()},
            "counters": {k: st[k] for k in (
                "tenants", "floorplan_util", "fragmentation", "compile_hits",
                "compile_misses", "reconfigs", "crc_checks", "crc_failures",
                "violations", "oplog_records")},
            "ops": {op: r["count"] for op, r in st["ops"].items()},
            "sched": {n: {k: s[k] for k in ("submitted", "completed",
                                            "failed")}
                      for n, s in st["scheduler"]["tenants"].items()},
            "steps": {n: t.step for n, t in vmm.tenants.items()}}


def decode_tenant(t, params, toks, cfg):
    """``N_DEC`` decode steps through ``run``/``run_async`` → the whole
    logits (members) or Nones (a rank outside the slice)."""
    from repro_torch.models import Model
    from repro_torch.parallel import partition as part
    prog = t.program.bitfile
    mesh = t.vslice.mesh
    if t.vslice.member:
        p_specs, c_specs, t_spec, _ = prog.compiled.specs
        p = part.distribute(params, p_specs, mesh)
        caches = part.distribute(
            Model(cfg, device="cpu").init_cache(B, CAP), c_specs, mesh)
    else:
        p = caches = t_spec = None
    out = []
    for i, tok in enumerate(toks):
        if t.vslice.member:
            tok = part.distribute({"t": torch.from_numpy(tok)},
                                  {"t": t_spec}, mesh)["t"]
        pos = torch.tensor(i, dtype=torch.int32)
        res = t.device.run(p, caches, tok, pos) if i == 0 else \
            t.device.run_async(p, caches, tok, pos).result(timeout=120)
        if res is None:
            out.append(None)
            continue
        logits, caches = res
        out.append(logits.full_tensor().float())
    return out


def slo_gate(t):
    """Fill ``t``'s pool, submit a read, free, submit it again → each
    submission's outcome on this rank."""
    from repro_torch.core.scheduler import AdmissionPressure
    data = np.arange(8, dtype=np.float32).reshape(1, 8)
    h = t.device.alloc(data.nbytes, data.shape, "float32")
    t.device.write(h, data, sharding=(t.vslice.mesh, (None, "model")))
    big = t.device.alloc(t.pool.free_segments() * t.pool.segment_bytes)
    out = []
    for _ in range(2):
        try:
            got = t.device.read_async(h).result(timeout=120)
            out.append(("ran", None if got is None else got.tolist()))
        except AdmissionPressure:
            out.append(("denied", None))
        if big is not None:
            t.device.free(big)
            big = None
    return out


def rank_main(rank, store, ref_path, out_path, ckpt):
    import torch.distributed as dist

    from repro_torch.bridge import params_from_jax
    from repro_torch.checkpointing.checkpoint import tree_map
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import VMM, ProgramRequest
    from repro_torch.core.mmu import IsolationViolation
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import build_step_for_cell
    from repro_torch.parallel import partition as part
    from repro_torch.parallel.rank_mesh import COUNTS
    base.init_rank(rank, store)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    cfg = get_config(ARCH, reduced=True)
    pod = make_local_mesh(POD, device_type="cpu")
    # the program's abstract parameters are bf16
    bf16 = tree_map(lambda t: t.to(torch.bfloat16)
                    if t.is_floating_point() else t,
                    params_from_jax(ref["params"]))
    res = {"rank": rank, "logits": {}, "agreed": {}}
    req = ProgramRequest(ARCH, "decode", CAP, B)
    for policy in POLICIES:
        vmm = VMM(pod, policy=policy, hbm_per_chip=HBM,
                  ckpt_root=os.path.join(ckpt, policy))
        try:
            a = vmm.create_vm("alice", SLICE)
            b = vmm.create_vm("bob", SLICE)
            res.setdefault("ranks", {t.name: t.vslice.ranks for t in (a, b)})
            res.setdefault("fingerprints", {t.name: t.vslice.fingerprint
                                            for t in (a, b)})
            res.setdefault("members", {t.name: t.vslice.member
                                       for t in (a, b)})
            for t in (a, b):
                t.device.open()
                t.device.reprogram(req)
                res["logits"][(policy, t.name)] = decode_tenant(
                    t, bf16, ref["toks"], cfg)
            res["agreed"][policy] = agreed(vmm)
            if policy == "slo":
                res["slo_gate"] = slo_gate(a)
            if policy != "hybrid":
                continue
            # a write over alice's mesh; one over bob's refused for alice
            data = np.arange(64, dtype=np.float32).reshape(4, 16)
            h = a.device.alloc(data.nbytes, data.shape, "float32")
            a.device.write(h, data, sharding=(a.vslice.mesh,
                                              (None, "model")))
            got = a.device.read(h)
            res["read"] = None if got is None else got.tolist()
            try:
                a.device.write(h, data, sharding=(b.vslice.mesh,
                                                  (None, "model")))
                res["foreign_write"] = "accepted"
            except IsolationViolation:
                res["foreign_write"] = "refused"
            # fidelity: the whole pod as one slice against a raw mesh
            vmm.destroy_vm("alice")
            vmm.destroy_vm("bob")
            c = vmm.create_vm("carol", POD)
            prog = c.device.reprogram(ProgramRequest(ARCH, "prefill", CAP, B))
            cell = ShapeCell("x", CAP, B, "prefill")
            raw, _ = build_step_for_cell(cfg, pod, cell)
            batch = {"tokens": torch.from_numpy(ref["prompt"])}
            runs = {}
            for name, step, mesh in (("slice", prog.bitfile.compiled,
                                      c.vslice.mesh), ("raw", raw, pod)):
                p = part.distribute(bf16, step.specs[0], mesh)
                bt = part.distribute(batch, step.specs[1], mesh)
                COUNTS.clear()
                run = c.device.run if name == "slice" else step
                logits, caches = run(p, bt)
                runs[name] = {"counts": dict(COUNTS),
                              "logits": logits.full_tensor(),
                              "caches": base.full(caches)}
            res["fidelity"] = {
                "counts": (runs["slice"]["counts"], runs["raw"]["counts"]),
                "equal": torch.equal(runs["slice"]["logits"],
                                     runs["raw"]["logits"]) and all(
                    torch.equal(x, y) for (_, x), (_, y) in zip(
                        base.leaves(runs["slice"]["caches"]),
                        base.leaves(runs["raw"]["caches"])))}
            res["carol_ranks"] = c.vslice.ranks
            res["hits_misses"] = (vmm.compiler.hits, vmm.compiler.misses)
        finally:
            vmm.shutdown()
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
        ref_path = os.path.join(tmp, "ref.pkl")
        base.wait(start_reference(ref_path))
        out = os.path.join(tmp, "port.pkl")
        ctx = mp.start_processes(
            rank_main, nprocs=base.N_RANKS, join=False, start_method="spawn",
            args=(tempfile.mktemp(dir=tmp), ref_path, out,
                  os.path.join(tmp, "ckpt")))
        base.join_ranks(ctx)
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        with open(out, "rb") as f:
            return ref, pickle.load(f)


def test_slices_are_disjoint_and_match_the_reference(runs):
    ref, ranks = runs
    r0 = ranks[0]
    assert r0["ranks"] == {"alice": (0, 1), "bob": (2, 3)}
    assert not set(r0["ranks"]["alice"]) & set(r0["ranks"]["bob"])
    assert {n: list(v) for n, v in r0["ranks"].items()} == ref["ids"]
    assert r0["fingerprints"] == ref["fingerprints"]
    for r in ranks:
        assert r["members"] == {"alice": r["rank"] < 2,
                                "bob": r["rank"] >= 2}


@pytest.mark.parametrize("policy", POLICIES)
def test_every_rank_holds_the_same_control_plane(runs, policy):
    _, ranks = runs
    want = ranks[0]["agreed"][policy]
    for r in ranks[1:]:
        assert r["agreed"][policy] == want, r["rank"]
    assert want["counters"]["floorplan_util"] == 1.0
    from repro_torch.core.mmu import SEGMENT_BYTES
    assert want["pools"] == {"alice": 2 * HBM // SEGMENT_BYTES,
                             "bob": 2 * HBM // SEGMENT_BYTES}
    for name in ("alice", "bob"):
        assert want["sched"][name] == {"submitted": N_DEC,
                                       "completed": N_DEC, "failed": 0}
        assert want["steps"][name] == N_DEC


def test_compile_hits_and_misses_equal_the_reference(runs):
    ref, ranks = runs
    for r in ranks:
        for policy in POLICIES:
            c = r["agreed"][policy]["counters"]
            assert (c["compile_hits"], c["compile_misses"]) == \
                (ref["hits"], ref["misses"]) == (1, 1)
        # the fidelity tenant's prefill program: one more miss
        assert r["hits_misses"] == (1, 2)


@pytest.mark.parametrize("tenant", ("alice", "bob"))
def test_tenant_logits_follow_the_reference(runs, tenant):
    ref, ranks = runs
    member = ranks[0 if tenant == "alice" else 2]
    outsider = ranks[2 if tenant == "alice" else 0]
    got = member["logits"][("hybrid", tenant)]
    assert len(got) == N_DEC
    for step, (g, w) in enumerate(zip(got, ref["logits"][tenant])):
        assert tuple(g.shape) == (B, 512)
        base.close(g, w, LOGIT_TOL, f"{tenant} step {step}")
    assert outsider["logits"][("hybrid", tenant)] == [None] * N_DEC


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_planes_run_a_slices_ops_in_order(runs, policy):
    _, ranks = runs
    for r, tenant in ((ranks[0], "alice"), (ranks[2], "bob")):
        for g, w in zip(r["logits"][(policy, tenant)],
                        r["logits"][("hybrid", tenant)]):
            assert torch.equal(g, w), (policy, tenant)


def test_slo_admission_gate_decides_alike_on_every_rank(runs):
    _, ranks = runs
    row = [[0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]]
    for r in ranks:
        assert r["slo_gate"] == [("denied", None),
                                 ("ran", row if r["rank"] < 2 else None)]


def test_sharded_write_reads_back_on_the_slice_only(runs):
    _, ranks = runs
    want = np.arange(64, dtype=np.float32).reshape(4, 16).tolist()
    for r in ranks:
        assert r["read"] == (want if r["rank"] < 2 else None)
        assert r["foreign_write"] == "refused"


def test_whole_pod_tenant_equals_the_raw_mesh_program(runs):
    _, ranks = runs
    for r in ranks:
        assert r["carol_ranks"] == (0, 1, 2, 3)
        assert r["fidelity"]["equal"], r["rank"]
        slice_counts, raw_counts = r["fidelity"]["counts"]
        assert slice_counts == raw_counts and sum(raw_counts.values()) > 0
