"""Live migration and the elastic grow of sharded tenant state on a
(2, 2) pod mesh of 4 CPU ranks (gloo), against the reference's VMM on 4
forced host devices (its ``test_live_migration_restores_sharded_state``
at this size), and the Autoscaler in lockstep over the ranks.

* Alice (a (1, 2) slice, ranks 0 and 1) holds a (4, 16) leaf placed
  ``(None, "model")`` at step 5 and reduced qwen1.5-0.5b's decode
  program. ``migrate_tenant(..., shardings_fn=)`` moves her to a fresh
  (1, 2) slice (a new slice id; first fit gives her rectangle back, as
  in the reference); then bob leaves and she grows to the whole (2, 2)
  pod: ranks 2 and 3 restore a checkpoint that rank 0 wrote. The leaf
  comes back exact, each rank's block has the reference's shard shape,
  the step stays 5, each checkpoint is written by one rank, and the
  slices, fingerprints and compile hits and misses are the reference's.
* The paper's cross-slice attack is refused on every rank: bob loading
  alice's bitfile, and a forged one that carries bob's binding but a
  step built for alice's mesh.
* The Autoscaler: only rank 0 sees ``queue_buildup`` IRQs, yet at
  ``poll()`` every rank grows the tenant alike (rank 0 decides and
  broadcasts), restoring its placed state on the grown slice (rank 1
  reads what rank 0 wrote, in the one temporary directory a pod VMM
  without ``ckpt_root`` shares); a calm period shrinks it back on every
  rank; a resize that raises, raises on every rank (none records it);
  ``start()`` and ``swap_cb`` are refused on a multi-rank pod.
* ``poll()`` while the tenant's decode ops are queued on the ``fev``
  plane's worker (behind an op that holds it until after the poll has
  begun): the grow's checkpoint first waits for them on every rank, so
  each op runs on the old slice and its logits equal the same op's run
  alone, bit for bit; then the state is restored on the grown slice.
* ``defragment`` moves a (1, 2) slice from ranks (2, 3) to (0, 1) and
  re-binds its program to the new slice's mesh, alike on every rank.
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

POD, SLICE = (2, 2), (1, 2)
HBM = 1 << 26
STEP = 5
ARCH, CAP, B = "qwen1.5-0.5b", 16, 4
N_IN_FLIGHT = 4

REFERENCE = textwrap.dedent('''
    import pickle, sys, tempfile
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import VMM, ProgramRequest
    from repro.launch.mesh import make_local_mesh

    out_path, CAP, B = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    vmm = VMM(make_local_mesh((2, 2)), ckpt_root=tempfile.mkdtemp())
    a = vmm.create_vm("alice", (1, 2))
    b = vmm.create_vm("bob", (1, 2))
    a.device.reprogram(ProgramRequest("qwen1.5-0.5b", "decode", CAP, B))
    a.state = {"w": jax.device_put(np.arange(64.).reshape(4, 16),
                                   NamedSharding(a.vslice.mesh,
                                                 P(None, "model")))}
    a.step = 5

    def shardings_fn(vs):
        return {"w": NamedSharding(vs.mesh, P(None, "model"))}

    def where(t):
        w = t.state["w"]
        return {"slice": t.vslice.slice_id, "origin": t.vslice.spec.origin,
                "shape": t.vslice.spec.shape,
                "ids": [d.id for d in t.vslice.devices.flatten()],
                "fingerprint": t.vslice.fingerprint, "step": t.step,
                "w": np.asarray(jax.device_get(w)),
                "blocks": {s.device.id: tuple(s.data.shape)
                           for s in w.addressable_shards}}
    res = {"start": where(a)}
    template = {"w": jnp.zeros((4, 16))}
    vmm.migrate_tenant(a, new_shape=(1, 2), state_template=template,
                       shardings_fn=shardings_fn)
    res["migrated"] = where(a)
    vmm.destroy_vm("bob")
    vmm.migrate_tenant(a, new_shape=(2, 2), state_template=template,
                       shardings_fn=shardings_fn)
    res["grown"] = where(a)
    res["hits"], res["misses"] = vmm.compiler.hits, vmm.compiler.misses
    res["snapshot"] = vmm.floorplanner.snapshot()
    vmm.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
''')


def where(t):
    """A tenant's slice and this rank's view of its placed leaf."""
    from repro_torch.checkpointing.checkpoint import writes
    w = t.state["w"]
    return {"slice": t.vslice.slice_id, "origin": t.vslice.spec.origin,
            "shape": t.vslice.spec.shape, "ids": list(t.vslice.ranks),
            "fingerprint": t.vslice.fingerprint, "step": t.step,
            "member": t.vslice.member,
            "block": None if w is None else tuple(w.to_local().shape),
            "w": None if w is None else w.full_tensor().numpy(),
            "writes": w is not None and writes(t.state)}


def migration(pod, tmp, rank):
    from repro_torch.core import VMM, ProgramRequest
    from repro_torch.core.reconfig import Bitfile, LegalityError
    from repro_torch.parallel import partition as part
    vmm = VMM(pod, policy="hybrid", hbm_per_chip=HBM,
              ckpt_root=os.path.join(tmp, "migration"))
    try:
        a = vmm.create_vm("alice", SLICE)
        b = vmm.create_vm("bob", SLICE)
        a.device.reprogram(ProgramRequest(ARCH, "decode", CAP, B))
        data = torch.arange(64.).reshape(4, 16)
        a.state = {"w": part.distribute({"w": data},
                                        {"w": (None, "model")},
                                        a.vslice.mesh)["w"]
                   if a.vslice.member else None}
        a.step = STEP

        def shardings_fn(vs):
            return {"w": (vs.mesh, (None, "model"))}
        res = {"start": where(a)}
        template = {"w": torch.zeros((4, 16))}
        vmm.migrate_tenant(a, new_shape=SLICE, state_template=template,
                           shardings_fn=shardings_fn)
        res["migrated"] = where(a)
        refusals = []
        try:
            b.device.reprogram(a.program.bitfile)
        except LegalityError as e:
            refusals.append(str(e))
        bf = a.program.bitfile
        forged = Bitfile(bf.program_key, bf.topology_key,
                         b.vslice.fingerprint, bf.compiled, None)
        try:
            b.device.reprogram(forged)
        except LegalityError as e:
            refusals.append(str(e))
        res["refusals"] = refusals
        res["violations"] = vmm.auditor.summary()
        vmm.destroy_vm("bob")
        vmm.migrate_tenant(a, new_shape=POD, state_template=template,
                           shardings_fn=shardings_fn)
        res["grown"] = where(a)
        res["grown_program_mesh"] = a.program.bitfile.compiled.mesh is \
            a.vslice.mesh
        res["hits"], res["misses"] = vmm.compiler.hits, vmm.compiler.misses
        res["snapshot"] = vmm.floorplanner.snapshot()
        res["manifests"] = sorted(
            os.path.relpath(os.path.join(d, f), tmp)
            for d, _, files in os.walk(os.path.join(tmp, "migration"))
            for f in files if f == "manifest.json")
        return res
    finally:
        vmm.shutdown()


def autoscaling(pod, tmp, rank):
    from repro_torch.core import VMM, Autoscaler
    from repro_torch.core.scheduler import IRQ_DEGRADED
    from repro_torch.parallel import partition as part
    clock = [100.0]
    # no ckpt_root: rank 0 makes one temporary directory for every rank
    vmm = VMM(pod, policy="hybrid", hbm_per_chip=HBM)
    try:
        t = vmm.create_vm("svc", (1, 1))
        data = torch.arange(32.).reshape(2, 16)
        t.state = {"w": part.distribute({"w": data}, {"w": (None, "model")},
                                        t.vslice.mesh)["w"]
                   if t.vslice.member else None}
        sc = Autoscaler(vmm, sustain=3, window_s=10.0, cooldown_s=0.0,
                        calm_s=5.0, time_fn=lambda: clock[0])
        sc.watch(t, state_template={"w": torch.zeros((2, 16))},
                 shardings_fn=lambda vs: {"w": (vs.mesh, (None, "model"))})
        if rank == 0:                  # only rank 0 sees the pressure
            for _ in range(3):
                t.cq.raise_event(IRQ_DEGRADED, "queue_buildup", {"depth": 9})
        res = {"pending": sc.stats()["watched"]["svc"]["pending_events"]}
        res["grow"] = sc.poll()
        res["grown"] = {"shape": t.vslice.spec.shape, "ids": t.vslice.ranks,
                        "w": None if t.state["w"] is None
                        else t.state["w"].full_tensor().numpy()}
        clock[0] += 6.0
        res["shrink"] = sc.poll()
        res["shrunk"] = {"shape": t.vslice.spec.shape, "ids": t.vslice.ranks,
                         "w": None if t.state["w"] is None
                         else t.state["w"].full_tensor().numpy()}
        res["snapshot"] = vmm.floorplanner.snapshot()
        res["actions"] = vmm.stats()["autoscaler"]["actions"]
        res["ckpt_root"] = vmm.checkpointer.root

        def broken(vs):
            raise OSError("no placement")
        sc.watch(t, state_template={"w": torch.zeros((2, 16))},
                 shardings_fn=broken)
        if rank == 0:
            for _ in range(3):
                t.cq.raise_event(IRQ_DEGRADED, "queue_buildup", {"depth": 9})
        try:
            sc.poll()
            res["failed_grow"] = "recorded"
        except OSError as e:
            res["failed_grow"] = str(e)
        try:
            sc.start()
            res["start"] = "started"
        except RuntimeError as e:
            res["start"] = str(e)
        try:
            Autoscaler(vmm, swap_cb=lambda name: True)
            res["swap_cb"] = "accepted"
        except ValueError as e:
            res["swap_cb"] = str(e)
        return res
    finally:
        vmm.shutdown()


def decode_inputs(t, cfg, n):
    """Reduced qwen's weights (bf16, as the program's abstract parameters
    are), a zero ring and ``n`` tokens, placed over ``t``'s slice by its
    program's specs (Nones on a rank outside the slice)."""
    from repro_torch.checkpointing.checkpoint import tree_map
    from repro_torch.models import Model
    from repro_torch.parallel import partition as part
    if not t.vslice.member:
        return None, (lambda: None), [None] * n
    mesh = t.vslice.mesh
    p_specs, c_specs, t_spec, _ = t.program.bitfile.compiled.specs
    model = Model(cfg, device="cpu")
    params = tree_map(lambda x: x.to(torch.bfloat16)
                      if x.is_floating_point() else x,
                      model.init(torch.Generator().manual_seed(3)))
    gen = torch.Generator().manual_seed(4)
    toks = [part.distribute({"t": torch.randint(
        0, cfg.vocab, (B, 1), generator=gen, dtype=torch.int32)},
        {"t": t_spec}, mesh)["t"] for _ in range(n)]
    return (part.distribute(params, p_specs, mesh),
            lambda: part.distribute(model.init_cache(B, CAP), c_specs, mesh),
            toks)


def autoscaling_in_flight(pod):
    """A (1, 2) decode tenant on the ``fev`` plane: ``N_IN_FLIGHT`` ops
    run alone, then the same ops queued behind a holding op, rank 0's
    ``queue_buildup`` IRQs, and ``poll()`` on every rank (the holder is
    let go half a second into the poll): the grow to (2, 2) waits for the
    queued ops before it gathers the state."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.core import VMM, Autoscaler, ProgramRequest
    from repro_torch.core.scheduler import IRQ_DEGRADED
    from repro_torch.parallel import partition as part
    cfg = get_config(ARCH, reduced=True)
    vmm = VMM(pod, policy="fev", hbm_per_chip=HBM)
    try:
        t = vmm.create_vm("svc", SLICE)
        t.device.reprogram(ProgramRequest(ARCH, "decode", CAP, B))
        data = torch.arange(64.).reshape(4, 16)
        t.state = {"w": part.distribute({"w": data}, {"w": (None, "model")},
                                        t.vslice.mesh)["w"]
                   if t.vslice.member else None}
        sc = Autoscaler(vmm, sustain=3, window_s=10.0, cooldown_s=0.0,
                        scale_down=False, time_fn=lambda: 100.0)
        sc.watch(t, state_template={"w": torch.zeros((4, 16))},
                 shardings_fn=lambda vs: {"w": (vs.mesh, (None, "model"))})
        params, fresh, toks = decode_inputs(t, cfg, N_IN_FLIGHT)

        def logits(res):
            return None if res is None else res[0].full_tensor()
        caches = fresh()
        alone = [logits(t.device.run(params, caches, tok,
                                     torch.tensor(i, dtype=torch.int32)))
                 for i, tok in enumerate(toks)]
        hold = threading.Event()
        vmm.plane.submit(t, "run", hold.wait)
        caches = fresh()
        futs = [t.device.run_async(params, caches, tok,
                                   torch.tensor(i, dtype=torch.int32))
                for i, tok in enumerate(toks)]
        if torch.distributed.get_rank() == 0:
            for _ in range(3):
                t.cq.raise_event(IRQ_DEGRADED, "queue_buildup", {"depth": 9})
        queued = sum(not f.done() for f in futs)
        threading.Timer(0.5, hold.set).start()
        actions = sc.poll()
        queued_after = sum(not f.done() for f in futs)
        got = [logits(f.result(timeout=120)) for f in futs]
        w = t.state["w"]
        return {"queued": queued, "queued_after": queued_after,
                "actions": actions, "ids": t.vslice.ranks,
                "equal": [None if a is None else torch.equal(a, b)
                          for a, b in zip(alone, got)],
                "w": None if w is None else w.full_tensor().numpy()}
    finally:
        vmm.shutdown()


def defragmenting(pod):
    """A (1, 2) tenant behind a (1, 1) one; the (1, 1) leaves and
    ``defragment`` moves the (1, 2) slice to the origin, re-binding its
    program to the new slice's mesh."""
    from repro_torch.core import VMM, ProgramRequest, elastic
    vmm = VMM(pod, policy="hybrid", hbm_per_chip=HBM)
    try:
        small = vmm.create_vm("small", (1, 1))
        big = vmm.create_vm("big", SLICE)
        big.device.reprogram(ProgramRequest(ARCH, "decode", CAP, B))
        before = big.vslice.ranks
        vmm.destroy_vm(small.name)
        moves = elastic.defragment(vmm)
        return {"moves": moves, "before": before, "after": big.vslice.ranks,
                "bound": big.program.bitfile.compiled.mesh is big.vslice.mesh,
                "hits_misses": (vmm.compiler.hits, vmm.compiler.misses)}
    finally:
        vmm.shutdown()


def rank_main(rank, store, out_path, tmp):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    base.init_rank(rank, store)
    pod = make_local_mesh(POD, device_type="cpu")
    res = {"rank": rank, "migration": migration(pod, tmp, rank),
           "autoscaler": autoscaling(pod, tmp, rank),
           "in_flight": autoscaling_in_flight(pod),
           "defragment": defragmenting(pod)}
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
        ref = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, ref_path, str(CAP), str(B)],
            env=env, cwd=base.ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        out = os.path.join(tmp, "port.pkl")
        ctx = mp.start_processes(
            rank_main, nprocs=base.N_RANKS, join=False, start_method="spawn",
            args=(tempfile.mktemp(dir=tmp), out, tmp))
        base.wait(ref)
        base.join_ranks(ctx)
        with open(ref_path, "rb") as f, open(out, "rb") as g:
            return pickle.load(f), pickle.load(g)


@pytest.mark.parametrize("phase", ("start", "migrated", "grown"))
def test_migration_places_the_leaf_as_the_reference(runs, phase):
    ref, ranks = runs
    want = ref[phase]
    data = np.arange(64.).reshape(4, 16)
    for r in ranks:
        got = r["migration"][phase]
        for k in ("slice", "origin", "shape", "ids", "fingerprint", "step"):
            assert got[k] == want[k], (phase, r["rank"], k)
        assert got["step"] == STEP
        if r["rank"] in want["ids"]:
            assert got["member"]
            np.testing.assert_array_equal(got["w"], data)
            assert got["block"] == want["blocks"][r["rank"]]
        else:
            assert not got["member"] and got["w"] is None
    assert ranks[0]["migration"]["migrated"]["slice"] != \
        ranks[0]["migration"]["start"]["slice"]


def test_each_checkpoint_is_written_once(runs):
    _, ranks = runs
    for phase in ("start", "migrated"):
        writers = [r["rank"] for r in ranks if r["migration"][phase]["writes"]]
        assert writers == [0], phase
    # one checkpoint a migration, each with one manifest
    assert ranks[0]["migration"]["manifests"] == [
        os.path.join("migration", "alice", f"step_{STEP:08d}",
                     "manifest.json")]


def test_migration_counts_and_floorplan_follow_the_reference(runs):
    ref, ranks = runs
    for r in ranks:
        m = r["migration"]
        assert (m["hits"], m["misses"]) == (ref["hits"], ref["misses"]) \
            == (1, 2)
        assert m["snapshot"] == ref["snapshot"]
        assert m["grown_program_mesh"]


def test_cross_slice_programs_are_refused_on_every_rank(runs):
    _, ranks = runs
    for r in ranks:
        fingerprint, mesh = r["migration"]["refusals"]
        assert "bound to a different slice" in fingerprint
        assert "another slice's mesh" in mesh
        assert r["migration"]["violations"]["cross_slice_reprogram"] == 2


def test_autoscaler_resizes_alike_on_every_rank(runs):
    _, ranks = runs
    data = np.arange(32.).reshape(2, 16)
    assert [r["autoscaler"]["pending"] for r in ranks] == [3, 0, 0, 0]
    want = ranks[0]["autoscaler"]
    assert [a["action"] for a in want["actions"]] == ["grow", "shrink"]
    assert (want["grown"]["shape"], want["shrunk"]["shape"]) == \
        ((1, 2), (1, 1))
    for r in ranks:
        a = r["autoscaler"]
        assert a["actions"] == want["actions"] and a["grow"] == want["grow"]
        assert a["ckpt_root"] == want["ckpt_root"]
        assert a["snapshot"] == want["snapshot"]
        for phase in ("grown", "shrunk"):
            assert a[phase]["ids"] == want[phase]["ids"]
            if r["rank"] in a[phase]["ids"]:
                np.testing.assert_array_equal(a[phase]["w"], data)
            else:
                assert a[phase]["w"] is None


def test_autoscaler_refuses_what_cannot_be_agreed(runs):
    _, ranks = runs
    for r in ranks:
        # a resize that fails raises on every rank, recorded on none
        assert r["autoscaler"]["failed_grow"] == "no placement"
        assert "poll() on every rank" in r["autoscaler"]["start"]
        assert "multi-rank pod" in r["autoscaler"]["swap_cb"]


def test_autoscaler_waits_for_a_tenants_queued_ops(runs):
    _, ranks = runs
    data = np.arange(64.).reshape(4, 16)
    want = ranks[0]["in_flight"]["actions"]
    assert [(a["action"], a["frm"], a["to"]) for a in want] == \
        [("grow", (1, 2), (2, 2))]
    for r in ranks:
        f = r["in_flight"]
        # every op was still queued when poll() began, none after it
        assert (f["queued"], f["queued_after"]) == (N_IN_FLIGHT, 0)
        assert f["actions"] == want and f["ids"] == (0, 1, 2, 3)
        np.testing.assert_array_equal(f["w"], data)
        if r["rank"] in (0, 1):
            assert f["equal"] == [True] * N_IN_FLIGHT, r["rank"]
        else:
            assert f["equal"] == [None] * N_IN_FLIGHT, r["rank"]


def test_defragment_rebinds_a_moved_slices_program(runs):
    _, ranks = runs
    for r in ranks:
        d = r["defragment"]
        assert (d["moves"], d["before"], d["after"]) == (1, (2, 3), (0, 1))
        assert d["bound"], r["rank"]
        assert d["hits_misses"] == (1, 1)
