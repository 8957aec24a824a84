"""The train driver's checkpoints on a mesh: two CPU ranks (gloo over a
``file://`` store, a ``(1, 2)`` mesh) each calling ``train.main`` inside
their process group, as ``chip_smoke.py``'s ``[vslices]`` calls it on the
card; reduced qwen1.5-0.5b, B=4 S=32, 10 steps, a checkpoint every 5.

``--fail-at 6`` exits 17 on each rank after the step-5 checkpoint, and
``--resume`` goes on at step 6: steps 6-9 equal the uninterrupted mesh
run's bit for bit. The checkpoint (whole leaves, gathered inside the
mesh and written by rank 0) is read by the reference's
``repro.checkpointing.restore`` (every leaf equal to the port's read)
and by the one-process driver's ``--resume`` (its losses within 1e-3
relative of the mesh run's: bf16 partial sums over the model axis).
"""
import os
import pickle
import tempfile

import numpy as np
import pytest

import test_torch_sharded_steps as base

N_RANKS = 2
ARGS = ["--device", "cpu", "--steps", "10", "--batch", "4", "--seq", "32",
        "--ckpt-every", "5"]


def rank_main(rank, store, tmp, out_path):
    """The uninterrupted run, the crash at step 6 and the resume, in one
    process group; rank 0 writes every rank's results."""
    import contextlib
    import io
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=N_RANKS)
    ck = os.path.join(tmp, "ck")
    res = {"rank": rank}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res["whole"] = train.main(ARGS + ["--ckpt-dir",
                                          os.path.join(tmp, "whole")])
        try:
            train.main(ARGS + ["--ckpt-dir", ck, "--fail-at", "6"])
            res["code"] = 0
        except SystemExit as e:
            res["code"] = e.code
        dist.barrier()
        res["listing"] = sorted(os.listdir(ck))
        if rank == 0:
            # a copy for the one-process driver, which checkpoints into it
            shutil.copytree(ck, os.path.join(tmp, "ck_one"))
        dist.barrier()
        res["resumed"] = train.main(ARGS + ["--ckpt-dir", ck, "--resume"])
    res["printed"] = printed.getvalue()
    per_rank = [None] * N_RANKS
    dist.all_gather_object(per_rank, res)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(per_rank, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    out = tmp / "ranks.pkl"
    ctx = mp.start_processes(
        rank_main, nprocs=N_RANKS, join=False, start_method="spawn",
        args=(tempfile.mktemp(dir=tmp), str(tmp), str(out)))
    base.join_ranks(ctx)
    with open(out, "rb") as f:
        return {"tmp": tmp, "ranks": pickle.load(f)}


def test_fail_at_exits_17_after_the_checkpoint(runs):
    for r in runs["ranks"]:
        assert r["code"] == 17, r["rank"]
        assert r["listing"] == ["step_00000005"]
    assert "simulated failure at step 6" in runs["ranks"][0]["printed"]


def test_resume_repeats_the_uninterrupted_run_bit_for_bit(runs):
    lead = runs["ranks"][0]
    assert "resumed from step 5" in lead["printed"]
    for r in runs["ranks"]:
        want, got = r["whole"], r["resumed"]
        assert sorted(want) == list(range(10)) and sorted(got) == [6, 7, 8, 9]
        assert {k: want[k] for k in got} == got
        assert want == lead["whole"]


def test_the_reference_reads_the_mesh_checkpoint(runs):
    """The reference's ``restore`` over a template of the port's tree
    layout (numpy leaves): step, meta and every leaf as the port reads
    them."""
    from repro.checkpointing import latest as jax_latest
    from repro.checkpointing import restore as jax_restore

    from repro_torch import optim
    from repro_torch.checkpointing import latest, restore
    from repro_torch.checkpointing.checkpoint import (flatten_with_path,
                                                      tree_map)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = Model(cfg, device="meta").init(None)
    tree = {"params": params, "opt": optim.init(
        optim.OptConfig(state_dtype=cfg.opt_dtype), params)}
    step, got, meta = restore(latest(str(runs["tmp"] / "ck")), tree)
    template = tree_map(lambda t: np.zeros(
        tuple(t.shape), str(t.dtype).replace("torch.", "")), tree)
    ref_step, ref, ref_meta = jax_restore(
        jax_latest(str(runs["tmp"] / "ck")), template)
    assert step == ref_step == 5
    assert meta == ref_meta == {"arch": "qwen1.5-0.5b"}
    ref = dict(flatten_with_path(ref))
    for path, leaf in flatten_with_path(got):
        np.testing.assert_array_equal(np.asarray(ref[path]), leaf.numpy(),
                                      err_msg=str(path))


def test_the_one_process_driver_resumes_the_mesh_checkpoint(runs):
    from repro_torch.launch import train
    got = train.main(ARGS + ["--ckpt-dir", str(runs["tmp"] / "ck_one"),
                             "--resume"])
    want = runs["ranks"][0]["whole"]
    assert sorted(got) == [6, 7, 8, 9]
    for step, loss in got.items():
        assert loss == pytest.approx(want[step], rel=1e-3), step
