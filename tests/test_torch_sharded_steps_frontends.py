"""The mesh paths the production dry run's cells need, on 4 CPU ranks
(gloo) against the reference's sharded steps on a (2, 2) ("data",
"model") mesh of 4 forced host devices, in fp32:

* the VLM projector and the enc-dec encoder (reduced internvl2-2b and
  whisper-medium): prefill with the stub frontend inputs, decode from its
  caches (whisper's cross K/V rows split by heads), train;
* a sequence-split ring without ``decode_splitk`` (reduced
  recurrentgemma-2b: one K/V head, so the rules split its ring's
  sequence): the rank gathers the ring and runs one decode over it;
* gradient accumulation (reduced qwen1.5-0.5b, ``micro_steps=2``, also
  bf16-compressed): the reference's micro-batches are row blocks of the
  global batch, which the batch axes split otherwise; the train mask
  differs by row (one row nearly empty), so grouping the rows otherwise
  would weight the tokens otherwise.

Inputs come from seeds in a reference subprocess; the port's ranks run
the mesh builders on the same inputs (carried over by the bridge).
Tolerances are those of ``tests/test_torch_sharded_steps.py`` (2e-5 on
|Δ| / (1 + |want|); its per-leaf checks of a train step), except the
bf16-compressed accumulation: each micro-step's gradient is rounded to
bf16 there, and the order of the sums over ranks moves a rounding, so
its losses and norms within 2e-5 and its m, v and parameters within
bf16's step (2⁻⁸ relative) of the reference's.
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

MESH = (2, 2)
B, S, CAP, S_TRAIN, N_DEC, N_TRAIN = 4, 12, 16, 16, 4, 2
#: case → (arch, ShardingProfile fields, OptConfig fields)
CASES = {
    "internvl2": ("internvl2-2b", {}, {}),
    "whisper": ("whisper-medium", {}, {}),
    "no_splitk": ("recurrentgemma-2b", {"decode_splitk": False}, {}),
    "micro": ("qwen1.5-0.5b", {}, {"micro_steps": 2}),
    "micro_compress": ("qwen1.5-0.5b", {}, {"micro_steps": 2,
                                            "grad_compress": True}),
}

REFERENCE = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np, jax
    from repro import optim
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.parallel.steps import build_step_for_cell

    arch, inp, out, sharding, opt, B, S, CAP, S_TRAIN, N_DEC, N_TRAIN = (
        sys.argv[1], sys.argv[2], sys.argv[3], eval(sys.argv[4]),
        eval(sys.argv[5]), *map(int, sys.argv[6:]))
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              sharding=dataclasses.replace(cfg.sharding,
                                                           **sharding))
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    fe = cfg.frontend
    n_pre = fe.n_tokens if cfg.family == "vlm" else 0
    rng = np.random.default_rng(1)
    ints = lambda *shape: rng.integers(0, cfg.vocab, shape).astype(np.int32)

    def frontend(batch):
        if fe is not None:
            key = "patches" if cfg.family == "vlm" else "frames"
            batch[key] = rng.standard_normal(
                (B, fe.n_tokens, fe.d_in)).astype(np.float32)
        return batch

    def train_batch():
        L = n_pre + S_TRAIN
        mask = (rng.random((B, L)) > 0.2).astype(np.float32)
        mask[:, :n_pre] = 0.0
        mask[1, n_pre + 2:] = 0.0         # a nearly empty row
        return frontend({"tokens": ints(B, S_TRAIN), "labels": ints(B, L),
                         "mask": mask})
    params = to_np(build_model(cfg).init(jax.random.PRNGKey(0)))
    inputs = {"params": params, "prefill": frontend({"tokens": ints(B, S)}),
              "dec_tokens": [ints(B, 1) for _ in range(N_DEC)],
              "train": [train_batch() for _ in range(N_TRAIN)],
              "start": n_pre + S}
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    sds = lambda t: jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype), t)

    def compiled(jitted, *args):
        return jitted.lower(*sds(args)).compile()

    mesh = make_local_mesh((2, 2))
    r = {}
    pf, _ = build_step_for_cell(cfg, mesh, ShapeCell("p", CAP, B, "prefill"))
    comp = compiled(pf, params, inputs["prefill"])
    logits, caches = comp(params, inputs["prefill"])
    r["prefill_logits"], caches = to_np(logits), to_np(caches)
    r["prefill_caches"] = caches
    dec, _ = build_step_for_cell(cfg, mesh, ShapeCell("d", CAP, B, "decode"))
    comp, r["decode_logits"] = None, []
    for i, tok in enumerate(inputs["dec_tokens"]):
        pos = np.int32(inputs["start"] + i)
        comp = comp or compiled(dec, params, caches, tok, pos)
        logits, caches = comp(params, caches, tok, pos)
        r["decode_logits"].append(to_np(logits))
        caches = to_np(caches)
    r["decode_caches"] = caches
    oc = optim.OptConfig(state_dtype=cfg.opt_dtype, **opt)
    tr, _ = build_step_for_cell(cfg, mesh,
                                ShapeCell("t", S_TRAIN, B, "train"), oc)
    p, o = params, to_np(optim.init(oc, params))
    comp, r["losses"], r["gnorms"] = None, [], []
    for bt in inputs["train"]:
        comp = comp or compiled(tr, p, o, bt)
        p, o, met = comp(p, o, bt)
        p, o = to_np(p), to_np(o)
        r["losses"].append(float(met["loss"]))
        r["gnorms"].append(float(met["grad_norm"]))
    r["params"], r["opt"] = p, o
    with open(out, "wb") as f:
        pickle.dump(r, f)
''')


def start_reference(arch, inp, out, sharding, opt):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={base.N_RANKS}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = base.SRC
    args = [str(v) for v in (B, S, CAP, S_TRAIN, N_DEC, N_TRAIN)]
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, arch, inp, out, repr(sharding),
         repr(opt), *args], env=env, cwd=base.ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def rank_main(rank, store, cases, tmp):
    """The port's mesh builders on one rank, every case on its inputs;
    rank 0 writes the gathered results."""
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy, params_from_jax
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import steps
    base.init_rank(rank, store)
    mesh = make_local_mesh(MESH, device_type="cpu")
    runs = {}
    for name, (arch, sharding, opt) in cases.items():
        with open(os.path.join(tmp, f"inputs-{name}.pkl"), "rb") as f:
            inputs = pickle.load(f)
        cfg = base.cfg_of(arch, sharding)
        params = params_from_jax(inputs["params"])
        r = {}
        pf, _ = steps.build_prefill(cfg, mesh,
                                    ShapeCell("p", CAP, B, "prefill"))
        dp = part.distribute(params, pf.specs[0], mesh)
        batch = part.distribute(batch_from_numpy(inputs["prefill"]),
                                pf.specs[1], mesh)
        logits, caches = pf(dp, batch)
        r["prefill_logits"] = base.full(logits)
        r["prefill_caches"] = base.full(caches)
        dec, _ = steps.build_decode(cfg, mesh,
                                    ShapeCell("d", CAP, B, "decode"))
        r["decode_logits"] = []
        for i, tok in enumerate(inputs["dec_tokens"]):
            tok = part.distribute({"t": torch.from_numpy(tok)},
                                  {"t": dec.specs[2]}, mesh)["t"]
            pos = torch.tensor(inputs["start"] + i, dtype=torch.int32)
            logits, caches = dec(dp, caches, tok, pos)
            r["decode_logits"].append(base.full(logits))
        r["decode_caches"] = base.full(caches)
        oc = optim.OptConfig(state_dtype=cfg.opt_dtype, **opt)
        tr, _ = steps.build_train(cfg, mesh,
                                  ShapeCell("t", S_TRAIN, B, "train"), oc)
        p = part.distribute(params, tr.specs[0], mesh)
        o = part.distribute(optim.init(oc, params), tr.specs[1], mesh)
        r["losses"], r["gnorms"] = [], []
        for bt in inputs["train"]:
            p, o, met = tr(p, o, part.distribute(batch_from_numpy(bt),
                                                 tr.specs[2], mesh))
            r["losses"].append(float(met["loss"]))
            r["gnorms"].append(float(met["grad_norm"]))
        r["params"], r["opt"] = base.full(p), base.full(o)
        runs[name] = r
    if rank == 0:
        with open(os.path.join(tmp, "port.pkl"), "wb") as f:
            pickle.dump(runs, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: {"ref", "port", "inputs", "start"}}: the reference
    processes write the inputs first, then the ranks run every case."""
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("frontends"))
    refs = {n: start_reference(a, os.path.join(tmp, f"inputs-{n}.pkl"),
                               os.path.join(tmp, f"ref-{n}.pkl"), sh, op)
            for n, (a, sh, op) in CASES.items()}
    for proc in refs.values():
        base.wait(proc)
    store = tempfile.mktemp(dir=tmp)
    ctx = mp.start_processes(rank_main, nprocs=base.N_RANKS, join=False,
                             start_method="spawn",
                             args=(store, CASES, tmp))
    base.join_ranks(ctx)
    with open(os.path.join(tmp, "port.pkl"), "rb") as f:
        port = pickle.load(f)
    out = {}
    for name in CASES:
        with open(os.path.join(tmp, f"ref-{name}.pkl"), "rb") as f:
            ref = pickle.load(f)
        with open(os.path.join(tmp, f"inputs-{name}.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out[name] = {"ref": ref, "port": port[name], "inputs": inputs,
                     "start": base.ref_params(inputs["params"])}
    return out


def _caches(run, key, arch):
    from repro_torch.bridge import caches_from_jax
    return caches_from_jax(run[key], base.cfg_of(arch))


@pytest.mark.parametrize("case", ["internvl2", "whisper", "no_splitk"])
def test_prefill_equals_reference(runs, case):
    arch = CASES[case][0]
    r, want = runs[case]["port"], runs[case]["ref"]
    base.close(r["prefill_logits"], want["prefill_logits"], 2e-5,
               "prefill logits")
    base.close_trees(r["prefill_caches"],
                     _caches(want, "prefill_caches", arch), 2e-5,
                     "prefill caches")


@pytest.mark.parametrize("case", ["internvl2", "whisper", "no_splitk"])
def test_decode_equals_reference(runs, case):
    arch = CASES[case][0]
    r, want = runs[case]["port"], runs[case]["ref"]
    for i, (a, b) in enumerate(zip(r["decode_logits"],
                                   want["decode_logits"])):
        base.close(a, b, 2e-5, f"decode {i} logits")
    base.close_trees(r["decode_caches"],
                     _caches(want, "decode_caches", arch), 2e-5,
                     "decode caches")


@pytest.mark.parametrize("case", ["internvl2", "whisper", "micro"])
def test_train_equals_reference(runs, case):
    base.check_train(runs[case]["port"], runs[case]["ref"],
                     runs[case]["start"], 2e-5, True)


def test_compressed_accumulation_follows_reference(runs):
    from repro_torch.bridge import opt_state_from_jax
    r, want = runs["micro_compress"]["port"], runs["micro_compress"]["ref"]
    base.close(r["losses"], want["losses"], 2e-5, "train losses")
    base.close(r["gnorms"], want["gnorms"], 2e-5, "grad norms")
    wo = opt_state_from_jax(want["opt"])
    bf16 = 2.0 ** -8
    for what in ("m", "v"):
        for (path, a), (_, b) in zip(base.leaves(r["opt"][what]),
                                     base.leaves(wo[what])):
            assert base.rel_err(a, b) <= bf16, (what, path)
    base.close_trees(r["params"], base.ref_params(want["params"]),
                     bf16 + base.lr_bound(), "params after training")


def test_the_row_grouping_matters(runs):
    """The test has teeth: a rank's own rows split in two ({0, 2} and
    {1, 3} on the two data ranks) are other micro-batches than the
    reference's row blocks ({0, 1} and {2, 3}), and with the nearly
    empty row they weight the tokens otherwise — the port's one-device
    accumulation over rows so regrouped misses the reference's first
    loss by far more than the tolerance; the mesh run meets it."""
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy, params_from_jax
    from repro_torch.configs.base import ShapeCell
    from repro_torch.parallel import steps
    arch, sharding, opt = CASES["micro"]
    inputs = runs["micro"]["inputs"]
    cfg = base.cfg_of(arch, sharding)
    oc = optim.OptConfig(state_dtype=cfg.opt_dtype, **opt)
    tr, _ = steps.build_train(cfg, torch.device("cpu"),
                              ShapeCell("t", S_TRAIN, B, "train"), oc)
    params = params_from_jax(inputs["params"])
    bt = {k: v[[0, 2, 1, 3]] for k, v in inputs["train"][0].items()}
    _, _, met = tr(params, optim.init(oc, params), batch_from_numpy(bt))
    want = runs["micro"]["ref"]["losses"][0]
    assert abs(float(met["loss"]) - want) > 100 * 2e-5 * (1 + abs(want))
    base.close(runs["micro"]["port"]["losses"][0], want, 2e-5, "loss")
