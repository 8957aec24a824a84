"""A train step built by ``parallel.build_train`` consumes its inputs, as
the reference's (``jax.jit(..., donate_argnums=(0, 1))``) does: on one
device and on a (2, 2) mesh it updates ``params`` and ``opt_state`` in
place (``optim.update_``) and returns those very trees — each leaf's
storage the one it was given — and k steps give bitwise what the
functional ``optim.update`` gives (losses, gradient norms, parameters,
AdamW's m, v and step). ``launch.op_analysis`` counts the donation as
aliased: ``alias_bytes`` equal to the bytes of params plus optimizer
state, on one device (meta) and on a rank of a (2, 2) ``"fake"`` group,
where a recurrent prefill's outputs also hold only their own bytes.

Reduced configs on the CPU; the mesh on 4 spawned gloo ranks (one
thread each, a ``file://`` store, no ports). No JAX here: the spawned
ranks import this file.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
ARCH = "qwen1.5-0.5b"
B, S, K = 4, 16, 3
N_RANKS = 4


def _leaves(tree):
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    return flatten_with_path(tree)


def _clone(tree):
    from repro_torch.checkpointing.checkpoint import tree_map
    return tree_map(torch.clone, tree)


def _ptrs(tree):
    from torch.distributed.tensor import DTensor
    return [(t.to_local() if isinstance(t, DTensor) else t).data_ptr()
            for _, t in _leaves(tree)]


def _batches(cfg, n):
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline_for
    pipe = pipeline_for(cfg, ShapeCell("t", S, B, "train"), seed=0)
    return [batch_from_numpy(pipe.batch(i)) for i in range(n)]


def _bitwise(got, want, what):
    """Every leaf of ``got`` equal to ``want``'s, bit for bit."""
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(_leaves(want))
    for (path, g), (_, w) in pairs:
        assert g.dtype == w.dtype, (what, path)
        assert torch.equal(g.reshape(-1).view(torch.uint8),
                           w.reshape(-1).view(torch.uint8)), (what, path)


def functional_into(opt, grads, state, params, grad_norm=None):
    """``optim.update``'s new trees copied into ``params`` and ``state``:
    the functional form's bits in the donated form's storage."""
    from repro_torch import optim
    new_p, new_s, om = optim.update(opt, grads, state, params,
                                    grad_norm=grad_norm)
    for (_, dst), (_, src) in zip(_leaves([params, state]),
                                  _leaves([new_p, new_s])):
        dst.copy_(src)
    return params, state, om


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("micro,compress,block", [
    (1, False, None), (2, True, None), (1, False, 512)])
def test_device_step_consumes_its_inputs_bit_for_bit(micro, compress, block,
                                                     monkeypatch):
    """K steps of ``build_train``'s step against ``make_train_step``'s
    functional form from clones of the same trees (with ``micro_steps``
    and bf16 accumulation; and with ``UPDATE_BLOCK`` small enough that
    the embedding and head update in row blocks)."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.parallel import build_train
    if block is not None:
        monkeypatch.setattr(adamw, "UPDATE_BLOCK", block)
    cfg = get_config(ARCH, reduced=True)
    opt = optim.OptConfig(state_dtype=cfg.opt_dtype, warmup_steps=2,
                          micro_steps=micro, grad_compress=compress)
    cpu = torch.device("cpu")
    params = Model(cfg, cpu).init(torch.Generator().manual_seed(0))
    state = optim.init(opt, params)
    fp, fs = _clone(params), _clone(state)
    run, _ = build_train(cfg, cpu, ShapeCell("t", S, B, "train"), opt)
    functional = optim.make_train_step(Model(cfg, cpu), opt)
    ptrs = _ptrs([params, state])
    for batch in _batches(cfg, K):
        p_out, s_out, m = run(params, state, batch)
        assert p_out is params and s_out is state
        assert _ptrs([p_out, s_out]) == ptrs
        fp, fs, fm = functional(fp, fs, batch)
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[key], fm[key]), key
    _bitwise(params, fp, "params")
    _bitwise(state, fs, "optimizer state")
    assert int(state["step"]) == K


def test_update_in_place_is_the_functional_update_bit_for_bit():
    """``optim.update_`` against ``optim.update`` leaf by leaf on a tree
    of fp32 and bf16 leaves with fp32 and bf16 state, decayed and not,
    whole and in row blocks."""
    from repro_torch import optim
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(4)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)
    for sdt in ("float32", "bfloat16"):
        opt = optim.OptConfig(state_dtype=sdt, warmup_steps=2)
        params = {"w": rnd(40, 30), "wb": rnd(64, 8, dtype=torch.bfloat16),
                  "scale": rnd(30), "bias": rnd()}
        state = optim.init(opt, params)
        fp, fs = _clone(params), _clone(state)
        saved = adamw.UPDATE_BLOCK
        try:
            for block in (saved, 100):
                adamw.UPDATE_BLOCK = block
                for _ in range(2):
                    grads = {k: rnd(*v.shape) for k, v in params.items()}
                    out = optim.update_(opt, grads, state, params)
                    fp, fs, fm = optim.update(opt, grads, fs, fp)
                    assert out[0] is params and out[1] is state
                    assert torch.equal(out[2]["lr"], fm["lr"])
                    _bitwise(params, fp, f"params {sdt}")
                    _bitwise(state, fs, f"state {sdt}")
        finally:
            adamw.UPDATE_BLOCK = saved


# ---------------------------------------------------------------------------
# A (2, 2) mesh on 4 gloo ranks
# ---------------------------------------------------------------------------


def mesh_rank(rank, store, out_path):
    """K donated steps on a (2, 2) mesh, then K from the same start with
    ``optim.update_`` swapped for :func:`functional_into`; rank 0 writes
    whether the trees came back as given and the gathered results."""
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    from repro_torch.parallel import build_train
    from repro_torch.parallel import partition as part
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=N_RANKS)
    cfg = get_config(ARCH, reduced=True)
    opt = optim.OptConfig(state_dtype=cfg.opt_dtype, warmup_steps=2)
    mesh = make_local_mesh((2, 2), device_type="cpu")
    run, _ = build_train(cfg, mesh, ShapeCell("t", S, B, "train"), opt)
    params = Model(cfg, torch.device("cpu")).init(
        torch.Generator().manual_seed(0))
    batches = _batches(cfg, K)
    runs, same = {}, []
    for form in ("donated", "functional"):
        if form == "functional":
            optim.update_ = functional_into
        p = part.distribute(_clone(params), run.specs[0], mesh)
        s = part.distribute(optim.init(opt, params), run.specs[1], mesh)
        ptrs = _ptrs([p, s])
        losses = []
        for batch in batches:
            p_out, s_out, m = run(p, s, part.distribute(
                batch, run.specs[2], mesh))
            same.append(p_out is p and s_out is s
                        and _ptrs([p_out, s_out]) == ptrs)
            losses.append((m["loss"].clone(), m["grad_norm"].clone()))
        full = [t.full_tensor().clone() for _, t in _leaves([p, s])]
        runs[form] = (losses, full)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"same": same, "runs": runs}, f)
    dist.barrier()
    dist.destroy_process_group()


def test_mesh_step_consumes_its_inputs_bit_for_bit(tmp_path):
    import torch.multiprocessing as mp
    out = str(tmp_path / "mesh.pkl")
    store = tempfile.mktemp(dir=str(tmp_path))
    mp.start_processes(mesh_rank, nprocs=N_RANKS, join=True,
                       start_method="spawn", args=(store, out))
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["same"] == [True] * (2 * K)
    (d_loss, d_full), (f_loss, f_full) = (got["runs"]["donated"],
                                          got["runs"]["functional"])
    for (a, b), (c, d) in zip(d_loss, f_loss):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert len(d_full) == len(f_full)
    for a, b in zip(d_full, f_full):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The dry run's counter: donation aliased, state rows of their own size
# ---------------------------------------------------------------------------


def test_counter_aliases_the_donated_state_on_one_device():
    """``build_train`` on meta: every byte of params and optimizer state
    is an output aliased to its argument, so the reckoning counts them
    once."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.parallel import build_train
    cfg = get_config(ARCH, reduced=True)
    step, args = build_train(cfg, torch.device("meta"),
                             ShapeCell("t", S, B, "train"))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in _leaves(tree))
    with OpCounter(args) as c:
        out = step(*args)
    mem = c.finish(out).memory
    state = nbytes([args[0], args[1]])
    assert mem["alias_bytes"] == state
    # beside the donated trees only the metrics' scalars are new
    assert mem["output_bytes"] == state + nbytes(out[2])
    assert mem["per_device_bytes"] == (mem["argument_bytes"]
                                       + mem["temp_bytes"]
                                       + nbytes(out[2]))


FAKE_RANK = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.op_analysis import OpCounter, _local_tensors
    from repro_torch.parallel import build_step_for_cell
    B, S = int(sys.argv[1]), int(sys.argv[2])
    mesh = make_local_mesh((2, 2), device_type="cpu")
    # a prefill of 2 rows: one a rank of the data axis, where a narrowed
    # ring block is contiguous (the case a view would pin)

    def own(tree):
        return sum(t.numel() * t.element_size()
                   for t in _local_tensors(tree))

    # every layer's K/V cache as attn_full returns it, before the stack
    from repro_torch.models import attention
    layer_caches = []
    full = attention.attn_full

    def recording(*a, **k):
        y, cache = full(*a, **k)
        if cache is not None:
            layer_caches.append([t.untyped_storage().nbytes() - t.numel()
                                 * t.element_size() for t in cache.values()])
        return y, cache
    attention.attn_full = recording
    out = {}
    for arch, kind in (("qwen1.5-0.5b", "train"), ("rwkv6-7b", "train"),
                       ("rwkv6-7b", "prefill"),
                       ("recurrentgemma-2b", "prefill")):
        cfg = get_config(arch, reduced=True)
        step, args = build_step_for_cell(
            cfg, mesh, ShapeCell(kind, S, B if kind == "train" else 2,
                                 kind))
        with OpCounter(args) as c:
            res = step(*args)
        mem = c.finish(res).memory
        mem["state"] = own(list(args[:2])) if kind == "train" else None
        mem["own_outputs"] = own(res)
        mem["layer_cache_excess"] = layer_caches[:]
        layer_caches.clear()
        out[arch + "/" + kind] = mem
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def fake_rank():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", FAKE_RANK, str(B), str(S)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b"])
def test_counter_aliases_the_donated_state_on_a_mesh(fake_rank, arch):
    """Rank 0 of a (2, 2) group: the rank's blocks of params and state
    are outputs aliased to its arguments."""
    mem = fake_rank[f"{arch}/train"]
    assert mem["alias_bytes"] == mem["state"]
    # the rest of the outputs: the metrics' scalars, new
    assert mem["output_bytes"] == mem["own_outputs"]
    assert mem["output_bytes"] - mem["alias_bytes"] < 64


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_mesh_prefill_outputs_hold_their_own_bytes(fake_rank, arch):
    """A rank's prefill outputs (logits, its blocks of the rings and of the
    state rows) hold storage of their own size only: no state row keeps
    the activation it was cut from, and no ring block the whole ring (at
    one row a rank, recurrentgemma's sequence-split ring blocks)."""
    mem = fake_rank[f"{arch}/prefill"]
    assert mem["output_bytes"] == mem["own_outputs"]
    assert mem["alias_bytes"] == 0
    # each attention layer's ring block owns its storage before the
    # layers' caches are stacked (a narrowed view kept every rank's slots
    # of every layer alive until then)
    excess = mem["layer_cache_excess"]
    assert excess == [[0, 0]] * len(excess)
    assert len(excess) == {"rwkv6-7b": 0, "recurrentgemma-2b": 1}[arch]
