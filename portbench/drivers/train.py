"""Training cells: a one-slice VMM tenant under the ``hybrid`` policy runs
its ``train`` program (``build_train`` through the VMM's compile
service, as ``chip_smoke.py``'s virtualized train does), so every step
goes through ``tenant.device.run``.

Set-up makes the weights from the seed (fp32, the port's layout) and
AdamW's state, and drives the first three steps through the window's own
call and feed; their losses, the first gradient as AdamW got it (its
``m`` after one step over ``1 - beta1``) and each leaf's change after
three steps are kept. The window runs the same object on, a new batch a
step. After it the program's state is freed and the plain reference
follows the first three steps from the same weights and batches.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np

from portbench import generator, harness, weights
from portbench.counts import model as model_counts
from portbench.reference import train as ref_train
from portbench.trace import TRACE_SECONDS, DeviceTrace, Spans

#: the steps the reference follows
CHECKED_STEPS = 3


def batch(mix, seed, step, vocab, device):
    import torch
    return {k: torch.from_numpy(v).to(device)
            for k, v in generator.train_batch(mix, seed, step, vocab).items()}


def opt_config(mix, cfg):
    from repro_torch.optim import OptConfig
    return OptConfig(state_dtype=cfg.opt_dtype, **mix["optimizer"])


def leaf_norms(tree, paths):
    import torch
    norms = [weights.get(tree, p).float().norm() for p in paths]
    return [float(x) for x in torch.stack(norms).cpu()]


def change_norms(arch, conf, seed, params, paths, device):
    """Each leaf's ‖p − p₀‖, p₀ made again from the seed a group at a
    time."""
    out = {}
    for name in arch.top_groups(conf):
        for p, t0 in weights.make_top(arch, conf, seed, name, device,
                                      "train").items():
            out[p] = float((weights.get(params, p) - t0).norm())
    for i in range(conf["n_layers"]):
        for p, t0 in weights.make_layer(arch, conf, seed, i, device,
                                        "train").items():
            out[("layers", i) + p] = float(
                (weights.get(params, ("layers", i) + p) - t0).norm())
    return [out[p] for p in paths]


def run(ctx, fault=None):
    """``fault`` (tests only) breaks the timed path underneath:
    ``"unchanged"`` makes the program return its state unchanged,
    ``"half_batch"`` leaves half of each batch's tokens out of the
    loss."""
    import torch
    from repro_torch.core import ProgramRequest
    from repro_torch.core.reconfig import CompileService
    from repro_torch.launch.serve import virtual_server
    from repro_torch.optim import init as opt_init
    from repro_torch.parallel import build_step_for_cell

    cfg, conf, mix, dev = ctx.cfg, ctx.conf, ctx.mix, ctx.device
    arch = ctx.arch
    on_card = dev.type == "cuda"
    rec = harness.Record()
    rec.ctx = ctx
    spans = rec.spans = Spans(ctx.trace)
    opt = opt_config(mix, cfg)
    B, S = mix["batch"], mix["seq_len"]

    vmm, tenant = virtual_server(dev, "hybrid")
    vmm.compiler = CompileService(
        lambda _cfg, d, c, **kw: build_step_for_cell(cfg, d, c, **kw))
    tenant.device.reprogram(ProgramRequest(
        arch=cfg.name, kind="train", seq_len=S, global_batch=B,
        reduced=False, opt_flags=tuple(dataclasses.asdict(opt).items())))
    program = tenant.program
    inner = []

    def timed(*a):
        t0 = time.monotonic()
        out = program(*a)
        inner.append(time.monotonic() - t0)
        return out
    if fault == "unchanged":
        def timed(params, state, b):          # noqa: F811
            from repro_torch.optim import loss_and_grads
            from repro_torch.models import Model
            loss, _, _ = loss_and_grads(Model(cfg, device=dev), params, b)
            inner.append(0.0)
            return params, state, {"loss": loss}
    tenant.program = timed

    def step(params, state, b):
        if fault == "half_batch":
            b = dict(b, mask=b["mask"].clone())
            b["mask"][:, : S // 2] = 0
        t0 = time.monotonic()
        out = tenant.device.run(params, state, b)
        t1 = time.monotonic()
        spans.add("tenant:train", t0, t1)
        rec.counts.setdefault("tax", []).append(t1 - t0 - inner[-1])
        return out

    paths = weights.leaf_paths(arch, conf)
    params = weights.make_tree(arch, conf, ctx.seed, dev, "train")
    state = opt_init(opt, params)
    losses = []
    for i in range(CHECKED_STEPS):
        params, state, m = step(params, state,
                                batch(mix, ctx.seed, i, cfg.vocab, dev))
        losses.append(float(m["loss"]))
        if i == 0:
            grad1 = [x / (1.0 - opt.beta1)
                     for x in leaf_norms(state["m"], paths)]
    change = change_norms(arch, conf, ctx.seed, params, paths, dev)
    dtrace = DeviceTrace(dev, cpu=True) if ctx.trace and on_card else None
    if dtrace is not None:
        dtrace.open()
    rec.counts["tax"] = []
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()

    # ---- the window ------------------------------------------------
    t_start = time.monotonic()
    rec.e2e["setup_s"] = t_start - ctx.t_process
    end = t_start + ctx.seconds
    trace_from = end - min(TRACE_SECONDS, ctx.seconds)
    traced = False
    ends = []
    i = CHECKED_STEPS
    while time.monotonic() < end:
        if dtrace is not None and not traced \
                and time.monotonic() >= trace_from:
            dtrace.start()
            traced = True
        b = batch(mix, ctx.seed, i, cfg.vocab, dev)
        params, state, m = step(params, state, b)
        loss = float(m["loss"])
        ends.append((time.monotonic(), loss))
        i += 1
    if traced:
        dtrace.stop()
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    peak = max(window_peak, setup_peak) if on_card else 0
    done = [t for t, _ in ends if t <= end]
    rec.attempted = len(ends)
    rec.failed = sum(1 for _, x in ends if not math.isfinite(x))
    tokens = B * S * len(done)
    rec.e2e["train_tok_s"] = tokens / (done[-1] - t_start) if done else 0.0
    rec.e2e["train_peak_gib"] = window_peak / 2 ** 30
    rec.counts.update(window=(t_start, end), steps=len(done),
                      flops=B * model_counts.train_flops(arch, conf, S)
                      * len(done), step_ends=[t for t, _ in ends])
    rec.trace = dtrace.read(spans) if traced else None
    if traced:
        rec.notes.append(dtrace.note)
    rec.device = harness.device_info(dev, peak)

    # ---- correctness: the reference follows the first three steps -------
    del params, state, m, program
    tenant.program = None
    vmm.shutdown()
    del vmm, tenant
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    want = ref_train.follow(arch, conf, mix, ctx.seed, dev, CHECKED_STEPS)
    readings = compare(losses, grad1, change, want)
    rec.counts["readings"] = readings
    rec.counts["reference"] = want
    rec.counts["program"] = {"losses": losses, "grad1": grad1,
                             "change": change}
    rec.correct, rec.checks = harness.judge(readings, ctx.limits)
    return rec


def leaf_gaps(got, want, keep=None):
    """Each leaf's gap between the program's and the reference's norm,
    over the larger of that leaf's reference norm and the median
    leaf's."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = float(np.median([want[i] for i in idx]))
    return [abs(got[i] - want[i]) / max(want[i], med, 1e-30) for i in idx]


def compare(losses, grad1, change, want):
    """The numbers ``correct`` may compare (a cell's limits file names
    those it does): the steps' losses (the largest relative gap, and the
    first step's), the first gradient and the change after three steps,
    each by its worst leaf and by its median leaf; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the change: under AdamW they move by round-off alone."""
    rl, rg, rc = want["losses"], want["grad1"], want["change"]
    med = float(np.median(rg))
    keep = [g >= 1e-3 * med for g in rg]
    grad = leaf_gaps(grad1, rg)
    change = leaf_gaps(change, rc, keep)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, rl)),
            "loss_gap_first": abs(losses[0] - rl[0]) / abs(rl[0]),
            "grad_gap": max(grad),
            "grad_gap_median": float(np.median(grad)),
            "change_gap": max(change),
            "change_gap_median": float(np.median(change))}
