"""``correct`` comes out false when the timed path is broken underneath:
a whole run of each cell at the port's CPU sizes, the look for a card
skipped, once for each fault the cell can have (a token altered where it
is produced; a step that returns its state unchanged; half of the batch
left out). And the control — the plain reference in float8 in the
program's place — reads well above the program, and in training fails
the cell's limits."""
import math
import time

import numpy as np
import pytest
import torch

import portbench_tiny as tiny
from portbench import harness
from portbench.drivers import serve, train
from portbench.reference import train as ref_train

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


def _alter_tokens(monkeypatch, vocab):
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine
    host, fused = ServeEngine._sample, Model.decode_paged_fused

    def sample(self, logits, rows):
        return (host(self, logits, rows) + 1) % vocab

    def decode(self, *a, **kw):
        toks, state = fused(self, *a, **kw)
        return (toks + 1) % vocab, state
    monkeypatch.setattr(ServeEngine, "_sample", sample)
    monkeypatch.setattr(Model, "decode_paged_fused", decode)


@pytest.mark.parametrize("cell", ["sc2-serve-code", "rwkv6-serve-chat"])
def test_a_served_token_altered_is_not_correct(root, cell, monkeypatch):
    sound = tiny.run_cell(root, cell, seconds=2.0)
    _alter_tokens(monkeypatch, harness.cell_files(cell, root)[2]["vocab"])
    broken = tiny.run_cell(root, cell, seconds=2.0)
    gap = "served_logit_gap"
    assert sound["checks"][gap]["value"] is not None, "nothing finished"
    assert not broken["correct"]
    assert broken["checks"][gap]["value"] > broken["checks"][gap]["limit"]
    assert broken["checks"][gap]["value"] > 3 * sound["checks"][gap]["value"]


@pytest.mark.parametrize("cell", ["sc2-train-4k", "rwkv6-train-4k"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(root, cell, fault):
    ctx = tiny.cell_context(root, cell, seconds=0.5)
    rec = train.run(ctx, fault=fault)
    assert not rec.correct
    over = [n for n, c in rec.checks.items() if c["value"] > c["limit"]]
    assert over, rec.checks
    if fault == "unchanged":
        assert rec.counts["readings"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["sc2-train-4k", "rwkv6-train-4k"])
def test_the_fp8_control_reads_above_the_program_in_training(root, cell):
    ctx = tiny.cell_context(root, cell, seconds=0.5)
    rec = train.run(ctx)
    want = rec.counts["reference"]
    got = ref_train.follow(ctx.arch, ctx.conf, ctx.mix, ctx.seed, ctx.device,
                           train.CHECKED_STEPS, precision="fp8")
    control = train.compare(got["losses"], got["grad1"], got["change"], want)
    program = rec.counts["readings"]
    assert max(control[n] / max(program[n], 1e-12)
               for n in ctx.limits) >= 3.0, (control, program)
    # judged as a run judges the program, by the cell's limits
    assert not harness.judge(control, ctx.limits)[0], (control, ctx.limits)


class _ClockUntil:
    """``serve.py``'s clock in a run that ends once ``n`` requests have
    finished (the cell's warm-up among them), whatever the host's pace: it
    stands still until then, and then reads past any close. The engine
    counts the requests it finishes in through ``finished``."""

    sleep = staticmethod(time.sleep)

    def __init__(self, n):
        self.n, self.finished = n, 0

    def monotonic(self):
        return 0.0 if self.finished < self.n else math.inf


@pytest.mark.parametrize("cell", ["sc2-serve-code", "rwkv6-serve-chat"])
def test_the_fp8_control_reads_above_the_program_in_serving(root, cell,
                                                             monkeypatch):
    """On a fixed sample: the requests a window serves until its 32nd
    finishes, the same on a host under load as on an idle one."""
    from portbench import weights
    from portbench.reference import model as ref
    from repro_torch.serving.engine import ServeEngine
    clock, step = _ClockUntil(32), ServeEngine.step

    def counted(self, params):
        done = step(self, params)
        clock.finished += len(done)
        return done
    monkeypatch.setattr(serve, "time", clock)
    monkeypatch.setattr(ServeEngine, "step", counted)
    ctx = tiny.cell_context(root, cell, seconds=2.0)
    rec = serve.run(ctx, check=False)
    sample = rec.counts["sample"]
    assert clock.finished >= clock.n
    assert len(sample) == ctx.mix["check"]["requests"], "too few finished"
    program = serve._widest_gap(ctx.arch, ctx.conf, ctx.seed, ctx.device,
                                sample)
    gaps = ref.served_gaps(
        ctx.arch, ctx.conf,
        lambda i: weights.make_layer(ctx.arch, ctx.conf, ctx.seed, i,
                                     ctx.device, "serve"),
        serve.reference_top(ctx.arch, ctx.conf, ctx.seed, ctx.device),
        sample, precision="fp8", own_argmax=True)
    control = float(max(g.max() for g in gaps))
    # (a 64-wide model's logits spread too little for the cell's limit:
    # calibrate.py judges the control by it at the cell's size)
    assert control > 3 * program, (control, program)


def test_the_result_line_has_the_contract_keys(root):
    res = tiny.run_cell(root, "sc2-serve-code", trace=1)
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["attempted"] >= 1 and res["failed"] == 0
    for m in res["metrics"].values():
        assert np.isfinite(m["value"]) and m["unit"]
    assert set(res["metrics"]) <= {
        m["name"] for m in harness.load_json(
            tiny.ROOT / "BENCHMARK.json")["per_layer"]}
