"""The work counts behind the rooflines and the model FLOPs, on shapes
checked by hand and, for every configuration of BENCHMARK.json, the
properties any family's counts keep; and the arithmetic of the
metrics."""
import math
import types

import pytest

import portbench_tiny as tiny
from portbench import harness, readers
from portbench.counts import attention, model, peaks, wkv

CONFIGS = {c["name"]: c for c in tiny.config_entries()}


def full(name):
    """A configuration file as it runs, with its family's module."""
    conf = harness.load_json(tiny.ROOT / CONFIGS[name]["file"])
    return harness.load_arch(conf["family"]), conf


SC2_ARCH, SC2 = full("starcoder2-15b")
RWKV_ARCH, RWKV = full("rwkv6-7b")


def test_causal_gqa_by_hand():
    # 1 row, 4 tokens: 10 (query, key) pairs; 2 q heads of 8, 1 kv head
    assert attention.causal_gqa(1, 4, 2, 1, 8) == (4 * 2 * 8 * 10,
                                                   2 * 4 * 8 * (4 + 2))


def test_wkv_by_hand():
    f, b = wkv.forward(1, 2, 3, 4)
    assert f == 2 * 3 * (5 * 16 + 16)
    assert b == 4 * (5 * 2 * 3 * 4 + 8 + 2 * 2 * 16)


def test_model_weights_and_flops():
    # StarCoder2-15B's product weights: 15.4 B in the layers, the head
    a = SC2_ARCH
    w = model.matmul_weights(a, SC2)
    layer = 2 * 6144 * 6144 + 2 * 6144 * 512 + 2 * 6144 * 24576
    assert w == 40 * layer + 6144 * 49152
    assert model.forward_flops(a, SC2, 1, 0) == 2 * w + 4 * 48 * 128 * 40
    # a prefill of n tokens: Σ (p + 1) keys over p < n
    n = 1000
    assert model.forward_flops(a, SC2, n) == 2 * w * n \
        + 4 * 48 * 128 * 40 * n * (n + 1) // 2
    # the decode at position p reads p + 1 keys
    assert model.forward_flops(a, SC2, 1, 99) \
        - model.forward_flops(a, SC2, 1, 0) == 4 * 48 * 128 * 40 * 99
    assert model.train_flops(a, SC2, 10) \
        == 3 * model.forward_flops(a, SC2, 10)
    a = RWKV_ARCH
    r = model.matmul_weights(a, RWKV)
    assert 7.0e9 < r < 7.6e9
    # the LoRA ranks come from the file: the published 7B's 64 and 128
    wide = dict(RWKV, lora_mix_rank=64, lora_decay_rank=128)
    assert model.matmul_weights(a, wide) - r == 32 * (10 * 4096 * 32
                                                      + 2 * 4096 * 64)
    assert model.forward_flops(a, RWKV, 2, 5) \
        == model.forward_flops(a, RWKV, 2)


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_family_counts_chunks_as_the_whole(name, size):
    """A prefill split into chunks counts what it counts whole; a decode
    token's work never falls with its position; the products are the
    floor of the forward; training is three forwards."""
    arch, conf = full(name) if size == "full" else \
        tiny.tiny_conf(CONFIGS[name])

    def fwd(n, start=0):
        return model.forward_flops(arch, conf, n, start)
    assert fwd(4096) == fwd(1000) + fwd(3096, 1000) \
        == fwd(512) + fwd(512, 512) + fwd(3072, 1024)
    assert fwd(1, 0) <= fwd(1, 1) <= fwd(1, 4095)
    assert fwd(7) >= 2 * model.matmul_weights(arch, conf) * 7
    assert model.train_flops(arch, conf, 4096) == 3 * fwd(4096)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_decode_call_counts_each_live_slot_at_its_position(name):
    """The serving driver's count of a decode call: every live slot's
    token at its own position, empty slots left out; for these families
    the same integer as the first token's count plus a per-position step
    times the positions' sum."""
    import numpy as np
    from portbench.drivers import serve
    arch, conf = full(name)
    calls = serve.Calls(arch, conf, None, False)
    live = [0, 4095, 17, 17]
    calls.engine = types.SimpleNamespace(
        positions=np.array([-1] + live[:2] + [-1] + live[2:]))
    n, flops = calls._work("decode_paged_fused", ())
    f0 = model.forward_flops(arch, conf, 1, 0)
    f1 = model.forward_flops(arch, conf, 1, 1) - f0
    assert n == 4
    assert flops == sum(model.forward_flops(arch, conf, 1, p) for p in live) \
        == 4 * f0 + f1 * sum(live)


def test_bound_picks_the_longer_of_the_two():
    assert peaks.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 0.0, peaks.FP32_FLOPS) == pytest.approx(1.0)


def test_quantile_counts_every_request_and_the_missing():
    v = list(range(1, 101))
    assert harness.quantile(v, 0.9) == 90
    assert harness.quantile(v, 0.95) == 95
    assert harness.quantile(v[:95] + [math.inf] * 5, 0.95) == 95
    assert harness.quantile(v[:94] + [math.inf] * 6, 0.95) == math.inf


def test_judge_fails_missing_and_large_readings():
    lim = {"a": {"limit": 1.0}, "b": {"limit": 2.0}}
    assert harness.judge({"a": 0.5, "b": 2.0}, lim)[0]
    assert not harness.judge({"a": 0.5, "b": 2.1}, lim)[0]
    assert not harness.judge({"a": 0.5}, lim)[0]
    assert not harness.judge({"a": math.nan, "b": 0.0}, lim)[0]


class _Trace:
    def __init__(self, kernels, h0, h1):
        from portbench.trace import Spans, TraceSummary
        self.s = TraceSummary(kernels, h0, h1, Spans(True), None)


def _rec(trace=None, **counts):
    ctx = types.SimpleNamespace(conf=SC2, seconds=10.0,
                                mix={"batch": 1, "seq_len": 4096})
    return types.SimpleNamespace(trace=trace, counts=counts, ctx=ctx,
                                 notes=[])


def test_idle_share_and_busy_from_the_trace():
    tr = _Trace([("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)],
                0.0, 10.0).s
    assert tr.busy_s == pytest.approx(3.0)
    assert readers.idle_share(_rec(tr)) == pytest.approx(70.0)
    assert tr.device_ops() == [["k", pytest.approx(3.5)]]


def test_roofline_share_from_kernel_time():
    f, b = attention.causal_gqa(1, 4096, 48, 4, 128)
    least = peaks.bound_s(f, b)
    tr = _Trace([("flash_fwd_wg_kernel", 0.0, 2 * least),
                 ("flash_fwd_wg_kernel", 1.0, 1.0 + 2 * least)], 0.0, 2.0).s
    import importlib.util
    from pathlib import Path
    path = Path(readers.__file__).parent / "metrics" / \
        "flash_roofline.train.py"
    spec = importlib.util.spec_from_file_location("fr_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(_rec(tr)) == pytest.approx(50.0)
    assert mod.read(_rec(_Trace([], 0.0, 1.0).s)) is None


def test_rates_and_tax_over_the_window():
    rec = _rec(flops=989e12 * 2.0, window=(0.0, 10.0),
               step_ends=[1.0, 4.0, 12.0], tax=[1e-4, 3e-4])
    assert readers.mfu_window(rec) == pytest.approx(50.0)
    assert readers.vmm_tax_us(rec) == pytest.approx(200.0)
    rec = _rec(steps=[(0.0, 1.0, 5), (2.0, 3.0, 9)], flops=989e12)
    assert readers.mfu_busy_steps(rec) == pytest.approx(50.0)
    assert readers.engine_step_ms(rec) == pytest.approx(5000.0)
