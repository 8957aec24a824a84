"""The per-rank op counter (``repro_torch.launch.op_analysis``) and the
kernel ops' meta path.

* Every kernel op on meta tensors gives the CPU plain version's output
  shapes and dtypes, launches nothing and runs no plain version; the
  dot FLOPs it records equal the dots the counter counts through its
  plain version on the CPU (flash and the decode kernels at ≤ 2048
  keys), the WKV's those of the reference's chunked scan as
  ``repro.launch.hlo_analysis`` counts them, and flash's past 2048 keys
  those of the reference's chunked and banded XLA forms (their block
  sizes patched small in both packages).
* The counter against ``hlo_analysis.analyze`` of the reference's
  compiled sharded steps on a (2, 2) mesh of 4 forced host devices (one
  subprocess an arch), the port counted on meta as rank 0 of a
  4-rank ``"fake"`` group (the dry run's way), reduced configs, B=4 and
  S=32. Prefill and decode dot FLOPs agree within 1% for qwen, mixtral,
  internvl2 and whisper; their train steps differ by the forward that
  flash's backward recomputes (the port's ``_Flash.backward``; the
  reference's XLA attention keeps its scores), within 1%.
  recurrentgemma and rwkv6 differ by where GSPMD puts a few small
  products (pinned, see :data:`GSPMD_PLACEMENT`). Collective bytes by
  kind are printed beside the reference's; the port's equal a hand
  reckoning for qwen's prefill.
* The memory reckoning: arguments, outputs, an in-place update counted
  as a donation, peak temporaries.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "recurrentgemma-2b", "rwkv6-7b",
         "internvl2-2b", "whisper-medium")
KINDS = ("prefill", "decode", "train")
B, S = 4, 32

#: port − reference dot FLOPs where GSPMD places small products otherwise
#: than the partition rules, pinned at these shapes. rwkv6: GSPMD splits
#: the contraction of the token-shift LoRA products (``mix_A``,
#: ``mix_B``) and the channel mix over "model" and all-reduces their
#: partial sums (17 all-reduces in its prefill, the port's 3), where the
#: port computes them whole on every rank; recurrentgemma: at decode
#: GSPMD computes the lm head and the FFN's d_ff whole on every rank
#: (its weights all-gathered), the port keeps the rules' blocks, and at
#: prefill XLA's CPU backend leaves the local-attention scores of this
#: one-KV-head layer out of its dots (the port counts flash's record).
GSPMD_PLACEMENT = {
    ("recurrentgemma-2b", "prefill"): 262144,
    ("recurrentgemma-2b", "decode"): -98304,
    ("rwkv6-7b", "prefill"): 3670016,
    ("rwkv6-7b", "decode"): 114688,
    # the prefill's placements, forward and backward, and the WKV's
    # backward: the chunked form recomputed and differentiated in torch
    # ops (the reference differentiates its scan without a recompute)
    ("rwkv6-7b", "train"): 11788288,
}


# ---------------------------------------------------------------------------
# The kernel ops' meta path
# ---------------------------------------------------------------------------


def _rng():
    return np.random.default_rng(0)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _flash(window):
    def make():
        r = _rng()
        q = _t(r.standard_normal((2, 16, 4, 16)))
        k = _t(r.standard_normal((2, 16, 2, 16)))
        v = _t(r.standard_normal((2, 16, 2, 16)))
        return (q, k, v), {"causal": True, "window": window}
    return make


def _ring():
    r = _rng()
    q = _t(r.standard_normal((2, 1, 4, 16)))
    k = _t(r.standard_normal((2, 24, 2, 16)))
    v = _t(r.standard_normal((2, 24, 2, 16)))
    return (q, k, v, torch.tensor(30, dtype=torch.int32)), {"window": 10}


def _paged(fused):
    def make():
        r = _rng()
        q = _t(r.standard_normal((2, 1, 4, 16)))
        kp = _t(r.standard_normal((6, 4, 2, 16)))
        vp = _t(r.standard_normal((6, 4, 2, 16)))
        lengths = torch.tensor([7, 11], dtype=torch.int32)
        bt = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
        if fused:
            kn = _t(r.standard_normal((2, 1, 2, 16)))
            vn = _t(r.standard_normal((2, 1, 2, 16)))
            return (q, kn, vn, kp, vp, lengths, bt), {}
        return (q, kp, vp, lengths), {"block_tables": bt}
    return make


def _sample():
    r = _rng()
    return (_t(r.standard_normal((3, 50))), _t(r.random(3)),
            _t(r.standard_normal((3, 50)))), {}


def _scan():
    r = _rng()
    return (_t(r.random((2, 9, 5))), _t(r.standard_normal((2, 9, 5))),
            _t(r.standard_normal((2, 5)))), {}


def _wkv():
    r = _rng()
    shape = (1, 2, 20, 16)
    return (_t(r.standard_normal(shape)), _t(r.standard_normal(shape)),
            _t(r.standard_normal(shape)), _t(-r.random(shape)),
            _t(r.standard_normal((2, 16))),
            _t(r.standard_normal((1, 2, 16, 16)))), {}


def _matmul():
    r = _rng()
    return (_t(r.standard_normal((5, 7))), _t(r.standard_normal((7, 3)))), {}


def _sobel():
    return (_t(_rng().standard_normal((6, 7))),), {}


def _vecadd():
    r = _rng()
    return (_t(r.standard_normal(10)), _t(r.standard_normal(10))), {}


def _ops():
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.rglru_scan import ops as sc
    from repro_torch.kernels.rwkv6_wkv import ops as wk
    from repro_torch.kernels.sobel import ops as so
    from repro_torch.kernels.vecadd import ops as va
    # name → (module, op, ref names in the module, inputs, kernel name)
    return {
        "flash": (fl, fl.flash_attention_op, ["flash_attention_ref"],
                  _flash(0), fl.NAME),
        "flash_window": (fl, fl.flash_attention_op, ["flash_attention_ref"],
                         _flash(6), fl.NAME),
        "decode_ring": (dec, dec.decode_attention_op,
                        ["decode_attention_ref"], _ring, dec.RING),
        "decode_paged": (dec, dec.decode_attention_op,
                         ["paged_decode_attention_ref"], _paged(False),
                         dec.PAGED),
        "decode_fused": (dec, dec.fused_decode_step_op,
                         ["fused_paged_decode_ref"], _paged(True),
                         dec.DECODE),
        "sample": (dec, dec.sample_tokens_op, ["sample_tokens_ref"],
                   _sample, dec.SAMPLE),
        "scan": (sc, sc.rglru_scan_op, ["rglru_scan_ref"], _scan, sc.NAME),
        "wkv": (wk, wk.rwkv6_wkv_op, ["rwkv6_wkv_ref"], _wkv, wk.NAME),
        "matmul": (mm, mm.matmul_op, ["matmul_ref"], _matmul, mm.NAME),
        "sobel": (so, so.sobel_op, ["sobel_ref"], _sobel, so.NAME),
        "vecadd": (va, va.vecadd_op, ["vecadd_ref"], _vecadd, va.NAME),
    }


OPS = ("flash", "flash_window", "decode_ring", "decode_paged",
       "decode_fused", "sample", "scan", "wkv", "matmul", "sobel", "vecadd")


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def _reference_wkv_flops(shape):
    """hlo_analysis's dot FLOPs of the reference's chunked WKV scan for r
    of the kernel layout ``shape`` (B, H, S, K)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import hlo_analysis
    from repro.models.recurrent import _wkv_chunk_scan
    Bw, H, Sw, K = shape
    f32 = jnp.float32
    args = [jax.ShapeDtypeStruct((Bw, Sw, H, K), f32)] * 4 + [
        jax.ShapeDtypeStruct((H, K), f32),
        jax.ShapeDtypeStruct((Bw, H, K, K), f32)]
    txt = jax.jit(_wkv_chunk_scan).lower(*args).compile().as_text()
    return hlo_analysis.analyze(txt).dot_flops


@pytest.mark.parametrize("name", OPS)
def test_meta_path_matches_the_plain_version(name, monkeypatch):
    from repro_torch.kernels import common
    from repro_torch.launch.op_analysis import OpCounter
    mod, op, refs, make, kernel = _ops()[name]
    args, kw = make()
    with OpCounter(args) as plain:
        want = _flat(op(*args, **kw))
    assert not plain.stats.kernels           # the CPU path records nothing

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta tensors")
    for r in refs:
        monkeypatch.setattr(mod, r, refuse)
    margs = [_meta(a) for a in args]
    mkw = {k: _meta(v) for k, v in kw.items()}
    common.reset_launches()
    with OpCounter(margs) as c:
        got = _flat(op(*margs, **mkw))
    assert not common.LAUNCHES, dict(common.LAUNCHES)
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in got] == \
        [(tuple(t.shape), t.dtype, "meta") for t in want]
    rec = c.stats.kernels[kernel]
    assert rec["calls"] == 1
    ins = [a for a in args if isinstance(a, torch.Tensor)] + \
        [v for v in kw.values() if isinstance(v, torch.Tensor)]
    assert rec["bytes"] == sum(t.numel() * t.element_size()
                               for t in ins + want)
    if name == "wkv":
        assert rec["flops"] == _reference_wkv_flops(args[0].shape)
    else:
        assert rec["flops"] == plain.stats.dot_flops, (rec, plain.stats)
    assert c.stats.dot_flops == rec["flops"]


@pytest.mark.parametrize("window", [0, 24])
def test_flash_flops_past_the_dense_path_follow_the_reference(window,
                                                              monkeypatch):
    """Past ``DIRECT_MAX`` keys the record counts the reference's chunked
    (no window) or banded (window) XLA form: both packages' block sizes
    patched small, the reference's ``attention_core`` compiled and
    counted by ``hlo_analysis``."""
    import jax
    import jax.numpy as jnp

    from repro.launch import hlo_analysis
    from repro.models import attention as ref_attn
    from repro_torch.kernels.flash_attention import ops as fl
    monkeypatch.setattr(ref_attn, "_DIRECT_MAX", 32)
    monkeypatch.setattr(ref_attn, "_CHUNK_Q", 16)
    monkeypatch.setattr(ref_attn, "_CHUNK_K", 16)
    monkeypatch.setattr(fl, "DIRECT_MAX", 32)
    monkeypatch.setattr(fl, "CHUNK_Q", 16)
    Bq, Sq, Hq, Hkv, hd = 2, 64, 4, 2, 16
    pos = jnp.arange(Sq)

    def core(q, k, v):
        return ref_attn.attention_core(q, k, v, causal=True, window=window,
                                       q_pos=pos, k_pos=pos)
    f32 = jnp.float32
    txt = jax.jit(core).lower(
        jax.ShapeDtypeStruct((Bq, Sq, Hq, hd), f32),
        jax.ShapeDtypeStruct((Bq, Sq, Hkv, hd), f32),
        jax.ShapeDtypeStruct((Bq, Sq, Hkv, hd), f32)).compile().as_text()
    jax.clear_caches()
    want = hlo_analysis.analyze(txt).dot_flops
    assert fl.flops((Bq, Sq, Hq, hd), Sq, window) == want


def test_path_refuses_mixed_and_other_devices():
    from repro_torch.kernels import common

    class Fake:
        def __init__(self, dev):
            self.device = torch.device(dev)
    assert common.path(Fake("cpu")) == "cpu"
    assert common.path(Fake("meta"), Fake("meta")) == "meta"
    assert common.path(Fake("cuda:0")) == "cuda"
    with pytest.raises(ValueError, match="several devices"):
        common.path(Fake("cpu"), Fake("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        common.path(Fake("xpu"))


# ---------------------------------------------------------------------------
# The memory reckoning
# ---------------------------------------------------------------------------


def test_memory_reckoning_counts_donation_and_peak():
    from repro_torch.launch.op_analysis import count_step
    x = torch.zeros(256)                   # 1 KiB
    y = torch.ones(512)                    # 2 KiB

    def step(x, y):
        x.add_(1.0)                        # in place: a donation
        t = y * 2.0                        # 2 KiB temporary
        u = t + 1.0                        # 2 KiB temporary, t alive
        del t
        return x, u.sum().reshape(1)       # a 4-byte output
    st = count_step(step, (x, y))
    m = st.memory
    assert m["argument_bytes"] == 1024 + 2048
    assert m["alias_bytes"] == 1024
    assert m["output_bytes"] == 1024 + 4
    assert m["temp_bytes"] == 4096 - 4      # t and u at the peak, beyond u.sum
    assert m["per_device_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                                     + m["output_bytes"] - m["alias_bytes"])
    assert st.dot_flops == 0
    assert st.unknown_trip_whiles == 0
    # reads + writes of add_, mul, add, sum; the reshape is a view
    assert st.mem_bytes == (1024 * 2) + (2048 * 2) + (2048 * 2) + (2048 + 4)


def test_record_round_trip():
    from repro_torch.launch.op_analysis import OpStats, count_step
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    st = count_step(lambda a, b: a @ b, (a, b))
    assert st.dot_flops == 2 * 4 * 8 * 3
    back = OpStats.from_record(json.loads(json.dumps(st.to_record())))
    assert (back.dot_flops, back.mem_bytes) == (st.dot_flops, st.mem_bytes)


# ---------------------------------------------------------------------------
# The counter against the reference's hlo_analysis on a (2, 2) mesh
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent('''
    import json, sys
    import jax
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.launch import hlo_analysis
    from repro.launch.mesh import make_local_mesh
    from repro.parallel import build_step_for_cell
    B, S = int(sys.argv[2]), int(sys.argv[3])
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch, reduced=True)
        mesh = make_local_mesh((2, 2))
        for kind in ("prefill", "decode", "train"):
            step, args = build_step_for_cell(cfg, mesh,
                                             ShapeCell(kind, S, B, kind))
            st = hlo_analysis.analyze(step.lower(*args).compile().as_text())
            out[arch + "/" + kind] = {
                "dot_flops": st.dot_flops,
                "collective_bytes": st.collective_bytes,
                "collective_count": st.collective_count}
    print(json.dumps(out))
''')

PORT = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import make_local_mesh
    B, S = int(sys.argv[2]), int(sys.argv[3])
    mesh = make_local_mesh((2, 2), device_type="cpu")
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch, reduced=True)
        for kind in ("prefill", "decode", "train"):
            st, _, _ = count_cell(cfg, ShapeCell(kind, S, B, kind), mesh)
            out[arch + "/" + kind] = {
                "dot_flops": st.dot_flops,
                "collective_bytes": st.collective_bytes,
                "collective_count": st.collective_count,
                "kernels": st.kernels}
    print(json.dumps(out))
''')


def _start(script, archs, jax_side):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    if jax_side:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", script, ",".join(archs), str(B), str(S)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _result(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def counts():
    """{"ref": {arch/kind: counts}, "port": {...}}, the reference in one
    subprocess an arch."""
    refs = [_start(REFERENCE, (a,), True) for a in ARCHS]
    port = _start(PORT, ARCHS, False)
    got = {"ref": {}, "port": _result(port)}
    for p in refs:
        got["ref"].update(_result(p))
    return got


def _flash_forward(port_cell):
    rec = port_cell["kernels"].get("flash_attention")
    return rec["flops"] if rec else 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_counter_follows_hlo_analysis(counts, arch, kind):
    key = f"{arch}/{kind}"
    got, want = counts["port"][key], counts["ref"][key]
    print(f"{key}: dot FLOPs port {got['dot_flops']} reference "
          f"{want['dot_flops']}; collective bytes port "
          f"{got['collective_bytes']} reference {want['collective_bytes']}; "
          f"calls port {got['collective_count']} reference "
          f"{want['collective_count']}")
    flops = got["dot_flops"]
    if kind == "train":
        # flash's backward recomputes the forward (the kernel's record);
        # the reference's XLA attention keeps what autodiff needs
        flops -= _flash_forward(got)
    pinned = GSPMD_PLACEMENT.get((arch, kind))
    if pinned is not None:
        assert flops - want["dot_flops"] == pinned
    else:
        assert flops == pytest.approx(want["dot_flops"], rel=0.01)


def test_collective_bytes_by_hand(counts):
    """qwen's prefill on (2, 2): the rank's rows (B/2) and all S
    positions in bf16, d_model 64: one all-reduce of the vocab-split
    embedding lookup, then two a layer (attention's and the FFN's
    out-projections over "model"), 2 layers."""
    got = counts["port"]["qwen1.5-0.5b/prefill"]
    row = (B // 2) * S * 64 * 2
    assert got["collective_count"] == {"all-reduce": 1 + 2 * 2}
    assert got["collective_bytes"] == {"all-reduce": (1 + 2 * 2) * row}
