"""The architecture families (``portbench/archs/<family>.py``).

What the benchmark reads of the four configurations it had when the
families moved into files of their own is pinned at each family's
``TINY`` size on the CPU: every weight group drawn from a seed, bit for
bit in both modes, the leaves' order, and the FLOP counts as integers
(at the full size too, which every ``mfu.*`` reads). A change to any of
them changes what every cell reads.

And the contract: a family the benchmark has never seen, whose two
kinds of layer alternate by index and one of which has an FFN no cell
runs, is one file under a root of its own; the generic code (weights,
the reference, the counts) runs it as it is. A cell added with a traffic
mix of its own brings the mix's CPU cut in its file."""
import hashlib
import json
import shutil
import textwrap

import pytest
import torch

import portbench_tiny as tiny
from portbench import harness, weights
from portbench.counts import model as counts
from portbench.reference import model as ref

torch.set_num_threads(1)
SEED = 2 ** 31 + 11
POINTS = [(1, 0), (1, 4095), (512, 0), (4096, 0)]
CONFIGS = {c["name"]: c for c in tiny.config_entries()}

_SC2_TINY = dict(
    serve={"tok_embed": "dbe6bf99e8f2d88f", "final_norm": "6ece57b6c91c7365",
           "lm_head": "d14c450085f22289", "layer0": "c85ecbd942638185",
           "layer1": "4b1219674e9e5c8a"},
    train={"tok_embed": "ceb1e67ef917ae4a", "final_norm": "6ece57b6c91c7365",
           "lm_head": "c78d332df6632e47", "layer0": "fd0ab7aa7566b377",
           "layer1": "c96426b9017381fd"},
    leaf_paths=(34, "4bc4037809b583ca"),
    flops_tiny=[238080, 2334720, 188874752, 5269094400],
    train_flops_tiny=15807283200)
_RWKV_TINY = dict(
    serve={"tok_embed": "dbe6bf99e8f2d88f", "final_norm": "6ece57b6c91c7365",
           "lm_head": "d14c450085f22289", "layer0": "18345bcff3952be3",
           "layer1": "1087dce6ccb0798d"},
    train={"tok_embed": "ceb1e67ef917ae4a", "final_norm": "6ece57b6c91c7365",
           "lm_head": "c78d332df6632e47", "layer0": "10c9f870b4bc5424",
           "layer1": "4ac714bd1af524e8"},
    leaf_paths=(52, "c9ea24ac2dbe2baa"),
    flops_tiny=[365056, 365056, 186908672, 1495269376],
    train_flops_tiny=4485808128)
PINNED = {
    "starcoder2-15b": dict(
        _SC2_TINY,
        flops_full=[31307268096, 35332816896, 16157918625792,
                    136478894063616],
        train_flops_full=409436682190848),
    "starcoder2-15b-pp8": dict(
        _SC2_TINY,
        flops_full=[4441890816, 4945084416, 2290322767872, 19224525275136],
        train_flops_full=57673575825408),
    "rwkv6-7b": dict(
        _RWKV_TINY,
        flops_full=[14655422464, 14655422464, 7503576301568,
                    60028610412544],
        train_flops_full=180085831237632),
    "rwkv6-7b-pp4": dict(
        _RWKV_TINY,
        flops_full=[4066508800, 4066508800, 2082052505600, 16656420044800],
        train_flops_full=49969260134400),
}


def _digest(group):
    h = hashlib.sha256()
    for path, t in group.items():
        h.update(repr((path, str(t.dtype), tuple(t.shape))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def test_the_pinned_configurations_are_in_the_benchmark():
    assert set(PINNED) <= set(CONFIGS)


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("name", sorted(PINNED))
def test_weight_groups_are_pinned(name, mode):
    arch, conf = tiny.tiny_conf(CONFIGS[name])
    dev = torch.device("cpu")
    got = {g: _digest(weights.make_top(arch, conf, SEED, g, dev, mode))
           for g in arch.top_groups(conf)}
    for i in range(conf["n_layers"]):
        got[f"layer{i}"] = _digest(
            weights.make_layer(arch, conf, SEED, i, dev, mode))
    assert got == PINNED[name][mode]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_leaf_paths_are_pinned(name):
    arch, conf = tiny.tiny_conf(CONFIGS[name])
    paths = weights.leaf_paths(arch, conf)
    assert (len(paths), hashlib.sha256(repr(paths).encode()).hexdigest()[
        :16]) == PINNED[name]["leaf_paths"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_flop_counts_are_pinned(name):
    arch, conf = tiny.tiny_conf(CONFIGS[name])
    full = harness.load_json(tiny.ROOT / CONFIGS[name]["file"])
    want = PINNED[name]
    for size, c in (("tiny", conf), ("full", full)):
        assert [counts.forward_flops(arch, c, n, s) for n, s in POINTS] \
            == want[f"flops_{size}"]
        assert counts.train_flops(arch, c, 4096) \
            == want[f"train_flops_{size}"]


def test_a_missing_family_names_its_file(tmp_path):
    with pytest.raises(harness.RunError, match=r"archs/nosuch\.py"):
        harness.load_arch("nosuch", tmp_path)


TOY = '''
"""A toy family: even layers attend (LayerNorm, rotary MHA, a SwiGLU
FFN), odd layers mix the previous token in (LayerNorm, a token shift, a
GELU FFN); a final LayerNorm and an untied head."""
import torch

from portbench.reference import ops
from portbench.weights import layer_norm, layer_norm_top, normal

FP32_LEAVES = ("scale", "bias")


def layer_spec(conf, i):
    d, ff, H, hd = conf["d_model"], conf["d_ff"], conf["n_heads"], \\
        conf["d_head"]
    out = layer_norm("norm1", d) + layer_norm("norm2", d)
    if i % 2 == 0:
        out += [(("mixer", w), (d, H * hd), normal(d ** -0.5))
                for w in ("wq", "wk", "wv")]
        out += [(("mixer", "wo"), (H * hd, d), normal(d ** -0.5)),
                (("ffn", "w_gate"), (d, ff), normal(d ** -0.5)),
                (("ffn", "w_up"), (d, ff), normal(d ** -0.5)),
                (("ffn", "w_down"), (ff, d), normal(ff ** -0.5))]
    else:
        out += [(("mixer", "w_shift"), (d, d), normal(d ** -0.5)),
                (("ffn", "w_up"), (d, ff), normal(d ** -0.5)),
                (("ffn", "w_down"), (ff, d), normal(ff ** -0.5))]
    return out


top_groups = layer_norm_top


def layer(conf, i, p, x, precision):
    T, d = x.shape
    H, hd = conf["n_heads"], conf["d_head"]

    def lin(a, *path):
        return ops.linear(a, ops.f32(p, *path), precision)
    h = ops.layer_norm(x, ops.f32(p, "norm1", "scale"),
                       ops.f32(p, "norm1", "bias"), conf["norm_eps"])
    if i % 2 == 0:
        pos = torch.arange(T, device=x.device)
        q, k, v = (lin(h, "mixer", w).reshape(T, H, hd)
                   for w in ("wq", "wk", "wv"))
        q, k = ops.rope(q, pos, 10000.0), ops.rope(k, pos, 10000.0)
        o = ops.causal_attention(q, k, v).reshape(T, H * hd)
        x = x + lin(o, "mixer", "wo")
    else:
        prev = torch.cat([h.new_zeros(1, d), h[:-1]])
        x = x + lin(prev - h, "mixer", "w_shift")
    h2 = ops.layer_norm(x, ops.f32(p, "norm2", "scale"),
                        ops.f32(p, "norm2", "bias"), conf["norm_eps"])
    if i % 2 == 0:
        u = ops.silu(lin(h2, "ffn", "w_gate")) * lin(h2, "ffn", "w_up")
    else:
        u = ops.gelu_tanh(lin(h2, "ffn", "w_up"))
    return x + lin(u, "ffn", "w_down")


def embed(conf, top, tokens, precision):
    return ops.f32(top, "tok_embed")[tokens]


def head(conf, top, x, precision):
    return ops.layer_norm_head(top, x, conf["norm_eps"], precision)


def top_matmul_weights(conf):
    return conf["d_model"] * conf["vocab"]


def layer_matmul_weights(conf, i):
    d, ff, Hd = conf["d_model"], conf["d_ff"], \\
        conf["n_heads"] * conf["d_head"]
    return 4 * d * Hd + 3 * d * ff if i % 2 == 0 else d * d + 2 * d * ff


def layer_context_flops(conf, i, n_tokens, start):
    keys = n_tokens * start + n_tokens * (n_tokens + 1) // 2
    return 4 * conf["n_heads"] * conf["d_head"] * keys if i % 2 == 0 else 0
'''


@pytest.fixture()
def toy(tmp_path):
    (tmp_path / "portbench" / "archs").mkdir(parents=True)
    (tmp_path / "portbench" / "archs" / "toy.py").write_text(
        textwrap.dedent(TOY))
    conf = dict(name="toy-4l", family="toy", n_layers=4, d_model=32,
                n_heads=4, d_head=8, d_ff=48, vocab=64, norm_eps=1e-5)
    return harness.load_arch(conf["family"], tmp_path), conf


def test_a_new_family_runs_from_its_own_file(toy):
    arch, conf = toy
    dev = torch.device("cpu")
    tree = weights.make_tree(arch, conf, 7, dev, "serve")
    assert set(tree["layers"][0]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert set(tree["layers"][1]["ffn"]) == {"w_up", "w_down"}
    assert tree["layers"][2]["mixer"]["wq"].dtype == torch.bfloat16
    assert tree["final_norm"]["scale"].dtype == torch.float32
    paths = weights.leaf_paths(arch, conf)
    assert len(paths) == 4 + 2 * 11 + 2 * 7
    for p in paths:
        weights.get(tree, p)

    top = {p: weights.get(tree, p) for p in paths if p[0] != "layers"}

    def layer(i):
        return {p[2:]: weights.get(tree, p) for p in paths
                if p[0] == "layers" and p[1] == i}
    seq = torch.arange(20) % conf["vocab"]
    logits = ref.logits_at(arch, conf, layer, top, [seq],
                           [torch.arange(20)])[0]
    assert logits.shape == (20, conf["vocab"])
    assert torch.isfinite(logits).all()
    # a served token that is the reference's own argmax reads no gap
    best = ref.logits_at(arch, conf, layer, top, [seq[:8]],
                         [torch.arange(7, 8)])[0].argmax(-1).tolist()
    gaps = ref.served_gaps(arch, conf, layer, top, [(seq[:8].tolist(), best)])
    assert float(gaps[0].max()) == 0.0

    # the training reference's loss and gradients, every leaf reached
    train = weights.make_tree(arch, conf, 7, dev, "train")
    live = {p: weights.get(train, p).detach().clone().requires_grad_()
            for p in paths}
    batch = {"tokens": seq[None], "labels": seq.roll(-1)[None],
             "mask": torch.ones(1, 20)}
    loss = ref.loss(arch, conf, live, batch)
    grads = torch.autograd.grad(loss, [live[p] for p in paths])
    assert torch.isfinite(loss) and all(g.abs().sum() > 0 for g in grads)


def test_a_new_family_counts_its_flops_by_layer(toy):
    arch, conf = toy
    d, ff, Hd, V = 32, 48, 32, 64
    w = 2 * (4 * d * Hd + 3 * d * ff) + 2 * (d * d + 2 * d * ff) + d * V
    assert counts.matmul_weights(arch, conf) == w
    n, start = 5, 11
    keys = n * start + n * (n + 1) // 2
    assert counts.forward_flops(arch, conf, n, start) \
        == 2 * w * n + 2 * 4 * Hd * keys
    assert counts.train_flops(arch, conf, n) \
        == 3 * counts.forward_flops(arch, conf, n)


def test_a_new_cell_brings_its_own_cpu_cut(tmp_path, monkeypatch):
    """A cell added with a traffic file of its own (and its limits and
    entries) runs in the tests' tiny copy: the file's ``tiny`` entry cuts
    it, and no file of the benchmark is edited."""
    src = tmp_path / "src"
    shutil.copytree(tiny.ROOT / "portbench", src / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = src / "portbench" / "traffic"
    limits = src / "portbench" / "limits"
    mix = json.loads((traffic / "chat_closed.json").read_text())
    mix["tiny"] = dict(tiny.MIXES["chat_closed"], clients=3)
    (traffic / "chat_new.json").write_text(json.dumps(mix))
    shutil.copy(limits / "rwkv6-serve-chat.json", limits / "rwkv6-new.json")
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    chat = next(w for w in bench["workloads"]
                if w["name"] == "rwkv6-serve-chat")
    bench["workloads"].append(dict(chat, name="rwkv6-new",
                                   traffic="chat_new"))
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(tiny, "ROOT", src)
    root = tiny.make_root(tmp_path / "tiny")
    cut = json.loads((root / "portbench" / "traffic" / "chat_new.json")
                     .read_text())
    assert cut["clients"] == 3
    out = tiny.run_cell(root, "rwkv6-new", seconds=1.0)
    assert out["attempted"] > 0
    assert out["checks"]["served_logit_gap"]["value"] is not None
