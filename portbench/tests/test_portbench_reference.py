"""The plain reference against the program at the port's CPU sizes, the
program computing in fp32: for every configuration of BENCHMARK.json at
its family's ``TINY`` widths, the forward, prefill then paged decode
through the serving engine, and a train step's loss and gradients."""
import dataclasses

import pytest
import torch

import portbench_tiny as tiny
from portbench import harness, weights
from portbench.reference import model as ref
from portbench.reference import ops

torch.set_num_threads(1)
CONFIGS = {c["name"]: c for c in tiny.config_entries()}


def port_fp32(arch, conf):
    from repro_torch.models import Model
    cfg = dataclasses.replace(harness.port_config(arch, conf),
                              compute_dtype="float32")
    return Model(cfg, device=torch.device("cpu"))


def top_and_layers(arch, conf, params):
    """The reference's view of a tree: the leaves outside the layers, and
    layer i's ``{path: tensor}``."""
    top = {p: weights.get(params, p)
           for spec in arch.top_groups(conf).values() for p, _, _ in spec}

    def layer(i):
        return {p: weights.get(params["layers"][i], p)
                for p, _, _ in arch.layer_spec(conf, i)}
    return top, layer


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_the_program(name):
    ops.no_tf32()
    arch, conf = tiny.tiny_conf(CONFIGS[name])
    model = port_fp32(arch, conf)
    params = weights.make_tree(arch, conf, 3, torch.device("cpu"), "train")
    tokens = torch.randint(0, conf["vocab"], (1, 40),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": tokens})
    top, layer = top_and_layers(arch, conf, params)
    got = ref.logits_at(arch, conf, layer, top, [tokens[0]],
                        [torch.arange(40)])[0]
    torch.testing.assert_close(got, want[0].float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_then_paged_decode_serves_the_reference_argmax(name):
    """The engine's greedy tokens (monolithic and chunked) are the
    reference's best token at every served position, to fp32 rounding."""
    from repro_torch.serving import ServeEngine
    arch, conf = tiny.tiny_conf(CONFIGS[name])
    model = port_fp32(arch, conf)
    cfg = model.cfg
    dev = torch.device("cpu")
    params = weights.make_tree(arch, conf, 4, dev, "train")
    prompts = [list(range(5, 5 + n)) for n in (9, 23, 40)]
    top, layer = top_and_layers(arch, conf, params)
    for chunk in (0, 16):
        engine = ServeEngine(cfg, model, 2, 96, page_size=16,
                             chunk_tokens=chunk, state_paging=True)
        for p in prompts:
            engine.submit(p, max_new_tokens=12)
        done = engine.run_round(params)
        served = [(r.prompt.tolist(), r.out_tokens) for r in done]
        gaps = ref.served_gaps(arch, conf, layer, top, served)
        assert max(float(g.max()) for g in gaps) < 1e-3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_loss_and_gradients_match_the_program(name):
    from repro_torch import optim
    ops.no_tf32()
    arch, conf = tiny.tiny_conf(CONFIGS[name])
    model = port_fp32(arch, conf)
    dev = torch.device("cpu")
    params = weights.make_tree(arch, conf, 5, dev, "train")
    from portbench import generator
    mix = {"batch": 2, "seq_len": 32, "eos": 0,
           "doc_tokens": {"log_mean": 2.0, "log_sigma": 1.0}}
    batch = {k: torch.from_numpy(v) for k, v in
             generator.train_batch(mix, 9, 0, conf["vocab"]).items()}
    loss, _, grads = optim.loss_and_grads(model, params, batch)
    paths = weights.leaf_paths(arch, conf)
    live = {p: weights.get(params, p).detach().clone().requires_grad_()
            for p in paths}
    rloss = ref.loss(arch, conf, live, batch)
    rgrads = torch.autograd.grad(rloss, [live[p] for p in paths])
    torch.testing.assert_close(rloss.detach(), loss, rtol=1e-5, atol=1e-5)
    for p, g in zip(paths, rgrads):
        torch.testing.assert_close(weights.get(grads, p), g, rtol=1e-3,
                                   atol=1e-6)
