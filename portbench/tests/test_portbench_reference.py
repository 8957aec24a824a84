"""The plain reference against the program at the port's CPU sizes, the
program computing in fp32: the forward of both architectures, prefill
then paged decode through the serving engine, and a train step's loss
and gradients."""
import dataclasses

import pytest
import torch

import portbench_tiny as tiny
from portbench import harness, weights
from portbench.reference import model as ref
from portbench.reference import ops

torch.set_num_threads(1)
CONFIGS = {"starcoder2-15b": tiny.DENSE, "rwkv6-7b": tiny.RWKV}


def conf_of(name):
    import json
    conf = json.loads((tiny.ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())
    conf.update(CONFIGS[name], port_reduced=True)
    return conf


def port_fp32(conf):
    from repro_torch.models import Model
    cfg = dataclasses.replace(harness.port_config(conf),
                              compute_dtype="float32")
    return Model(cfg, device=torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_the_program(name):
    ops.no_tf32()
    conf = conf_of(name)
    model = port_fp32(conf)
    params = weights.make_tree(conf, 3, torch.device("cpu"), "train")
    tokens = torch.randint(0, conf["vocab"], (1, 40),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": tokens})
    top = {p: weights.get(params, p) for g in weights.top_groups(conf)
           for p, _, _ in weights.top_groups(conf)[g]}
    got = ref.logits_at(
        conf, lambda i: {p: weights.get(params["layers"][i], p)
                         for p, _, _ in weights.layer_spec(conf)},
        top, [tokens[0]], [torch.arange(40)])[0]
    torch.testing.assert_close(got, want[0].float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_then_paged_decode_serves_the_reference_argmax(name):
    """The engine's greedy tokens (monolithic and chunked) are the
    reference's best token at every served position, to fp32 rounding."""
    from repro_torch.serving import ServeEngine
    conf = conf_of(name)
    model = port_fp32(conf)
    cfg = model.cfg
    dev = torch.device("cpu")
    params = weights.make_tree(conf, 4, dev, "train")
    prompts = [list(range(5, 5 + n)) for n in (9, 23, 40)]
    top = {p: weights.get(params, p) for g in weights.top_groups(conf)
           for p, _, _ in weights.top_groups(conf)[g]}

    def layer(i):
        return {p: weights.get(params["layers"][i], p)
                for p, _, _ in weights.layer_spec(conf)}
    for chunk in (0, 16):
        engine = ServeEngine(cfg, model, 2, 96, page_size=16,
                             chunk_tokens=chunk, state_paging=True)
        for p in prompts:
            engine.submit(p, max_new_tokens=12)
        done = engine.run_round(params)
        served = [(r.prompt.tolist(), r.out_tokens) for r in done]
        gaps = ref.served_gaps(conf, layer, top, served)
        assert max(float(g.max()) for g in gaps) < 1e-3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_loss_and_gradients_match_the_program(name):
    from repro_torch import optim
    ops.no_tf32()
    conf = conf_of(name)
    model = port_fp32(conf)
    dev = torch.device("cpu")
    params = weights.make_tree(conf, 5, dev, "train")
    from portbench import generator
    mix = {"batch": 2, "seq_len": 32, "eos": 0,
           "doc_tokens": {"log_mean": 2.0, "log_sigma": 1.0}}
    batch = {k: torch.from_numpy(v) for k, v in
             generator.train_batch(mix, 9, 0, conf["vocab"]).items()}
    loss, _, grads = optim.loss_and_grads(model, params, batch)
    paths = weights.leaf_paths(conf)
    live = {p: weights.get(params, p).detach().clone().requires_grad_()
            for p in paths}
    rloss = ref.loss(conf, live, batch)
    rgrads = torch.autograd.grad(rloss, [live[p] for p in paths])
    torch.testing.assert_close(rloss.detach(), loss, rtol=1e-5, atol=1e-5)
    for p, g in zip(paths, rgrads):
        torch.testing.assert_close(weights.get(grads, p), g, rtol=1e-3,
                                   atol=1e-6)
