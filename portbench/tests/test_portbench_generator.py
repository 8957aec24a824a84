"""The traffic generator: the same seed gives the same inputs, and every
seed the same sizes in another order."""
import json

import numpy as np
import pytest

import portbench_tiny as tiny
from portbench import generator

MIXES = {n: json.loads((tiny.ROOT / "portbench" / "traffic"
                        / f"{n}.json").read_text())
         for n in ("code_completion", "chat_closed", "packed_4k")}
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, 4_100_000_000])
def test_open_arrivals_repeat_per_seed_and_keep_their_sizes(seed):
    # the code mix's sizes offered in an open loop, as knee.py sweeps them
    mix = dict(MIXES["code_completion"], loop="open", rate_per_s=5.0)
    a = generator.open_arrivals(mix, seed, 40.0)
    assert a == generator.open_arrivals(mix, seed, 40.0)
    other = generator.open_arrivals(mix, seed + 1, 40.0)
    assert a != other
    assert sorted(p for _, p, _ in a) == sorted(p for _, p, _ in other)
    assert sorted(o for _, _, o in a) == sorted(o for _, _, o in other)
    assert len(a) == round(mix["rate_per_s"] * 40.0)
    due = [t for t, _, _ in a]
    assert due == sorted(due) and 0 < due[0] and due[-1] < 40.0
    lo, hi = mix["prompt_tokens"]
    assert all(lo <= p <= hi for _, p, _ in a)
    # the whole context stays within the published sliding window
    assert max(p + o for _, p, o in a) <= 4096


def test_log_uniform_quantiles():
    # 16 · 8^q at q = 1/6, 1/2, 5/6: 22.6, 45.3, 90.5
    v = generator.log_uniform(16, 128, 3)
    assert v.tolist() == [23, 45, 91]


def test_closed_pool_and_request_tokens():
    mix = MIXES["chat_closed"]
    a, b = generator.closed_pool(mix, BIG), generator.closed_pool(mix, 3)
    assert len(a) == mix["pool"] and a != b
    for i in (0, 1):
        assert sorted(x[i] for x in a) == sorted(x[i] for x in b)
    t = generator.request_tokens(BIG, 5, 100, 65536)
    assert (t == generator.request_tokens(BIG, 5, 100, 65536)).all()
    assert t.min() >= 0 and t.max() < 65536 and len(t) == 100


def test_closed_pool_blocks_hold_the_same_sizes_on_every_seed():
    mix = MIXES["code_completion"]
    k = mix["pool_block"]
    a, b = generator.closed_pool(mix, BIG), generator.closed_pool(mix, 3)
    assert len(a) == mix["pool"] and a != b
    for at in range(0, mix["pool"], k):
        for i in (0, 1):
            assert sorted(x[i] for x in a[at:at + k]) \
                == sorted(x[i] for x in b[at:at + k])
    # the whole context stays within the published sliding window
    assert max(p + o for p, o in a) <= 4096


@pytest.mark.parametrize("step", [0, 3])
def test_train_batch(step):
    mix = MIXES["packed_4k"]
    b = generator.train_batch(mix, BIG, step, 49152)
    again = generator.train_batch(mix, BIG, step, 49152)
    assert all((b[k] == again[k]).all() for k in b)
    assert b["tokens"].shape == (1, 4096) == b["labels"].shape
    assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()
    eos = b["tokens"] == mix["eos"]
    assert 1 <= eos.sum() <= 40
    assert (b["mask"][eos] == 0).all() and (b["mask"][~eos] == 1).all()
    other = generator.train_batch(mix, BIG, step + 1, 49152)
    assert not np.array_equal(b["tokens"], other["tokens"])
