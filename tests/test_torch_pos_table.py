"""The sinusoid position table a model without rope holds: made once per
device and dtype, grown only when a longer sequence comes, sliced
otherwise, and the same bits as the table made at each length."""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.layers import dt, sinusoidal_positions

torch.set_num_threads(2)

B = 2
LENGTHS = (16, 40, 8, 40)


def _batch(cfg, S, seed):
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    if cfg.is_encdec:
        fe = cfg.frontend
        b["frames"] = torch.randn(B, fe.n_tokens, fe.d_in, generator=g)
    return b


# whisper's encoder adds its 24 frames' positions first, from the same
# table, before the decoder's S rows
@pytest.mark.parametrize("arch,rows", [
    ("rwkv6-7b", (16, 40, 40, 40)),
    ("whisper-medium", (24, 40, 40, 40))])
def test_held_table_grows_once_and_keeps_the_bits(arch, rows):
    cfg = get_config(arch, reduced=True)
    m = Model(cfg, device="cpu")
    params = m.init_compute_params(torch.Generator().manual_seed(0))
    cd = dt(cfg.compute_dtype)
    D = cfg.d_model
    tables = []
    for i, S in enumerate(LENGTHS):
        b = _batch(cfg, S, i)
        with torch.no_grad():
            x, enc = m._assemble_inputs(params, b)
            want = m._lookup(params, b["tokens"]) \
                + sinusoidal_positions(S, D)[None].to(cd)
            # a model that has seen no other length
            x1, enc1 = Model(cfg, device="cpu")._assemble_inputs(params, b)
        assert x.dtype == cd and torch.equal(x, want), S
        assert torch.equal(x, x1), S
        if cfg.is_encdec:
            assert torch.equal(enc, enc1), S
        (key, table), = m._pos_tables.items()
        assert key == (torch.device("cpu"), cd)
        assert table.dtype == cd and table.shape == (rows[i], D)
        tables.append(table)
    # made at the first call, made anew once (for 40 rows), then sliced
    assert len({id(t) for t in tables}) == 2
    assert tables[1] is tables[2] is tables[3]


def test_held_table_on_meta_is_meta():
    cfg = get_config("rwkv6-7b", reduced=True)
    m = Model(cfg, device="meta")
    x = torch.empty(B, 40, cfg.d_model, dtype=torch.bfloat16, device="meta")
    y = m._add_positions(x)
    assert y.device.type == "meta" and y.shape == x.shape
    (table,) = m._pos_tables.values()
    assert table.device.type == "meta" and table.shape == (40, cfg.d_model)
