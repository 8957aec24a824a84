"""``repro_torch.core.lm_layout_check.verify_layouts`` passes, the
port's arch registry (``configs/archs.py``) holds the reference's
architectures, and every arch's segment layout, full and reduced, is the
reference's entry for entry (the enc-dec decoder's cross attention
included)."""
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.core.lm_layout_check import verify_layouts as jax_verify
from repro.models.lm import build_layout as jax_build_layout
from repro.models.lm import layer_specs as jax_layer_specs
from repro_torch.configs import get_config, list_archs
from repro_torch.core.lm_layout_check import verify_layouts
from repro_torch.models.lm import build_layout, layer_specs


def _plain(layout):
    out = []
    for entry in layout:
        specs = tuple((s.mixer, s.ffn, s.d_ff, s.cross) for s in entry[1])
        out.append((entry[0], specs) + tuple(entry[2:]))
    return out


def test_verify_layouts():
    assert verify_layouts() is True
    assert jax_verify() is True


def test_registry_matches_reference():
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", jax_list_archs())
def test_layout_matches_reference(arch, reduced):
    jcfg = jax_get_config(arch, reduced=reduced)
    want = jax_build_layout(jcfg, jax_layer_specs(jcfg, cross=jcfg.is_encdec))
    cfg = get_config(arch, reduced=reduced)
    assert _plain(build_layout(cfg, layer_specs(cfg))) == _plain(want)
