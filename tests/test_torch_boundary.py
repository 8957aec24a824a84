"""The port's boundary: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``repro``; its configs equal the reference's field
by field (minus ``use_pallas``); parameters cross from JAX and back
byte-exactly; entry points never fall back to the CPU unasked."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import Model

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


EXAMPLES = sorted(os.path.join(ROOT, "examples", f)
                  for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.startswith("torch_") and f.endswith(".py"))


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_examples_import_no_jax_or_repro(path):
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib",
                                                      "repro")}
    assert not bad, f"{path} imports {bad}"


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib",
                                                      "repro")}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("sub", ["core", "checkpointing", "parallel",
                                 "optim", "data",
                                 os.path.join("launch", "apps.py"),
                                 os.path.join("launch", "serve.py"),
                                 os.path.join("launch", "train.py")])
def test_boundary_checks_cover_the_virtualization_slice(sub):
    """The AST walk and the fresh-interpreter import below reach the
    VMM's subpackages, the training path and the entry points."""
    files = [os.path.relpath(p, PORT) for p in _port_files() if p != SMOKE]
    assert any(f == sub or f.startswith(sub + os.sep) for f in files), sub


def test_import_pulls_in_no_jax():
    """Importing every port module (and the entry points) in a fresh
    interpreter loads neither jax nor repro."""
    mods = sorted(
        "repro_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for p in _port_files() if p != SMOKE)
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n"
                      for m in mods)
            + "import repro_torch.launch.serve\n"
            "import repro_torch.launch.apps\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.core.vmm\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_reference(reduced):
    want = dataclasses.asdict(jax_get_config("qwen1.5-0.5b",
                                             reduced=reduced))
    got = dataclasses.asdict(get_config("qwen1.5-0.5b", reduced=reduced))
    assert want.pop("use_pallas") is False
    assert got == want
    cfg = get_config("qwen1.5-0.5b", reduced=reduced)
    assert cfg.padded_vocab == jax_get_config(
        "qwen1.5-0.5b", reduced=reduced).padded_vocab


def test_full_config_is_qwen_at_full_width():
    cfg = get_config("qwen1.5-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.padded_vocab,
            cfg.qkv_bias, cfg.rope_theta) == (
        24, 1024, 16, 16, 64, 2816, 151936, 152064, True, 1e6)


def test_param_round_trip_is_byte_exact():
    cfg = jax_get_config("qwen1.5-0.5b", reduced=True)
    tree = jax.device_get(jax_build_model(cfg).init(jax.random.PRNGKey(2)))
    back = params_to_numpy(params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_port_init_matches_reference_shapes():
    """The port's own init (chip_smoke.py has no JAX) makes the
    reference's shapes and dtypes, and its scales to within sampling
    noise."""
    cfg = jax_get_config("qwen1.5-0.5b", reduced=True)
    tree = jax.device_get(jax_build_model(cfg).init(jax.random.PRNGKey(2)))
    m = Model(get_config("qwen1.5-0.5b", reduced=True), device="cpu")
    mine = params_to_numpy(m.init(torch.Generator().manual_seed(0)))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(mine)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(b.std(), a.std(), rtol=0.2, atol=1e-6,
                                   err_msg=str(path))


def test_entry_points_need_a_device(monkeypatch):
    """No device given and no CUDA → raise, never run on the CPU."""
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("qwen1.5-0.5b", reduced=True))


def test_serve_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                      "3", "--prompt-len", "9", "--chunk-tokens", "8"])
    assert eng.stats.completed == 3 and eng.stats.full_prefills == 0
    assert "full=0" in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    device, and also when it is copied away from the repository."""
    script = SMOKE
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
