"""Rules of the port: ``paddle_tpu_torch`` (and the chip smoke script)
import nothing of JAX or of the reference package, entry points never
fall back to the CPU on their own, and weights cross by name or not at
all."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import place
from paddle_tpu_torch.models import transformer as port_tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _package_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)[:-3]
            mod = rel.replace(os.sep, ".")
            mods.append(mod[:-len(".__init__")]
                        if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or \
        name == "paddle_tpu" or name.startswith("paddle_tpu.")


def test_import_leaves_jax_and_reference_out():
    """Import every module of the package in a fresh interpreter."""
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "print(bad)\n" % (_package_modules(),))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [os.path.relpath(os.path.join(dp, f), ROOT)
     for dp, _d, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_import_in_source(path):
    path = os.path.join(ROOT, path)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "import_module":
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant)]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (path, names)


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tf.transformer_lm_session(29, max_len=8, slots=1, cache_len=8,
                                       prompt_buckets=(4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        place.resolve_device("cuda")
    assert place.resolve_device("cpu") == torch.device("cpu")


def _named(num_layers=2, d=4):
    rs = np.random.RandomState(0)
    return {n: rs.standard_normal((d, d)).astype(np.float32)
            for n in port_tf.lm_param_names(num_layers)}


def test_params_from_jax_consumes_every_name():
    named = _named()
    got = port_io.params_from_jax(named, device="cpu")
    assert sorted(got) == sorted(named)
    assert all(t.device.type == "cpu" for t in got.values())


@pytest.mark.parametrize("edit", ["missing", "unknown", "missing_final_ln"])
def test_params_from_jax_rejects_mismatched_names(edit):
    named = _named()
    if edit == "missing":
        del named["mha_1.qkv_k.w"]
    elif edit == "unknown":
        named["mha_0.bias"] = np.zeros(4, np.float32)
    else:
        del named["layer_norm_4.w_1"]
    with pytest.raises(ValueError, match="missing|unknown"):
        port_io.params_from_jax(named, device="cpu")


def test_model_load_rejects_wrong_shape():
    model = port_tf.TransformerLM(5, 4, 2, 8, 1, 3, device="cpu")
    params = {n: torch.zeros(tuple(p.shape))
              for n, p in zip(port_tf.lm_param_names(1),
                              [dict(model.named_parameters())[path]
                               for path in port_tf._name_map(1).values()])}
    model.load_params(params)
    params["lm_head.w"] = torch.zeros(5, 4)
    with pytest.raises(ValueError, match="lm_head.w: shape"):
        model.load_params(params)
