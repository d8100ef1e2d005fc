"""Rules of the port: ``paddle_tpu_torch`` (and the chip smoke script)
import nothing of JAX or of the reference package, entry points never
fall back to the CPU on their own, and weights cross by name or not at
all."""

import ast
import io
import os
import re
import subprocess
import sys
import tokenize

import numpy as np
import pytest
import torch

from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import place
from paddle_tpu_torch.models import transformer as port_tf
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

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


def test_the_walk_covers_the_fleet_tier():
    """The fleet tier's modules and its member probe are among the
    modules the import walk and the source scan below cover."""
    mods = _package_modules()
    for name in ("serving.wire", "serving.fleet", "serving.autoscale",
                 "serving.model_paging", "probes.fleet_worker"):
        assert "paddle_tpu_torch." + name in mods, name


def test_the_walk_covers_the_op_tail():
    """The op tail's modules (the detection, misc and legacy ops, their
    layers, the evaluators and the image recipes) are among the modules
    the import walk and the source scan below cover."""
    mods = _package_modules()
    for name in ("ops.detection_ops", "ops.misc_ops", "ops.legacy_tail_ops",
                 "layers.detection", "layers.legacy", "evaluator",
                 "models.ssd", "models.alexnet", "models.vgg",
                 "models.googlenet", "models.smallnet"):
        assert "paddle_tpu_torch." + name in mods, name


def test_the_walk_covers_the_measurement_probes():
    """The measurement probes ported from the reference's ``tools/`` are
    among the modules the import walk and the source scan below cover."""
    mods = _package_modules()
    for name in ("pipeline", "mfu", "rn50_raw", "layout", "quant_matmul",
                 "trace", "paged_cache", "generate", "decode_policy"):
        assert "paddle_tpu_torch.probes." + name in mods, name


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


def test_paged_session_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tf.transformer_lm_session(29, max_len=8, slots=1, cache_len=8,
                                       prompt_buckets=(4,), paged=True,
                                       block_size=4, prefix_cache=True)


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


def test_resnet_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.models import resnet as port_resnet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_resnet.resnet_imagenet(18)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_resnet.resnet_cifar10(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_resnet.resnet_imagenet(18, device="cuda")


def _resnet_scope(model, opt):
    named = {n: np.zeros(tuple(t.shape), np.float32)
             for n, t in model.reference_tensors().items()}
    named.update({n: np.zeros(tuple(v.shape), np.float32)
                  for n, v in opt.accumulators().items()})
    named["learning_rate_0"] = np.float32([0.25])
    return named


@pytest.mark.parametrize("edit", ["missing", "unknown", "velocity",
                                  "shape", "no_optimizer"])
def test_params_from_jax_rejects_mismatched_resnet_names(edit):
    from paddle_tpu_torch import optimizer as port_opt
    from paddle_tpu_torch.models import resnet as port_resnet
    port_config.set_flags(fused_conv_bn=True)
    try:
        model = port_resnet.resnet_cifar10(8, device="cpu")
    finally:
        port_config.set_flags(fused_conv_bn=False)
    opt = port_opt.Momentum(model.reference_parameters(), 0.1)
    named = _resnet_scope(model, opt)
    got = port_io.params_from_jax(dict(named), model=model, optimizer=opt)
    assert sorted(got) == sorted(named) and opt.learning_rate == 0.25
    assert not model.stem.scale.any()
    optimizer = opt
    named = {n: v + 1 for n, v in named.items()}
    if edit == "missing":
        del named["conv2d_bn_3.global_1"]
    elif edit == "unknown":
        named["conv2d_bn_99.w_0"] = np.zeros(3, np.float32)
    elif edit == "velocity":
        del named["fc_0.w_1_velocity_acc_0"]
    elif edit == "shape":
        named["fc_0.w_0"] = np.zeros((10, 64), np.float32)
    else:
        optimizer = None
    with pytest.raises(ValueError, match="missing|unknown|shape"):
        port_io.params_from_jax(named, model=model, optimizer=optimizer)
    # refused before anything is copied: the model and the learning rate
    # keep what the first load gave them, not the ones of the second
    assert opt.learning_rate == 0.25
    assert all(not t.any() for t in model.reference_tensors().values())


def test_params_from_jax_resnet_refuses_a_device():
    from paddle_tpu_torch import optimizer as port_opt
    from paddle_tpu_torch.models import resnet as port_resnet
    model = port_resnet.resnet_cifar10(8, device="cpu")
    opt = port_opt.Momentum(model.reference_parameters(), 0.1)
    with pytest.raises(ValueError, match="device"):
        port_io.params_from_jax(_resnet_scope(model, opt), device="cpu",
                                model=model, optimizer=opt)


def test_import_rule_covers_the_training_modules():
    """The modules of the LM's training path are among those the import
    rule parses and imports."""
    mods = _package_modules()
    for mod in ("paddle_tpu_torch.amp", "paddle_tpu_torch.probes.flash",
                "paddle_tpu_torch.optimizer", "paddle_tpu_torch.trainer"):
        assert mod in mods


def test_lm_training_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tf.TransformerLM(29, 8, 2, 16, 1, 8)
    from paddle_tpu_torch.probes import flash
    assert flash.main(["--mode", "sweep"]) == 1


def _lm_scope(model, opt):
    named = {n: np.zeros(tuple(t.shape), np.float32)
             for n, t in model.reference_tensors().items()}
    named.update({n: np.zeros(tuple(v.shape), np.float32)
                  for n, v in opt.accumulators().items()})
    named["learning_rate_0"] = np.float32([0.5])
    return named


@pytest.mark.parametrize("edit", ["missing", "unknown", "moment", "pow",
                                  "shape", "no_optimizer"])
def test_params_from_jax_rejects_mismatched_lm_adam_names(edit):
    from paddle_tpu_torch import optimizer as port_opt
    model = port_tf.TransformerLM(29, 8, 2, 16, 2, 8, device="cpu")
    opt = port_opt.Adam(model.reference_parameters(), 0.1)
    named = _lm_scope(model, opt)
    got = port_io.params_from_jax(dict(named), model=model, optimizer=opt)
    assert sorted(got) == sorted(named) and opt.learning_rate == 0.5
    optimizer = opt
    named = {n: v + 1 for n, v in named.items()}
    if edit == "missing":
        del named["mha_1.qkv_v.w"]
    elif edit == "unknown":
        named["enc_2.ffn1.w"] = np.zeros((8, 16), np.float32)
    elif edit == "moment":
        del named["lm_head.w_moment2_acc_0"]
    elif edit == "pow":
        named["tok_embedding_beta3_pow_acc_0"] = np.ones(1, np.float32)
    elif edit == "shape":
        named["pos_encoding_0.w_0"] = np.zeros((16, 8), np.float32)
    else:
        optimizer = None
    with pytest.raises(ValueError, match="missing|unknown|shape"):
        port_io.params_from_jax(named, model=model, optimizer=optimizer)
    # refused before anything is copied
    assert opt.learning_rate == 0.5
    assert all(not t.any() for t in model.reference_tensors().values())
    assert all(not t.any() for n, t in opt.accumulators().items())


@pytest.mark.parametrize("kind", ["lm_adam", "resnet_momentum", "lm_serving"])
def test_params_from_jax_drops_rng_state(kind):
    """A reference scope's @RNG_STATE@ is dropped, not refused: the whole
    scope after startup loads as it is."""
    from paddle_tpu_torch import optimizer as port_opt
    rng_state = np.arange(2, dtype=np.uint32)
    if kind == "lm_serving":
        named = dict(_named(), **{"@RNG_STATE@": rng_state})
        got = port_io.params_from_jax(named, device="cpu")
        assert sorted(got) == sorted(_named())
        return
    if kind == "lm_adam":
        model = port_tf.TransformerLM(29, 8, 2, 16, 2, 8, device="cpu")
        opt = port_opt.Adam(model.reference_parameters(), 0.1)
        named = _lm_scope(model, opt)
    else:
        from paddle_tpu_torch.models import resnet as port_resnet
        model = port_resnet.resnet_cifar10(8, device="cpu")
        opt = port_opt.Momentum(model.reference_parameters(), 0.1)
        named = _resnet_scope(model, opt)
    named = {n: v + 1 for n, v in named.items()}
    got = port_io.params_from_jax(dict(named, **{"@RNG_STATE@": rng_state}),
                                  model=model, optimizer=opt)
    assert sorted(got) == sorted(named)
    assert all(bool((t == 1).all())
               for t in model.reference_tensors().values())
    assert all(bool((t == 1).all()) for t in opt.accumulators().values())


SERVING = os.path.join(PKG, "serving")
# torch's own generators: a draw from any of them would make a decode
# stream depend on execution history, not on (seed, position)
_TORCH_RNG = re.compile(r"\btorch\s*\.\s*(rand\w*|multinomial|Generator|"
                        r"manual_seed|seed|initial_seed|bernoulli|"
                        r"normal|poisson)\b|\.(uniform_|normal_|"
                        r"random_|exponential_|bernoulli_)\(")


def _serving_sources():
    return sorted(os.path.join(dp, f) for dp, _d, fs in os.walk(SERVING)
                  for f in fs if f.endswith(".py"))


def test_no_torch_rng_in_serving():
    """The counterpart of the reference's
    ``test_decoding.py::test_no_jax_prngkey_in_serving``: nothing under
    ``paddle_tpu_torch/serving/`` draws from torch's generators, and
    every decode-side key comes from ``ops.random_ops.decoding_key``."""
    offenders = []
    for path in _serving_sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _TORCH_RNG.search(line.split("#")[0]):
                    offenders.append("%s:%d: %s" % (path, i, line.strip()))
    assert not offenders, offenders
    # the key primitives are reached only through decoding_key: no serving
    # module (nor the sampling ops) builds a key another way
    prim = re.compile(r"\b(prng_key|fold_in|threefry2x32|random_bits)\b")
    for path in _serving_sources() + [
            os.path.join(PKG, "ops", "decoding_ops.py"),
            os.path.join(PKG, "models", "transformer.py")]:
        with open(path) as f:
            src = f.read()
        assert not prim.search(src), path
    with open(os.path.join(PKG, "ops", "decoding_ops.py")) as f:
        assert "decoding_key(" in f.read()


def test_the_rng_lint_catches_a_draw():
    for line in ("x = torch.rand(3)", "g = torch.Generator()",
                 "torch.manual_seed(0)", "torch.multinomial(p, 1)",
                 "w.uniform_(-1, 1)", "torch.randint(0, 5, (2,))"):
        assert _TORCH_RNG.search(line), line
    assert not _TORCH_RNG.search("keys = decoding_key(seeds, steps)")


def test_decode_policy_sessions_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.serving.decoding import DecodePolicy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for pol in (DecodePolicy("sample", temperature=0.8),
                DecodePolicy(speculate_k=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_tf.transformer_lm_session(
                29, max_len=8, slots=1, cache_len=8, prompt_buckets=(4,),
                paged=True, block_size=4, decode_policy=pol)


def test_import_rule_covers_the_decode_policy_modules():
    mods = _package_modules()
    for mod in ("paddle_tpu_torch.ops.random_ops",
                "paddle_tpu_torch.ops.decoding_ops",
                "paddle_tpu_torch.serving.decoding",
                "paddle_tpu_torch.serving.decoding.policy",
                "paddle_tpu_torch.serving.decoding.constrain"):
        assert mod in mods


# a ROADMAP queue item cited by number goes stale when the queue moves;
# the package names items by title
_ITEM_NUMBER = re.compile(r"Queue\s+[A-D]\s+item\s+\d+")


def _item_numbers(src):
    """ROADMAP item numbers cited in ``src``: in its string literals (the
    parser joins adjacent ones, so a citation split across two literals
    is whole again) and in its comments and docstrings, lines joined."""
    hits = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            hits += _ITEM_NUMBER.findall(node.value)
    hits += _ITEM_NUMBER.findall(re.sub(r"\s*\n\s*#?\s*", " ", src))
    return hits


@pytest.mark.parametrize("path", sorted(
    [os.path.relpath(os.path.join(dp, f), ROOT)
     for dp, _d, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py"]))
def test_no_roadmap_item_number_in_source(path):
    with open(os.path.join(ROOT, path)) as f:
        assert not _item_numbers(f.read()), path


def test_the_item_number_lint_joins_split_literals():
    split = ('raise NotImplementedError(\n'
             '    "cannot match the threefry (ROADMAP Queue A "\n'
             '    "item 8)")\n')
    assert _item_numbers(split)
    assert _item_numbers("# see ROADMAP Queue C\n# item 2 for this\n")
    assert not _item_numbers('x = "ROADMAP Queue A, \\"Long tail\\""\n')


# a ROADMAP Queue A item cited by title: ROADMAP Queue A, "<title>"
_CITATION = re.compile(r'ROADMAP\s+Queue\s+A,\s*"([^"]+)"')


def _citations(src):
    """Queue A titles cited in ``src``'s string literals (the parser
    joins adjacent ones) and comments, whitespace collapsed."""
    texts = [node.value for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Constant) and isinstance(node.value, str)]
    texts.append(" ".join(
        tok.string.lstrip("#") for tok in tokenize.generate_tokens(
            io.StringIO(src).readline) if tok.type == tokenize.COMMENT))
    return {re.sub(r"\s+", " ", m).strip()
            for t in texts for m in _CITATION.findall(
                re.sub(r"\s+", " ", t))}


def _queue_a_titles():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    section = text.split("### Queue A")[1].split("### Queue B")[0]
    return [re.sub(r"\s+", " ", t).strip() for t in re.findall(
        r"^\d+\.\s+\*\*(.+?)\*\*", section, re.M | re.S)]


@pytest.mark.parametrize("path", sorted(
    [os.path.relpath(os.path.join(dp, f), ROOT)
     for dp, _d, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py"]))
def test_cited_queue_a_titles_exist(path):
    """Every ``ROADMAP Queue A, "<title>"`` of the package names an item
    of ROADMAP.md's Queue A as it stands (the start of its bold title)."""
    titles = _queue_a_titles()
    with open(os.path.join(ROOT, path)) as f:
        cited = _citations(f.read())
    stale = sorted(c for c in cited
                   if not any(t.startswith(c) for t in titles))
    assert not stale, (path, stale, titles)


def test_the_citation_lint_reads_literals_and_comments():
    src = ('x = ("not ported: ROADMAP Queue A, "\n'
           '     "\\"IR, registry, serialization\\"")\n'
           '# see ROADMAP Queue A, "Long\n# tail"\n')
    assert _citations(src) == {"IR, registry, serialization", "Long tail"}
    titles = _queue_a_titles()
    assert any(t.startswith("Long tail") for t in titles)
    # the title the dropout message cited until it went stale
    assert not any(t.startswith("IR, registry, serialization")
                   for t in titles)


def test_program_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch import core as pc
    from paddle_tpu_torch import io as pio
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.Executor("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pio.scope_from_jax({"w": np.zeros(2, np.float32)})
    assert pc.Executor(device="cpu").device == torch.device("cpu")


def test_registered_ops_are_the_reference_ones():
    """Every op type the port registers is one the reference registers,
    with the same needs_rng flag (the executor splits the key before
    exactly the ops the reference splits it before)."""
    import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
    from paddle_tpu.core import registry as ref_registry
    from paddle_tpu_torch.core import registry
    for op_type in registry.registered_ops():
        ours, theirs = registry.get_op_def(op_type), \
            ref_registry.get_op_def(op_type)
        assert (ours.needs_rng, ours.skip_eval_shape) == \
            (theirs.needs_rng, theirs.skip_eval_shape), op_type


def _slot_programs():
    """Port-built programs holding every registered op, each with its
    startup program and feed: ResNet-8 for CIFAR plain, fused and
    recomputed with Momentum; an fc net whose logits come through a
    ``matmul`` and a ``reduce_sum``, with SGD, and one with Adam; and the
    transformer LM with dropout and its ``length`` mask, with Adam; and
    wide&deep with distributed tables beside an ``is_sparse`` one, with
    Adagrad (their sparse gradients)."""
    from paddle_tpu_torch import core as pc
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.models import resnet, transformer, wide_deep
    img_feed = {"img": np.random.RandomState(0).randn(2, 3, 8, 8)
                .astype(np.float32), "label": np.array([[1], [7]])}
    ids = np.random.RandomState(1).randint(2, 20, (2, 8))
    lm_feed = {"toks": ids, "lbls": ids, "len": np.array([[8], [3]])}
    wd_feed = {"ids": ids[:, :3], "dense": np.ones((2, 4), np.float32),
               "label": np.array([[1.0], [0.0]], np.float32)}
    out = []
    for kind in ("plain", "fused", "recompute", "sgd", "adam", "lm",
                 "wide_deep"):
        port_config.set_flags(fused_conv_bn=kind == "fused")
        try:
            main, startup = pc.Program(), pc.Program()
            with pc.unique_name.guard(), pc.program_guard(main, startup):
                if kind == "wide_deep":
                    wids = layers.data("ids", shape=[3], dtype="int64")
                    dense = layers.data("dense", shape=[4])
                    lbl = layers.data("label", shape=[1])
                    loss = wide_deep.wide_deep(wids, dense, lbl, 20, 3,
                                               emb_dim=4, hidden=(8,),
                                               is_distributed=True)[0]
                    side = layers.embedding(wids, size=[20, 2],
                                            is_sparse=True)
                    loss = layers.elementwise_add(
                        loss, layers.mean(side))
                    opt = optimizer.Adagrad(0.1)
                    feed = wd_feed
                elif kind == "lm":
                    toks = layers.data("toks", shape=[8], dtype="int64")
                    lbls = layers.data("lbls", shape=[8], dtype="int64")
                    length = layers.data("len", shape=[1], dtype="int64")
                    loss = transformer.transformer_lm(
                        toks, lbls, 20, d_model=16, num_heads=2, d_ff=32,
                        num_layers=1, dropout_prob=0.1, length=length)[0]
                    opt = optimizer.Adam(0.1)
                    feed = lm_feed
                else:
                    img = layers.data("img", shape=[3, 8, 8])
                    label = layers.data("label", shape=[1], dtype="int64")
                    feed = img_feed
                if kind in ("sgd", "adam"):
                    h = layers.fc(layers.reshape(img, [-1, 192]), 10)
                    logits = layers.reduce_sum(layers.matmul(
                        layers.reshape(h, [-1, 10, 1]),
                        layers.reshape(h, [-1, 1, 10]), alpha=0.5), dim=2)
                    loss = layers.mean(layers.softmax_with_cross_entropy(
                        logits, label))
                    opt = optimizer.SGD(0.1) if kind == "sgd" \
                        else optimizer.Adam(0.1)
                elif kind not in ("lm", "wide_deep"):
                    loss = resnet.resnet_cifar10(
                        img, label, depth=8,
                        recompute=kind == "recompute")[0]
                    opt = optimizer.Momentum(0.1, 0.9)
                opt.minimize(loss, startup)
        finally:
            port_config.set_flags(fused_conv_bn=False)
        out.append((main, startup, loss.name, feed))
    return out


def _record_slots(monkeypatch, registry_mod):
    seen = {}
    real = registry_mod.normalize_outputs

    def record(op, result):
        seen.setdefault(op.type, set()).update(result)
        return real(op, result)
    monkeypatch.setattr(registry_mod, "normalize_outputs", record)
    return seen


_GEN = dict(d_model=16, num_heads=2, d_ff=32, num_layers=1, max_len=16,
            slots=2, prompt_buckets=(8,), bos_id=0, eos_id=1, block_size=4)


def _generation_weights():
    """{name: array} of the small generation LM, the reference's startup
    of its ``transformer_lm`` program, seeded."""
    import paddle_tpu as ptpu
    from paddle_tpu import layers as ref_layers
    from paddle_tpu.models import transformer as ref_tf
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        startup.random_seed = 3
        with ptpu.program_guard(main, startup):
            toks = ref_layers.data("toks", shape=[1, 16], dtype="int64",
                                   append_batch_size=False)
            ref_tf.transformer_lm(toks, toks, 20, is_test=True,
                                  **{k: _GEN[k] for k in (
                                      "d_model", "num_heads", "d_ff",
                                      "num_layers")})
    scope = ptpu.Scope()
    ptpu.Executor().run(startup, scope=scope)
    return {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}


def _generation_policies(dec):
    """Two decode policies of ``dec`` (a package's ``serving.decoding``)
    whose programs hold every generation op type: sampling under a
    constraint (dense), greedy speculation (paged, with a prefix
    copy-on-write)."""
    return ((False, dec.DecodePolicy(
                kind="sample", temperature=0.9,
                constraint=dec.DFAConstraint({0: {t: 0 for t in
                                                  range(2, 20)}}))),
            (True, dec.DecodePolicy(speculate_k=2)))


def _serve_generation(pkg, named):
    """Serve a few tokens through each policy's programs in ``pkg``'s
    session ("ref" or "port") over the weights ``named``."""
    if pkg == "ref":
        import paddle_tpu as ptpu
        from paddle_tpu.models.transformer import transformer_lm_session
        from paddle_tpu.serving import GenerationSession
        from paddle_tpu.serving import decoding as dec

        def scope_of():
            scope = ptpu.Scope()
            for n, v in named.items():
                scope.set_var(n, np.array(v))
            return scope
        kw = {}
    else:
        from paddle_tpu_torch.serving import GenerationSession
        from paddle_tpu_torch.serving import decoding as dec
        transformer_lm_session = port_tf.transformer_lm_session

        def scope_of():
            return port_io.scope_from_jax(named, device="cpu")
        kw = dict(device="cpu")
    for paged, policy in _generation_policies(dec):
        spec = transformer_lm_session(20, paged=paged, prefix_cache=paged,
                                      decode_policy=policy, **_GEN, **kw)
        sess = GenerationSession(spec, scope_of())
        for prompt in ([2, 3, 4, 5, 6, 7], [2, 3, 4, 5, 6, 9]):
            sess.generate(prompt, max_new_tokens=4)
        sess.close()


def test_generation_program_op_types_are_registered():
    """Every op type of the reference's generation programs of a small
    LM, the decode-policy flags off and on, is registered in the port: a
    program the reference's ``transformer_lm_session`` builds does not
    fail in the port on a missing op."""
    from paddle_tpu.models.transformer import transformer_lm_session
    from paddle_tpu.serving import decoding as dec
    from paddle_tpu_torch.core import registry

    def programs(spec):
        progs = list(spec.prefill_programs.values()) + [
            spec.decode_program, spec.copy_program, spec.verify_program]
        if spec.draft_spec is not None:
            progs += programs(spec.draft_spec)
        return [p for p in progs if p is not None]
    types = set()
    for paged, policy in ((False, None), (True, None)) + \
            _generation_policies(dec):
        spec = transformer_lm_session(20, paged=paged, decode_policy=policy,
                                      **_GEN)
        types |= {op.type for p in programs(spec)
                  for op in p.global_block().ops}
    assert {"kv_cache_append", "kv_block_copy", "decode_sample",
            "decode_verify", "arg_max"} <= types
    assert sorted(types - set(registry.registered_ops())) == []


def test_output_slots_equal_reference_on_one_program(monkeypatch):
    """Run on the same programs (the port's, and the reference's loaded
    from their JSON; the generation programs through each package's
    session, which serialize alike), each op's compute returns the
    reference's output slot names."""
    import json
    from paddle_tpu.core import registry as ref_registry
    from paddle_tpu.core import serialization as ref_ser
    import paddle_tpu as ptpu
    from paddle_tpu_torch import core as pc
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core import serialization as port_ser
    programs = _slot_programs()
    named = _generation_weights()
    ours = _record_slots(monkeypatch, registry)
    for main, startup, loss, feed in programs:
        exe, scope = pc.Executor(device="cpu"), pc.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    _serve_generation("port", named)
    theirs = _record_slots(monkeypatch, ref_registry)
    for main, startup, loss, feed in programs:
        load = lambda p: ref_ser.program_from_dict(  # noqa: E731
            json.loads(json.dumps(port_ser.program_to_dict(p))))
        exe = ptpu.Executor()
        with ptpu.scope_guard(ptpu.Scope()):
            exe.run(load(startup))
            exe.run(load(main), feed=feed, fetch_list=[loss])
    _serve_generation("ref", named)
    # the op types of the LeNet-5/MNIST slice have their output slots
    # held against the reference's case by case, every op type of the
    # slice with at least one case (test_torch_ops_forward.py), and so do
    # the RNN and seq2seq slice's (its sub-block ops through the programs
    # of test_torch_control_flow.py and test_torch_beam_search.py), and the
    # op tail's (test_torch_{detection,misc_ops,legacy_tail}.py)
    from paddle_tpu_torch.probes.op_cases import RNN_OPS, TAIL_OPS
    from test_torch_ops_cases import SLICE_OPS
    assert sorted(set(ours) | set(SLICE_OPS) | set(RNN_OPS) |
                  set(TAIL_OPS)) == registry.registered_ops()
    assert {t: sorted(s) for t, s in ours.items()} == \
        {t: sorted(theirs[t]) for t in ours}


# the LeNet-5/MNIST slice's modules: the import walk above and the source
# check cover them with the rest of the package
LENET_SLICE_MODULES = [
    "paddle_tpu_torch.ops.activation_ops", "paddle_tpu_torch.ops.math_ops",
    "paddle_tpu_torch.ops.tensor_ops", "paddle_tpu_torch.ops.random_ops",
    "paddle_tpu_torch.ops.nn_ops", "paddle_tpu_torch.ops.loss_ops",
    "paddle_tpu_torch.ops.optimizer_ops", "paddle_tpu_torch.ops.metric_ops",
    "paddle_tpu_torch.regularizer", "paddle_tpu_torch.clip",
    "paddle_tpu_torch.lr_scheduler", "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.layers.nn", "paddle_tpu_torch.layers.tensor",
    "paddle_tpu_torch.layers.ops", "paddle_tpu_torch.layers.io",
    "paddle_tpu_torch.initializer", "paddle_tpu_torch.nets",
    "paddle_tpu_torch.models.lenet", "paddle_tpu_torch.reader.recordio",
    "paddle_tpu_torch.native"]


def test_import_rule_covers_the_lenet_slice_modules():
    assert set(LENET_SLICE_MODULES) <= set(_package_modules())
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')))\n" % (LENET_SLICE_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the staged training pipeline's modules: the import walk above and the
# source check cover them with the rest of the package
PIPELINE_MODULES = ["paddle_tpu_torch.core.ingest", "paddle_tpu_torch.reader",
                    "paddle_tpu_torch.reader.staging",
                    "paddle_tpu_torch.data_feeder", "paddle_tpu_torch.trainer",
                    "paddle_tpu_torch.utils.stat", "paddle_tpu_torch.io"]


def test_the_pipeline_modules_are_walked_and_import_clean():
    assert set(PIPELINE_MODULES) <= set(_package_modules())
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')))\n" % (PIPELINE_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_staged_pipeline_without_device_means_cuda_and_raises(monkeypatch):
    from paddle_tpu_torch import core as pc
    from paddle_tpu_torch import trainer as port_trainer
    from paddle_tpu_torch.reader.staging import StagedReader
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagedReader(lambda: iter([]))
    main = pc.Program()
    with pc.program_guard(main, pc.Program()):
        loss = pc.default_main_program().global_block().create_var(
            name="loss", shape=[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_trainer.Trainer(loss, main_program=main)
    assert StagedReader(lambda: iter([]), device="cpu").device == \
        torch.device("cpu")


def test_import_rule_covers_the_export_and_engine_modules():
    """The inference export and serving engine modules are among those
    the import rule parses and imports, and the C shim imports the
    port's bridge."""
    mods = _package_modules()
    for mod in ("paddle_tpu_torch.inference", "paddle_tpu_torch.io",
                "paddle_tpu_torch.capi_bridge", "paddle_tpu_torch.native",
                "paddle_tpu_torch.utils.merge_model",
                "paddle_tpu_torch.serving.engine",
                "paddle_tpu_torch.serving.batcher",
                "paddle_tpu_torch.serving.deploy",
                "paddle_tpu_torch.serving.model_paging",
                "paddle_tpu_torch.serving.quant",
                "paddle_tpu_torch.serving.resilience"):
        assert mod in mods
    with open(os.path.join(PKG, "csrc", "capi.cc")) as f:
        src = f.read()
    assert "paddle_tpu_torch.capi_bridge" in src
    assert '"paddle_tpu.' not in src


def test_serving_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from paddle_tpu_torch import capi_bridge, inference
    from paddle_tpu_torch import core as pc
    from paddle_tpu_torch import layers as pl
    from paddle_tpu_torch.serving import ServingEngine
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        out = pl.fc(pl.data("x", shape=[3]), 2)
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path)
    port_io.save_inference_model(d, ["x"], [out], exe, main, scope)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ServingEngine(d, buckets=(1,)),
                 lambda: inference.InferenceEngine(d),
                 lambda: capi_bridge.load_model(d),
                 lambda: port_io.load_inference_model(
                     d, pc.Executor(), scope=pc.Scope())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    eng = ServingEngine(d, buckets=(1,), device="cpu")
    assert [str(r.device) for r in eng.replicas] == ["cpu"]
    eng.close()


# the distribution slice's modules: the import walk above and the source
# check cover them with the rest of the package
DISTRIBUTION_MODULES = [
    "paddle_tpu_torch.parallel", "paddle_tpu_torch.parallel.spmd",
    "paddle_tpu_torch.parallel.ring_attention",
    "paddle_tpu_torch.distributed", "paddle_tpu_torch.distributed.launch",
    "paddle_tpu_torch.embeddings", "paddle_tpu_torch.embeddings.sharded",
    "paddle_tpu_torch.embeddings.checkpoint",
    "paddle_tpu_torch.ops.sparse_ops", "paddle_tpu_torch.models.wide_deep"]


def test_the_distribution_modules_are_walked_and_import_clean():
    """The distribution modules import neither jax nor paddle_tpu, and
    their entry points take the card by default: a process group asked
    for without a device is NCCL's, and raises without CUDA rather than
    falling back to gloo."""
    assert set(DISTRIBUTION_MODULES) <= set(_package_modules())
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')))\n" % (DISTRIBUTION_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    import torch
    from paddle_tpu_torch.distributed import init_multihost
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_multihost("localhost:1", 2, 0)


V2_SLICE_MODULES = (
    ["paddle_tpu_torch.v2"] +
    ["paddle_tpu_torch.v2." + m for m in (
        "activation", "data_type", "event", "inference", "layer",
        "optimizer", "parameters", "place", "pooling", "trainer")] +
    ["paddle_tpu_torch.dataset"] +
    ["paddle_tpu_torch.dataset." + m for m in (
        "common", "mnist", "cifar", "uci_housing", "imdb", "imikolov",
        "movielens", "wmt14", "mq2007", "conll05", "flowers", "voc2012",
        "sentiment")] +
    ["paddle_tpu_torch.utils.image", "paddle_tpu_torch.utils.net_drawer",
     "paddle_tpu_torch.plot"])


def test_the_walk_covers_the_v2_slice():
    """The v2 API, the datasets, ``utils/{image,net_drawer}.py`` and
    ``plot.py`` are among the modules the import walk and the source scan
    cover, and ``import paddle_tpu_torch.v2`` in a fresh interpreter brings
    in neither jax nor paddle_tpu."""
    assert set(V2_SLICE_MODULES) <= set(_package_modules())
    code = ("import sys\nimport paddle_tpu_torch.v2 as paddle\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')), paddle.__all__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import paddle_tpu_torch.v2 as port_v2
    assert out.stdout.strip() == "[] %s" % (port_v2.__all__,)


def test_v2_entry_points_raise_without_cuda(monkeypatch):
    """``paddle.init()`` means CUDA and raises without it; with nothing
    recorded, ``parameters.create``, ``SGD`` and ``infer`` take CUDA and
    raise; ``init(device="cpu")`` or ``use_gpu=False`` is the caller
    asking for the CPU."""
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch import core
    from paddle_tpu_torch.v2 import place as v2_place
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(v2_place, "_recorded", [None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle.init(device="cuda")
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        x = paddle.layer.data("x", paddle.data_type.dense_vector(3))
        y = paddle.layer.data("y", paddle.data_type.dense_vector(1))
        out = paddle.layer.fc(x, size=1)
        cost = paddle.layer.regression_cost(input=out, label=y)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paddle.parameters.create(cost)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paddle.trainer.SGD(cost, paddle.parameters.Parameters(),
                               paddle.optimizer.Momentum())
        sample = [(np.ones(3, np.float32), np.ones(1, np.float32))]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paddle.infer(output_layer=out, parameters=None, input=sample,
                         feeding={"x": 0, "y": 1})
        assert paddle.init(use_gpu=False) == torch.device("cpu")
        params = paddle.parameters.create(cost)
        sgd = paddle.trainer.SGD(cost, params, paddle.optimizer.Momentum())
    scope = core.Scope()
    with core.scope_guard(scope):
        sgd.train(lambda: iter([sample * 2]), feeding={"x": 0, "y": 1})
        got = paddle.infer(output_layer=out, parameters=params,
                           input=sample, feeding={"x": 0, "y": 1})
    assert got.shape == (1, 1) and np.isfinite(got).all()
    assert scope.find_var(params.names()[0]).device == torch.device("cpu")
