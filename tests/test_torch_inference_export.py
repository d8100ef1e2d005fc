"""Inference export in the port (``io.prune_program``,
``save_inference_model``, ``load_inference_model``, the manifest,
``serving/quant.py``'s export half, ``utils/merge_model.py``,
``inference.py`` and ``Trainer.save_inference_model``) against the
reference, on the CPU.

* ``prune_program`` gives the reference's program dict for the LM, an fc
  net and ResNet-8.
* Both packages' exports of the same weights are the same: ``__model__``,
  ``params.meta.json`` and ``quant.json`` byte for byte, the npz arrays
  bit for bit.
* The manifest: a tampered ``params.npz`` raises, an unmanifested
  ``quant.json`` is refused, a legacy artifact warns once; each with the
  reference's reason.
* Artifacts cross both ways, f32, int8 and merged: a run of the loaded
  model equals the other package's ``InferenceEngine`` within 1e-5 of
  max|out|; loaded under ``quant_compute``, each armed product is the
  reference's bit for bit on the reference's input and the logits are
  within the armed forward's bound (``test_torch_program_quant.py``).
* ``infer``'s engine cache is keyed by the manifest digest.
* A batch-norm model (ResNet-8) exports without its running statistics
  in both packages (Parameters only), and neither can run the artifact.
"""

import json
import os
import types
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import inference as ref_inference
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu import trainer as ref_trainer
from paddle_tpu.core.serialization import program_to_dict as ref_to_dict
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu.utils import merge_model as ref_merge
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import inference as port_inference
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import trainer as port_trainer
from paddle_tpu_torch.core.serialization import program_to_dict
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import quant_ops as port_qops
from paddle_tpu_torch.serving import quant as port_quant
from paddle_tpu_torch.utils import merge_model as port_merge
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# the LM at a small size: 2 layers, d_model 64, T 64
NET = dict(vocab_size=100, d_model=64, num_heads=2, d_ff=128, num_layers=2)
T, B = 64, 3
LM_INT8_STEPS = 4


def _pkg(ref):
    return (ptpu, ref_layers) if ref else (pc, port_layers)


def _lm(ref):
    fw, layers = _pkg(ref)
    tf = ref_tf if ref else port_tf
    with fw.unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        startup.random_seed = 3
        with fw.program_guard(main, startup):
            toks = layers.data("toks", shape=[T], dtype="int64")
            lbls = layers.data("lbls", shape=[T], dtype="int64")
            _, logits = tf.transformer_lm(toks, lbls, is_test=True, **NET)
    return main, startup, ["toks"], logits


def _fc(ref):
    fw, layers = _pkg(ref)
    with fw.unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        startup.random_seed = 5
        with fw.program_guard(main, startup):
            x = layers.data("x", shape=[16])
            h = layers.fc(x, 32, act="relu")
            out = layers.fc(h, 10, act="softmax")
    return main, startup, ["x"], out


def _resnet(ref):
    fw, layers = _pkg(ref)
    rn = ref_resnet if ref else port_resnet
    with fw.unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        startup.random_seed = 4
        with fw.program_guard(main, startup):
            img = layers.data("img", shape=[3, 16, 16])
            label = layers.data("label", shape=[1], dtype="int64")
            logits = rn.resnet_cifar10(img, label, depth=8,
                                       is_test=True)[2]
    return main, startup, ["img"], logits


BUILDERS = {"lm": _lm, "fc": _fc, "resnet": _resnet}


def _feed(kind, seed=0, n=B):
    rs = np.random.RandomState(seed)
    if kind == "lm":
        return {"toks": rs.randint(2, NET["vocab_size"], (n, T))}
    if kind == "fc":
        return {"x": rs.randn(n, 16).astype(np.float32)}
    return {"img": rs.randn(n, 3, 16, 16).astype(np.float32)}


def _ref_scope(startup, seed=None):
    """The reference's startup scope; with ``seed`` every value redrawn
    from it (random running statistics too, so BN is not the identity)."""
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    if seed is not None:
        rs = np.random.RandomState(seed)
        for n in sorted(scope.var_names()):
            cur = np.asarray(scope.find_var(n))
            if cur.dtype == np.float32:
                val = rs.standard_normal(cur.shape).astype(np.float32)
                if n.endswith(("variance", ".global_1", "_1.w_2")):
                    val = np.abs(val) + 0.5
                scope.set_var(n, val * np.float32(0.2))
    return scope


def _named(scope):
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()}


def _export_both(kind, tmp_path, quantize=None, seed=None):
    """One weight set exported by both packages: (ref dir, port dir,
    ref program, port program, feed names, fetch name, ref scope)."""
    rmain, rstart, feeds, rout = BUILDERS[kind](True)
    pmain, _, _, pout = BUILDERS[kind](False)
    rscope = _ref_scope(rstart, seed)
    pscope = port_io.scope_from_jax(_named(rscope), device="cpu")
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    with ptpu.scope_guard(rscope):
        ref_io.save_inference_model(rdir, feeds, [rout], ptpu.Executor(),
                                    main_program=rmain, quantize=quantize)
    port_io.save_inference_model(pdir, feeds, [pout],
                                 pc.Executor(device="cpu"),
                                 main_program=pmain, scope=pscope,
                                 quantize=quantize)
    return rdir, pdir, rmain, pmain, feeds, rout.name, rscope


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_prune_program_equals_reference(kind):
    rmain, _, _, rout = BUILDERS[kind](True)
    pmain, _, _, pout = BUILDERS[kind](False)
    assert rout.name == pout.name
    got = program_to_dict(port_io.prune_program(pmain, [pout.name]))
    want = ref_to_dict(ref_io.prune_program(rmain, [rout.name]))
    assert got == want
    # the loss and the labels feed go with the pruning
    kept = {v["name"] for b in got["blocks"] for v in b["vars"]}
    assert "lbls" not in kept and "label" not in kept


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_exports_are_the_references(kind, quantize, tmp_path):
    rdir, pdir, *_ = _export_both(kind, tmp_path, quantize)
    members = sorted(os.listdir(rdir))
    assert sorted(os.listdir(pdir)) == members
    assert ("quant.json" in members) == (quantize is not None)
    for m in ("__model__", "params.meta.json", "quant.json"):
        if m in members:
            assert _read(os.path.join(pdir, m)) == \
                _read(os.path.join(rdir, m)), m
    got, want = _npz(os.path.join(pdir, "params.npz")), \
        _npz(os.path.join(rdir, "params.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    if quantize:
        assert any(a.dtype == np.int8 for a in got.values())
    # each manifest digests the same members, and the digests of the
    # identical members agree
    pm = json.loads(_read(os.path.join(pdir, "manifest.json")))
    rm = json.loads(_read(os.path.join(rdir, "manifest.json")))
    assert sorted(pm["digests"]) == sorted(rm["digests"])
    assert pm["kind"] == rm["kind"] == "inference_model"
    assert pm["digests"]["__model__"] == rm["digests"]["__model__"]


def _tamper(d):
    with open(os.path.join(d, "params.npz"), "r+b") as f:
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 0xFF]))


def _stray_quant(d):
    with open(os.path.join(d, "quant.json"), "w") as f:
        json.dump({"version": 1, "dtype": "int8", "vars": {}}, f)


@pytest.mark.parametrize("damage", [_tamper, _stray_quant],
                         ids=["tampered_npz", "unmanifested_quant"])
def test_manifest_refuses_a_damaged_artifact(damage, tmp_path):
    rdir, pdir, *_ = _export_both("fc", tmp_path)
    reasons = []
    for d, io_mod, exe in ((pdir, port_io, pc.Executor(device="cpu")),
                           (rdir, ref_io, ptpu.Executor())):
        damage(d)
        ok, reason = io_mod.verify_model_artifact(d)
        assert not ok
        reasons.append(reason)
        scope = pc.Scope() if io_mod is port_io else ptpu.Scope()
        with pytest.raises(ValueError, match="integrity"):
            io_mod.load_inference_model(d, exe, scope=scope)
    assert reasons[0] == reasons[1]


def test_legacy_artifact_warns_once(tmp_path):
    _, pdir, *_ = _export_both("fc", tmp_path)
    os.remove(os.path.join(pdir, "manifest.json"))
    assert port_io.verify_model_artifact(pdir) == \
        (True, "legacy (no manifest)")
    assert port_io.artifact_manifest_digest(pdir) is None
    exe = pc.Executor(device="cpu")
    with pytest.warns(UserWarning, match="no manifest.json"):
        port_io.load_inference_model(pdir, exe, scope=pc.Scope())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_io.load_inference_model(pdir, exe, scope=pc.Scope())


def _port_engine(d):
    return port_inference.InferenceEngine(d, device="cpu")


def _ref_engine(d):
    return ref_inference.InferenceEngine(d)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{(kind, quantize): (ref dir, port dir)} of one weight set each,
    exported once for the module."""
    out = {}
    for kind in ("lm", "fc"):
        for quantize in (None, "int8"):
            tmp = tmp_path_factory.mktemp("%s-%s" % (kind, quantize))
            out[kind, quantize] = _export_both(kind, tmp, quantize,
                                               seed=11)[:2]
    return out


@pytest.mark.parametrize("form", ["dir", "merged"])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kind", ["lm", "fc"])
def test_artifacts_cross_both_ways(kind, direction, quantize, form,
                                   exported, tmp_path):
    rdir, pdir = exported[kind, quantize]
    src = rdir if direction == "ref_to_port" else pdir
    if form == "merged":
        merge = ref_merge if direction == "ref_to_port" else port_merge
        src = merge.merge_inference_model(src, str(tmp_path / "m.ptpu"))
    feed = _feed(kind, seed=1)
    got, = _port_engine(src).run(feed)
    want, = _ref_engine(src).run(feed)
    _close(got, want)


def test_a_bn_model_exports_without_its_statistics(tmp_path):
    """The reference's ``save_inference_model`` keeps Parameters only
    (``save_params``), so a batch norm's running statistics are not in
    the artifact, and neither package can run it: both raise the same
    error at the first batch norm, the port at the engine's warmup."""
    rdir, pdir, *_ = _export_both("resnet", tmp_path, seed=11)
    feed = _feed("resnet")
    errors = []
    for make in (_ref_engine, _port_engine):
        for src in (rdir, pdir):
            with pytest.raises(Exception) as err:
                make(src).run(feed)
            errors.append(str(err.value))
    assert len(set(errors)) == 1
    assert "'batch_norm_0.global_0' read by 'batch_norm' is not " \
        "initialized" in errors[0]
    from paddle_tpu_torch.serving import ServingEngine
    with pytest.raises(Exception, match="batch_norm_0.global_0"):
        ServingEngine(pdir, buckets=(2,), device="cpu")


def _armed_pair(kind, src):
    """Both packages' armed loads of one int8 artifact: (reference
    fetches by name, port scope, port program, [(op, in, out)])."""
    ptpu.config.set_flags(quant_pallas=False)
    rscope, pscope = ptpu.Scope(), pc.Scope()
    rexe = ptpu.Executor()
    rprog, _, fetches = ref_io.load_inference_model(
        src, rexe, scope=rscope, quant_compute=True)
    pprog, pfeeds, pfetches = port_io.load_inference_model(
        src, pc.Executor(device="cpu"), scope=pscope, quant_compute=True)
    assert pfetches == fetches
    assert pprog._quant_compute["vars"] == rprog._quant_compute["vars"]
    assert pprog._quant_compute["key"] == rprog._quant_compute["key"]
    tag = pprog._quant_compute["vars"]
    ops = [(op, "X", "Out") for op in pprog.global_block().ops
           if op.type in ("mul", "matmul") and op.inputs["Y"][0] in tag]
    names = fetches + [n for op, i, o in ops
                       for n in (op.inputs[i][0], op.outputs[o][0])]
    feed = _feed(kind, seed=2)
    ref = rexe.run(rprog, feed=feed, fetch_list=names, scope=rscope)
    port = pc.Executor(device="cpu").run(pprog, feed=feed,
                                         fetch_list=fetches, scope=pscope)
    return dict(zip(names, map(np.asarray, ref))), port[0], pscope, ops


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_int8_artifact_armed_products_bitwise(direction, exported):
    rdir, pdir = exported["lm", "int8"]
    src = rdir if direction == "ref_to_port" else pdir
    ref, logits, pscope, ops = _armed_pair("lm", src)
    assert len(ops) == 6 * NET["num_layers"] + 1
    # the weights stay int8 in the scope, their scales beside them: no
    # float32 copy of an armed weight
    for op, _, _ in ops:
        w = op.inputs["Y"][0]
        assert pscope.find_var(w).dtype == torch.int8
        assert pscope.find_var(w + "@quant.scale").dtype == torch.float32
    env = {n: pscope.find_var(n) for n in pscope.var_names()}
    trace = types.SimpleNamespace(quant=None, quant_seen=set())
    for op, i, o in ops:
        trace.quant = {"vars": {op.inputs["Y"][0]: 1}}
        got = port_qops.maybe_quant_compute(
            op, {i: [torch.tensor(ref[op.inputs[i][0]])],
                 "Y": [env[op.inputs["Y"][0]]]}, env, trace)
        np.testing.assert_array_equal(got[o].numpy(), ref[op.outputs[o][0]],
                                      err_msg=op.outputs[o][0])
    d = NET["d_model"]
    ln = "layer_norm_%d" % (2 * NET["num_layers"])
    amax = (d - 1) ** 0.5 * float(pscope.find_var(ln + ".w_0").abs().max()) \
        + float(pscope.find_var(ln + ".w_1").abs().max())
    step = amax * float(pscope.find_var("lm_head.w@quant.scale").max())
    want = ref[list(ref)[0]]
    assert logits.shape == want.shape and want.shape[-1] == \
        NET["vocab_size"]
    assert np.abs(logits - want).max() <= LM_INT8_STEPS * step


def test_dequantized_load_is_bitwise_numpys(exported):
    """The default load of an int8 artifact: each weight one float32
    multiply of its int8 value by its scale, bitwise the reference's."""
    rdir, _ = exported["lm", "int8"]
    rscope, pscope = ptpu.Scope(), pc.Scope()
    ref_io.load_inference_model(rdir, ptpu.Executor(), scope=rscope)
    port_io.load_inference_model(rdir, pc.Executor(device="cpu"),
                                 scope=pscope)
    meta = port_quant.load_quant_meta(rdir)
    assert meta == json.loads(_read(os.path.join(rdir, "quant.json")))
    for name in meta["vars"]:
        got = pscope.find_var(name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(rscope.find_var(name)))


def test_quantize_model_dir_after_export_refreshes_the_manifest(tmp_path):
    _, pdir, *_ = _export_both("fc", tmp_path)
    before = port_io.artifact_manifest_digest(pdir)
    names = port_quant.quantize_model_dir(pdir)
    assert names == ["fc_0.w_0", "fc_1.w_0"]
    assert port_io.verify_model_artifact(pdir) == (True, "ok")
    assert port_io.artifact_manifest_digest(pdir) != before
    with pytest.raises(ValueError, match="only 'int8'"):
        port_quant.quantize_model_dir(pdir, dtype="int4")


def test_infer_cache_is_keyed_by_the_manifest_digest(tmp_path):
    _, pdir, _, pmain, feeds, out, rscope = _export_both("fc", tmp_path)
    port_inference.clear_engine_cache()
    feed = _feed("fc")
    first = port_inference.infer(pdir, feed, device="cpu")
    assert len(port_inference._ENGINE_CACHE) == 1
    (key, engine), = port_inference._ENGINE_CACHE.items()
    assert key[2] == port_io.artifact_manifest_digest(pdir)
    np.testing.assert_array_equal(
        port_inference.infer(pdir, feed, device="cpu"), first)
    assert list(port_inference._ENGINE_CACHE.values()) == [engine]
    # a params-only republish (same __model__) changes the digest, and
    # the next call loads the new weights
    named = _named(rscope)
    named["fc_1.w_1"] = named["fc_1.w_1"] + np.float32(1.0)
    port_io.save_inference_model(
        pdir, feeds, [pmain.global_block().var(out)],
        pc.Executor(device="cpu"), main_program=pmain,
        scope=port_io.scope_from_jax(named, device="cpu"))
    second = port_inference.infer(pdir, feed, device="cpu")
    assert len(port_inference._ENGINE_CACHE) == 2
    assert not np.array_equal(second, first)
    port_inference.clear_engine_cache()
    assert not port_inference._ENGINE_CACHE


def _trainer(pkg, scope, guard, exe_kw):
    fw, layers = _pkg(pkg is ref_trainer)
    with fw.unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        startup.random_seed = 9
        with fw.program_guard(main, startup):
            x = layers.data("x", shape=[6])
            y = layers.data("y", shape=[1], dtype="int64")
            pred = layers.fc(layers.fc(x, 12, act="relu"), 4)
            loss = layers.mean(layers.softmax_with_cross_entropy(pred, y))
            (ptpu.optimizer if pkg is ref_trainer else port_opt).SGD(
                0.1).minimize(loss, startup)
    with guard(scope):
        tr = pkg.Trainer(loss, main_program=main, startup_program=startup,
                         **exe_kw)
        tr.startup()
    return tr, pred


def test_trainer_save_inference_model_loads_in_the_reference(tmp_path):
    rs = np.random.RandomState(4)
    batch = {"x": rs.randn(8, 6).astype(np.float32),
             "y": rs.randint(0, 4, (8, 1))}
    outs = {}
    for pkg, scope, guard, kw in (
            (port_trainer, pc.Scope(), pc.scope_guard, {"device": "cpu"}),
            (ref_trainer, ptpu.Scope(), ptpu.scope_guard, {})):
        tr, pred = _trainer(pkg, scope, guard, kw)
        d = str(tmp_path / pkg.__name__)
        with guard(scope):
            tr.train(lambda: iter([batch, batch]), num_passes=1,
                     staging=False)
            tr.save_inference_model(d, ["x"], [pred])
        outs[pkg.__name__] = d
    pdir = outs[port_trainer.__name__]
    rdir = outs[ref_trainer.__name__]
    assert _read(os.path.join(pdir, "__model__")) == \
        _read(os.path.join(rdir, "__model__"))
    # the port's artifact in the reference's engine
    got, = _ref_engine(pdir).run({"x": batch["x"]})
    want, = _port_engine(pdir).run({"x": batch["x"]})
    _close(got, want)
    # and the two trainings landed on the same weights
    _close(_ref_engine(rdir).run({"x": batch["x"]})[0], want, rel=1e-4)
