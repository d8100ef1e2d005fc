"""The port's checkpoints (``paddle_tpu_torch/io.py``) against the
reference's (``paddle_tpu/io.py``), on the CPU.

Checkpoints cross in both directions with every array equal to the bit:
the npz members are byte-equal (the zip containers differ only in their
timestamps), ``.meta.json`` and the manifest's file set are the
reference's, and the RNG key crosses as the reference stores it (uint32
words; the port holds int64 words). A corrupt or torn checkpoint is
quarantined to the reference's ``corrupt_*`` name and the load falls
back to the previous intact one; ``keep_last`` and the ``corrupt_*``
bound prune as the reference prunes; the ``checkpoint_crash`` fault
leaves no half-written directory behind.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core.framework import RNG_STATE_VAR
from paddle_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _restore():
    yield
    faults.disarm()
    ref_faults.disarm()


def _program(ref):
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 5
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = layers.data("x", shape=[6])
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, 8, act="relu")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, 3), y))
        (ptpu.optimizer if ref else port_opt).Momentum(0.1, 0.9).minimize(
            loss, startup)
    return main, startup, loss


def _feed(seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(4, 6).astype(np.float32),
            "y": rs.randint(0, 3, (4, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def reference():
    """A reference scope after startup and two steps: {name: array}."""
    main, startup, loss = _program(True)
    scope = ptpu.Scope()
    exe = ptpu.Executor()
    with ptpu.scope_guard(scope):
        exe.run(startup)
        for i in range(2):
            exe.run(main, feed=_feed(i), fetch_list=[loss])
        return {n: np.array(scope.find_var(n)) for n in scope.var_names()}


def _port_scope(named):
    scope = port_io.scope_from_jax(named, device="cpu")
    if RNG_STATE_VAR in named:
        scope.set_var(RNG_STATE_VAR, torch.from_numpy(
            np.asarray(named[RNG_STATE_VAR]).astype(np.int64)))
    return scope


def _ref_scope(named):
    scope = ptpu.Scope()
    for n, v in named.items():
        scope.set_var(n, v)
    return scope


def _save(pkg, named, dirname, step, **kw):
    main, _, _ = _program(pkg is ref_io)
    if pkg is ref_io:
        pkg.save_checkpoint(ptpu.Executor(), dirname, step, main,
                            scope=_ref_scope(named), **kw)
    else:
        pkg.save_checkpoint(pc.Executor(device="cpu"), dirname, step, main,
                            scope=_port_scope(named), **kw)


def _load(pkg, dirname):
    main, _, _ = _program(pkg is ref_io)
    if pkg is ref_io:
        scope = ptpu.Scope()
        step = pkg.load_checkpoint(ptpu.Executor(), dirname, main,
                                   scope=scope)
        return step, {n: np.asarray(scope.find_var(n))
                      for n in scope.var_names()}
    scope = pc.Scope()
    step = pkg.load_checkpoint(pc.Executor(device="cpu"), dirname, main,
                               scope=scope)
    return step, {n: scope.find_var(n).numpy() for n in scope.var_names()}


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("writer,reader", [(port_io, ref_io),
                                           (ref_io, port_io)])
def test_checkpoints_cross_in_both_directions(tmp_path, reference, writer,
                                              reader):
    _save(writer, reference, str(tmp_path), 7)
    step, got = _load(reader, str(tmp_path))
    assert step == 7
    assert sorted(got) == sorted(reference)
    for name, want in reference.items():
        g = got[name]
        if name == RNG_STATE_VAR:
            # the reference holds uint32 words, the port int64 words
            assert g.astype(np.uint32).tobytes() == \
                np.asarray(want).astype(np.uint32).tobytes()
            continue
        assert g.dtype == want.dtype and _bits_equal(g, want), name


def test_a_loaded_reference_checkpoint_trains_on_as_the_reference(
        tmp_path, reference):
    _save(ref_io, reference, str(tmp_path), 2)
    main, _, loss = _program(False)
    scope = pc.Scope()
    exe = pc.Executor(device="cpu")
    assert port_io.load_checkpoint(exe, str(tmp_path), main,
                                   scope=scope) == 2
    assert scope.find_var(RNG_STATE_VAR).dtype == torch.int64
    got = float(exe.run(main, feed=_feed(2), fetch_list=[loss],
                        scope=scope)[0])
    rmain, _, rloss = _program(True)
    rscope = _ref_scope(reference)
    with ptpu.scope_guard(rscope):
        want = float(ptpu.Executor().run(rmain, feed=_feed(2),
                                         fetch_list=[rloss])[0])
    assert abs(got - want) <= 1e-5 * abs(want)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_files_and_manifest_equal_the_reference(tmp_path, reference):
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    _save(port_io, reference, port_dir, 3, extra_meta={"why": "test"})
    _save(ref_io, reference, ref_dir, 3, extra_meta={"why": "test"})
    pc_dir, rc_dir = (os.path.join(d, "checkpoint_3")
                      for d in (port_dir, ref_dir))
    assert sorted(os.listdir(pc_dir)) == sorted(os.listdir(rc_dir)) == \
        ["manifest.json", "persistables.meta.json", "persistables.npz"]
    assert _members(os.path.join(pc_dir, "persistables.npz")) == \
        _members(os.path.join(rc_dir, "persistables.npz"))
    for fn in ("persistables.meta.json",):
        with open(os.path.join(pc_dir, fn)) as f, \
                open(os.path.join(rc_dir, fn)) as g:
            assert f.read() == g.read()
    manifests = []
    for d in (pc_dir, rc_dir):
        with open(os.path.join(d, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0]["step"] == manifests[1]["step"] == 3
    assert sorted(manifests[0]["digests"]) == sorted(manifests[1]["digests"])
    assert manifests[0]["digests"]["persistables.meta.json"] == \
        manifests[1]["digests"]["persistables.meta.json"]
    metas = [port_io.load_checkpoint_meta(port_dir),
             ref_io.load_checkpoint_meta(ref_dir)]
    assert [{k: v for k, v in m.items() if k != "dir"} for m in metas] == \
        [{"step": 3, "why": "test"}] * 2
    assert port_io.verify_checkpoint(pc_dir) == (True, "ok")
    assert port_io.verify_checkpoint(rc_dir) == (True, "ok")


def _corrupt(pkg, tmp_path, reference, how):
    d = str(tmp_path / pkg.__name__.replace(".", "_"))
    for step in (1, 2):
        _save(pkg, reference, d, step)
    newest = os.path.join(d, "checkpoint_2")
    if how == "truncated":
        path = os.path.join(newest, "persistables.npz")
        with open(path, "r+b") as f:
            f.truncate(100)
    elif how == "no manifest":
        os.remove(os.path.join(newest, "manifest.json"))
        os.remove(os.path.join(newest, "persistables.npz"))
    elif how == "bad manifest":
        with open(os.path.join(newest, "manifest.json"), "w") as f:
            f.write("{torn")
    else:  # latest.json names a pruned checkpoint
        import shutil
        shutil.rmtree(newest)
    step, _ = _load(pkg, d)
    ok = [pkg.verify_checkpoint(os.path.join(d, "checkpoint_1"))[0]]
    return step, sorted(os.listdir(d)), ok


@pytest.mark.parametrize("how", ["truncated", "no manifest", "bad manifest",
                                 "pruned"])
def test_a_corrupt_checkpoint_is_quarantined_as_the_reference(
        tmp_path, reference, how):
    f0 = port_io._CKPT_FALLBACKS.value
    got = _corrupt(port_io, tmp_path, reference, how)
    want = _corrupt(ref_io, tmp_path, reference, how)
    assert got == want
    assert got[0] == 1
    if how != "pruned":
        assert "corrupt_checkpoint_2" in got[1]
    assert port_io._CKPT_FALLBACKS.value - f0 == 1


def test_keep_last_and_the_corrupt_bound_prune_as_the_reference(
        tmp_path, reference):
    out = []
    for pkg in (port_io, ref_io):
        d = str(tmp_path / pkg.__name__.replace(".", "_"))
        os.makedirs(d)
        for i in range(4):
            os.makedirs(os.path.join(d, "corrupt_checkpoint_%d" % i))
            os.utime(os.path.join(d, "corrupt_checkpoint_%d" % i),
                     (1000 + i, 1000 + i))
        os.makedirs(os.path.join(d, "foreign_dir"))
        os.makedirs(os.path.join(d, "_tmp_checkpoint_9.123"))
        for step in range(1, 6):
            _save(pkg, reference, d, step, keep_last=2)
        out.append(sorted(os.listdir(d)))
    assert out[0] == out[1] == [
        "checkpoint_4", "checkpoint_5", "corrupt_checkpoint_2",
        "corrupt_checkpoint_3", "foreign_dir", "latest.json"]


def test_checkpoint_crash_leaves_no_half_written_dir(tmp_path, reference):
    d = str(tmp_path)
    _save(port_io, reference, d, 1)
    faults.arm("checkpoint_crash", at=2)
    from paddle_tpu_torch import config
    assert config.get_flag("fault_injection")
    with pytest.raises(faults.InjectedFault):
        _save(port_io, reference, d, 2)
    assert sorted(os.listdir(d)) == ["checkpoint_1", "latest.json"]
    assert port_io.load_checkpoint_meta(d)["step"] == 1
    assert _load(port_io, d)[0] == 1
    # the next save goes through
    _save(port_io, reference, d, 3)
    assert _load(port_io, d)[0] == 3


def test_latest_json_is_a_hint_not_an_override(tmp_path, reference):
    d = str(tmp_path)
    for step in (1, 2):
        _save(port_io, reference, d, step)
    # a crash between the publish and the latest.json rewrite
    with open(os.path.join(d, "latest.json"), "w") as f:
        json.dump({"step": 1, "dir": "/elsewhere/checkpoint_1"}, f)
    assert _load(port_io, d)[0] == 2
    assert port_io._checkpoint_candidates(d) == \
        ref_io._checkpoint_candidates(d)


@pytest.mark.parametrize("writer,reader", [(port_io, ref_io),
                                           (ref_io, port_io)])
def test_params_cross_in_both_directions(tmp_path, reference, writer,
                                         reader):
    main, _, _ = _program(writer is ref_io)
    if writer is ref_io:
        writer.save_params(ptpu.Executor(), str(tmp_path), main,
                           scope=_ref_scope(reference))
    else:
        writer.save_params(pc.Executor(device="cpu"), str(tmp_path), main,
                           scope=_port_scope(reference))
    rmain, _, _ = _program(reader is ref_io)
    if reader is ref_io:
        scope = ptpu.Scope()
        names = reader.load_params(ptpu.Executor(), str(tmp_path), rmain,
                                   scope=scope)
        got = {n: np.asarray(scope.find_var(n)) for n in names}
    else:
        scope = pc.Scope()
        names = reader.load_params(pc.Executor(device="cpu"),
                                   str(tmp_path), rmain, scope=scope)
        got = {n: scope.find_var(n).numpy() for n in names}
    assert sorted(got) == sorted(n for n in reference
                                 if n.startswith("fc_") and "_acc_" not in n)
    for name, g in got.items():
        assert _bits_equal(g, reference[name]), name
    # the port's dict form of the same files
    plain = port_io.load_params(str(tmp_path))
    assert sorted(plain) == sorted(got)
