"""The transformer LM through the port's program path (front end,
``Adam.minimize``, ``Executor``) against the reference's program, as
``bench.py`` builds it (``transformer_lm(toks, lbls, ...)``,
``Adam(lr).minimize``, ``Executor.run``), at a small width: vocab 100,
d_model 64, 2 heads, d_ff 128, 2 layers, T 64, batch 4, Adam(1e-3).

The reference runs with its ``flash_attention`` flag on (its Pallas
kernel interpreted, as ``tests/test_torch_lm_train.py`` runs it) and, in
one case, off (its dense attention). The port runs on the CPU, where
``multihead_attention`` takes B2's plain version. Both start from the
reference's startup scope (``io.scope_from_jax``; the key of the
reference's scope is carried over where a program draws from it).

* Programs: built by either package they serialize byte-identical (the
  plain, dropout, ``length`` and ``is_test`` forms, main and startup);
  the reference trains the port-built program from its JSON, the port
  the reference's.
* Startup: ``uniform_random`` draws bitwise the reference's,
  ``gaussian_random`` within 4 ulp at max(|x|, 1), the constants and the
  key equal.
* 3 Adam steps, amp off and on (PERF.md §2's small-LM bounds): losses
  within 1e-4 relative (amp: 1e-2), first-step gradients within 1e-4 of
  each tensor's norm (amp off), every parameter within 2 lr a step of
  the reference's, and Adam's accumulators: the beta powers equal, the
  moments within 1e-4 of each tensor's norm (amp off) and 5e-2 (amp:
  squared bf16 gradients summed in other orders).
* The ``length`` form and the flash-off reference to the same bounds.
* ``dropout_prob`` 0.1: the first step's dropout masks bitwise the
  reference's, the losses within 1e-4.
* After one step, the program route equals the port's ``nn.Module``
  route (``TransformerLM``, ``trainer.train_step``) from the same
  weights: loss within 1e-5 relative, parameters within 2 lr, and Adam's
  moments, which hold the gradients, within 1e-4 of each tensor's norm.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.core.framework import RNG_STATE_VAR
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import trainer
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import transformer as port_tf
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NET = dict(vocab_size=100, d_model=64, num_heads=2, d_ff=128, num_layers=2)
T, B, LR, STEPS = 64, 4, 1e-3, 3
LOSS_RTOL = {None: 1e-4, "bfloat16": 1e-2}
MOMENT_RTOL = {None: 1e-4, "bfloat16": 5e-2}
FORMS = ("plain", "dropout", "length", "is_test")


def _feeds(length=False):
    rs = np.random.RandomState(0)
    ids = rs.randint(2, NET["vocab_size"], (B, T)).astype("int64")
    feed = {"toks": ids, "lbls": ids}
    if length:
        feed["len"] = np.array([[T], [5], [37], [T - 1]], np.int64)
    return feed


def _build(pkg, form="plain"):
    """(main, startup, loss name, [gradient names]) of the LM program as
    ``pkg`` ("ref" or "port") builds it."""
    ref = pkg == "ref"
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    tf = ref_tf if ref else port_tf
    opt = ptpu.optimizer if ref else port_opt
    with fw.unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        main.random_seed = startup.random_seed = 21
        with fw.program_guard(main, startup):
            toks = layers.data("toks", shape=[T], dtype="int64")
            lbls = layers.data("lbls", shape=[T], dtype="int64")
            kw = dict(NET)
            if form == "length":
                kw["length"] = layers.data("len", shape=[1], dtype="int64")
            if form == "dropout":
                kw["dropout_prob"] = 0.1
            if form == "is_test":
                kw.update(dropout_prob=0.1, is_test=True)
            loss, _ = tf.transformer_lm(toks, lbls, **kw)
            grads = []
            if form != "is_test":
                _, params_grads = opt.Adam(learning_rate=LR).minimize(
                    loss, startup_program=startup)
                grads = [g.name for _, g in params_grads]
    return main, startup, loss.name, grads


def _to_ref(program):
    return ref_ser.program_from_dict(
        json.loads(json.dumps(port_ser.program_to_dict(program))))


def _to_port(program):
    return port_ser.program_from_dict(
        json.loads(json.dumps(ref_ser.program_to_dict(program))))


def _masks(main):
    return [op.outputs["Mask"][0] for op in main.global_block().ops
            if op.type == "dropout"]


def _ref_train(main, startup, loss, grads, amp=None, flash=True,
               form="plain"):
    """{init, losses, grads, masks, after} of the reference's run."""
    ptpu.config.set_flags(flash_attention=flash, amp=amp)
    try:
        exe, scope = ptpu.Executor(), ptpu.Scope()
        masks = _masks(main)
        with ptpu.scope_guard(scope):
            exe.run(startup)
            init = {n: np.array(scope.find_var(n))
                    for n in scope.var_names()}
            losses, first = [], None
            for i in range(STEPS):
                extra = (grads + masks) if i == 0 else []
                outs = exe.run(main, feed=_feeds(form == "length"),
                               fetch_list=[loss] + extra)
                losses.append(float(outs[0]))
                if i == 0:
                    first = [np.asarray(v) for v in outs[1:]]
            after = {n: np.array(scope.find_var(n))
                     for n in scope.var_names() if not n.startswith("@")}
    finally:
        ptpu.config.set_flags(flash_attention=False, amp=None)
    return dict(init=init, losses=losses,
                grads=dict(zip(grads, first[:len(grads)])),
                masks=first[len(grads):], after=after)


def _port_train(main, loss, grads, init, amp=None, form="plain", steps=STEPS):
    scope = port_io.scope_from_jax(init, device="cpu")
    scope.set_var(RNG_STATE_VAR, torch.from_numpy(
        np.asarray(init[RNG_STATE_VAR]).astype(np.int64)))
    exe = pc.Executor(device="cpu")
    masks = _masks(main)
    port_config.set_flags(amp=amp)
    try:
        losses, first = [], None
        for i in range(steps):
            extra = (grads + masks) if i == 0 else []
            outs = exe.run(main, feed=_feeds(form == "length"),
                           fetch_list=[loss] + extra, scope=scope)
            losses.append(float(outs[0]))
            if i == 0:
                first = outs[1:]
    finally:
        port_config.set_flags(amp=None)
    after = {n: v.numpy() for n, v in scope.items() if not n.startswith("@")}
    return dict(losses=losses, grads=dict(zip(grads, first[:len(grads)])),
                masks=first[len(grads):], after=after)


@pytest.fixture(scope="module")
def runs():
    """The reference's runs (each compiles its program once) and the
    port's from the same initial scopes."""
    out = {}
    port_plain = _build("port")
    ref_plain = _build("ref")
    # the reference trains the port-built program, from its JSON
    out["ref", None] = _ref_train(_to_ref(port_plain[0]),
                                  _to_ref(port_plain[1]), *port_plain[2:])
    out["ref", "bfloat16"] = _ref_train(*ref_plain, amp="bfloat16")
    out["ref", "flash off"] = _ref_train(*ref_plain, flash=False)
    for form in ("dropout", "length"):
        out["ref", form] = _ref_train(*_build("ref", form), form=form)
    init = out["ref", None]["init"]
    # the port trains the reference's program, from its JSON, under amp
    out["port", "bfloat16"] = _port_train(
        _to_port(ref_plain[0]), *ref_plain[2:], init, amp="bfloat16")
    out["port", None] = _port_train(port_plain[0], *port_plain[2:], init)
    for form in ("dropout", "length"):
        main, _, loss, grads = _build("port", form)
        out["port", form] = _port_train(main, loss, grads,
                                        out["ref", form]["init"], form=form)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("form", FORMS)
def test_programs_serialize_byte_identical(form):
    ref, port = _build("ref", form), _build("port", form)
    for r, p in zip(ref[:2], port[:2]):
        want = json.dumps(ref_ser.program_to_dict(r))
        assert json.dumps(port_ser.program_to_dict(p)) == want
        assert json.dumps(port_ser.program_to_dict(_to_port(r))) == want
        assert json.dumps(ref_ser.program_to_dict(_to_ref(p))) == want
    assert ref[2:] == port[2:]


def test_lm_program_holds_the_reference_op_counts():
    main = _build("port")[0]
    counts = {}
    for op in main.global_block().ops:
        counts[op.type] = counts.get(op.type, 0) + 1
    assert {k: counts[k] for k in ("lookup_table", "layer_norm",
                                   "multihead_attention", "gelu", "mul",
                                   "adam")} == \
        dict(lookup_table=1, layer_norm=5, multihead_attention=2, gelu=2,
             mul=13, adam=29)


def test_startup_draws_equal_reference(runs):
    """The port's startup program (CPU) against the reference's scope."""
    _, startup, _, _ = _build("port")
    scope = pc.Scope()
    pc.Executor(device="cpu").run(startup, scope=scope)
    want = runs["ref", None]["init"]
    got = {n: v.numpy() for n, v in scope.items()}
    assert sorted(got) == sorted(want)
    kinds = {op.outputs["Out"][0]: op.type
             for op in startup.global_block().ops}
    assert sorted(set(kinds.values())) == ["fill_constant",
                                           "gaussian_random",
                                           "uniform_random"]
    for name, value in want.items():
        if kinds.get(name) == "gaussian_random":
            ulp = np.spacing(np.maximum(np.abs(value), 1.0)
                             .astype(np.float32))
            assert (np.abs(got[name] - value) <= 4 * ulp).all(), name
        else:
            np.testing.assert_array_equal(
                got[name].astype(value.dtype), value, err_msg=name)


def _check_steps(ref, port, amp):
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=LOSS_RTOL[amp])
    assert port["losses"][-1] < port["losses"][0]
    if amp is None:
        worst = max(ref["grads"],
                    key=lambda n: _rel(port["grads"][n], ref["grads"][n]))
        assert _rel(port["grads"][worst], ref["grads"][worst]) <= 1e-4, worst
    assert sorted(port["after"]) == sorted(ref["after"])
    for n, want in ref["after"].items():
        got = port["after"][n]
        assert got.dtype == want.dtype, n
        if "_pow_acc_" in n or n.startswith("learning_rate"):
            np.testing.assert_array_equal(got, want, err_msg=n)
        elif "_moment" in n:
            assert _rel(got, want) <= MOMENT_RTOL[amp], n
        else:
            far = np.abs(got.astype(np.float64) - want).max()
            assert far <= 2 * LR * STEPS, (n, far)


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_three_adam_steps_match_reference(runs, amp):
    _check_steps(runs["ref", amp], runs["port", amp], amp)


def test_flash_off_reference_matches(runs):
    """The reference's dense attention (flash flag off) against the port,
    whose CPU route is B2's plain version."""
    _check_steps(runs["ref", "flash off"], runs["port", None], None)


def test_length_form_matches(runs):
    _check_steps(runs["ref", "length"], runs["port", "length"], None)
    assert runs["port", "length"]["losses"][0] != \
        runs["port", None]["losses"][0]


def test_dropout_masks_bitwise_and_losses_match(runs):
    ref, port = runs["ref", "dropout"], runs["port", "dropout"]
    assert len(port["masks"]) == len(ref["masks"]) == 2 * NET["num_layers"]
    for got, want in zip(port["masks"], ref["masks"]):
        np.testing.assert_array_equal(got, want)
        assert 0.8 < got.mean() < 0.97
    _check_steps(ref, port, None)
    assert port["losses"][0] != runs["port", None]["losses"][0]


def test_program_route_equals_module_route(runs):
    """One step from the same weights through ``Executor.run`` and
    through the nn.Module LM with ``trainer.train_step``."""
    init = runs["ref", None]["init"]
    main, _, loss, grads = _build("port")
    prog = _port_train(main, loss, grads, init, steps=1)
    model = port_tf.TransformerLM(max_len=T, device="cpu", **NET)
    opt = port_opt.Adam(model.reference_parameters(), 0.5)
    port_io.params_from_jax(init, model=model, optimizer=opt)
    feeds = _feeds()
    toks, lbls = (torch.from_numpy(feeds[k]) for k in ("toks", "lbls"))
    mod_loss = float(trainer.train_step(model, opt, toks, lbls)[0])
    assert abs(mod_loss - prog["losses"][0]) <= 1e-5 * abs(mod_loss)
    for n, t in dict(model.reference_tensors(),
                     **opt.accumulators()).items():
        far = np.abs(t.detach().numpy().astype(np.float64)
                     - prog["after"][n]).max()
        assert far <= 2 * LR, (n, far)
        if "_moment" in n:
            assert _rel(t.detach().numpy(), prog["after"][n]) \
                <= MOMENT_RTOL[None], n
