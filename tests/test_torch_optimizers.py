"""The update rules, optimizers, regularizers, gradient clips, per-
parameter learning rates, ``global_step``, ``ModelAverage`` and learning-
rate schedules of the LeNet-5/MNIST slice, against the reference.

* The 8 new update ops over 3 steps, each step's outputs fed to the
  next, in place (the executor's donated form: outputs naming inputs)
  and functional, against the reference's op: within 4 float32 ulp of
  each tensor's largest magnitude a step (XLA and torch differ in the
  last bit of a ``sqrt`` quotient now and then).
* Programs: a two-layer fc net built alike in both packages (byte-
  identical programs), the port's scope a copy of the reference's
  startup scope, 3 ``Executor.run`` steps on the same feeds: every
  persistable (parameters, accumulators, beta powers, the learning
  rate, ``global_step``, ModelAverage's sums) within 1e-5 of its
  largest magnitude, the losses within 1e-5.
* The schedules' values equal the reference's step by step, and a
  schedule's ``step`` writes a one-element float32 tensor on the
  learning rate's device into the scope.
"""

import json
import types

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import clip as ref_clip
from paddle_tpu import layers as ref_layers
from paddle_tpu import lr_scheduler as ref_lrs
from paddle_tpu import optimizer as ref_opt
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import clip as port_clip
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import lr_scheduler as port_lrs
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.core import registry as port_registry
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.param_attr import ParamAttr as PortParamAttr
from paddle_tpu_torch.probes.op_cases import UPDATE_OUTPUTS, UPDATE_RULES
from test_torch_ops_cases import CASES, run_port, run_ref
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ULP4 = 4 * 2.0 ** -23
RTOL = 1e-5

_OUT = UPDATE_OUTPUTS
RULES = [c for c in CASES if c.op_type in UPDATE_RULES]


def _in_place_step(case, inputs):
    """One step of the port's op with its outputs naming its inputs and
    the executor's in-place permission: returns the updated inputs and
    checks they were written into the given tensors."""
    op = types.SimpleNamespace(
        type=case.op_type, attrs=case.attrs,
        inputs={k: [k] for k in inputs},
        outputs={_OUT[k]: [k] for k in inputs if k in _OUT})
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    trace = types.SimpleNamespace(device=torch.device("cpu"), inplace=True)
    ctx = port_registry.ExecContext(op, {k: [v] for k, v in
                                         tensors.items()}, trace=trace)
    out = port_registry.get_op_def(case.op_type).compute(ctx)
    for k in inputs:
        if k in _OUT:
            assert out[_OUT[k]] is tensors[k], (case.id, k)
    return {k: t.numpy() for k, t in tensors.items()}


@pytest.mark.parametrize("case", RULES, ids=lambda c: c.id)
def test_update_rule_three_steps(case):
    ref_in = case.inputs()
    fun_in = dict(ref_in)
    inp_in = dict(ref_in)
    rs = np.random.RandomState(5)
    for step in range(3):
        grad = rs.standard_normal(ref_in["Grad"].shape).astype(np.float32)
        for d in (ref_in, fun_in, inp_in):
            d["Grad"] = grad
        ref = run_ref(case, ref_in)
        fun = run_port(case, fun_in)
        inp = _in_place_step(case, inp_in)
        for k in ref_in:
            if k not in _OUT:
                continue
            want = ref[_OUT[k]][0]
            for got in (fun[_OUT[k]][0], inp[k]):
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got - want).max()) <= \
                    (step + 1) * ULP4 * scale, (case.id, k, step)
            ref_in[k] = want
            fun_in[k] = fun[_OUT[k]][0]
            inp_in[k] = inp[k]


# -- programs ----------------------------------------------------------------

def _net(pkg, make_opt, param_attrs=(None, None), global_step=False,
         average=False):
    """A 6 -> 8 -> 3 fc classifier with ``make_opt(module)``'s optimizer
    (``module`` the package's optimizer module, or a dict of its
    modules)."""
    ref = pkg == "ref"
    fw = ptpu if ref else pc
    L = ref_layers if ref else port_layers
    mods = dict(opt=ref_opt if ref else port_opt,
                reg=ref_reg if ref else port_reg,
                clip=ref_clip if ref else port_clip,
                attr=ptpu.ParamAttr if ref else PortParamAttr)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 9
    extra = {}
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[6])
        y = L.data("y", shape=[1], dtype="int64")
        attrs = [a(mods) if callable(a) else a for a in param_attrs]
        h = L.fc(x, 8, act="tanh", param_attr=attrs[0])
        loss = L.mean(L.softmax_with_cross_entropy(
            L.fc(h, 3, param_attr=attrs[1]), y))
        kw = {}
        if global_step:
            gs = main.global_block().create_var(
                name="global_step", shape=[1], dtype="float32",
                persistable=True)
            sv = startup.global_block().create_var(
                name="global_step", shape=[1], dtype="float32",
                persistable=True)
            _const_init(pkg)(sv, startup.global_block())
            kw["global_step"] = gs
        opt = make_opt(mods, **kw)
        opt.minimize(loss, startup)
        if average:
            extra["average"] = mods["opt"].ModelAverage(main, startup)
    extra["opt"] = opt
    return main, startup, loss, extra


def _const_init(pkg):
    if pkg == "ref":
        from paddle_tpu.initializer import ConstantInitializer
    else:
        from paddle_tpu_torch.initializer import ConstantInitializer
    return ConstantInitializer(0.0)


def _feeds(steps=3):
    rs = np.random.RandomState(1)
    return [{"x": rs.randn(5, 6).astype(np.float32),
             "y": rs.randint(0, 3, (5, 1)).astype(np.int64)}
            for _ in range(steps)]


def _run_both(make_opt, steps=3, between=None, **kw):
    """Build the net in both packages, check the programs serialize
    alike, copy the reference's startup scope into the port, run
    ``steps`` steps on each and compare the losses and every
    persistable; ``between(pkg, step, scope, extra)`` runs after each
    step. Returns both scopes."""
    built = {pkg: _net(pkg, make_opt, **kw) for pkg in ("ref", "port")}
    for i in (0, 1):
        assert json.dumps(port_ser.program_to_dict(built["port"][i])) == \
            json.dumps(ref_ser.program_to_dict(built["ref"][i]))
    main, startup, loss, extra = built["ref"]
    exe = ptpu.Executor()
    ref_scope = ptpu.Scope()
    losses = {"ref": [], "port": []}
    with ptpu.scope_guard(ref_scope):
        exe.run(startup)
        named = {n: np.array(ref_scope.find_var(n))
                 for n in ref_scope.var_names()}
        pmain, _, ploss, pextra = built["port"]
        pexe = pc.Executor(device="cpu")
        port_scope = port_io.scope_from_jax(named, device="cpu")
        for step, feed in enumerate(_feeds(steps)):
            losses["ref"].append(float(exe.run(main, feed=feed,
                                               fetch_list=[loss])[0]))
            losses["port"].append(float(pexe.run(
                pmain, feed=feed, fetch_list=[ploss],
                scope=port_scope)[0]))
            if between is not None:
                between("ref", step, ref_scope, extra)
                between("port", step, port_scope, pextra)
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=RTOL)
    names = [n for n in ref_scope.var_names() if n != "@RNG_STATE@"]
    assert sorted(names) == sorted(n for n in port_scope.var_names()
                                   if n != "@RNG_STATE@")
    for n in names:
        want = np.asarray(ref_scope.find_var(n))
        got = port_scope.find_var(n).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, n
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= RTOL * scale, n
    return ref_scope, port_scope, built


OPTIMIZERS = {
    "adagrad": lambda m, **kw: m["opt"].Adagrad(0.1, **kw),
    "adamax": lambda m, **kw: m["opt"].Adamax(0.05, **kw),
    "decayed_adagrad": lambda m, **kw: m["opt"].DecayedAdagrad(0.1, **kw),
    "adadelta": lambda m, **kw: m["opt"].AdaDelta(**kw),
    "rmsprop": lambda m, **kw: m["opt"].RMSProp(0.01, momentum=0.9, **kw),
    "ftrl": lambda m, **kw: m["opt"].Ftrl(0.1, l1=0.01, l2=0.01, **kw),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps(name):
    _run_both(OPTIMIZERS[name])


@pytest.mark.parametrize("kind", ["l2", "l1", "param_l1_over_l2"])
def test_regularization_three_steps(kind):
    if kind == "param_l1_over_l2":
        # the parameter's own regularizer wins over the optimizer's
        _run_both(lambda m, **kw: m["opt"].SGD(
                      0.1, regularization=m["reg"].L2Decay(0.1), **kw),
                  param_attrs=(lambda m: m["attr"](
                      regularizer=m["reg"].L1Decay(0.05)), None))
        return
    decay = {"l2": lambda m: m["reg"].L2Decay(0.1),
             "l1": lambda m: m["reg"].L1Decay(0.05)}[kind]
    _run_both(lambda m, **kw: m["opt"].Momentum(
        0.1, 0.9, regularization=decay(m), **kw))


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm",
                                  "global"])
def test_gradient_clip_three_steps(kind):
    clip = {"value": lambda m: m["clip"].GradientClipByValue(0.05),
            "norm": lambda m: m["clip"].GradientClipByNorm(0.1),
            "global_norm": lambda m: m["clip"].GradientClipByGlobalNorm(
                0.1)}
    if kind == "global":
        # the process-wide clip of set_gradient_clip
        ref_clip.set_gradient_clip(ref_clip.GradientClipByGlobalNorm(0.1))
        port_clip.set_gradient_clip(port_clip.GradientClipByGlobalNorm(0.1))
        try:
            _run_both(lambda m, **kw: m["opt"].SGD(0.5, **kw))
        finally:
            ref_clip.set_gradient_clip(None)
            port_clip.set_gradient_clip(None)
        return
    attr = (lambda m: m["attr"](gradient_clip=clip[kind](m)))
    _run_both(lambda m, **kw: m["opt"].SGD(0.5, **kw),
              param_attrs=(attr, attr))


def test_per_parameter_learning_rate_and_global_step():
    """A parameter's ``learning_rate`` multiple is a ``scale`` of the
    learning rate; ``global_step`` counts the steps."""
    _, port_scope, _ = _run_both(
        lambda m, **kw: m["opt"].Adam(0.01, **kw),
        param_attrs=(lambda m: m["attr"](learning_rate=3.0), None),
        global_step=True)
    assert port_scope.find_var("global_step").tolist() == [3.0]


def test_model_average_apply_and_restore():
    """The averaged parameters swapped in and the trained ones back, as
    the reference's."""
    seen = {}

    def between(pkg, step, scope, extra):
        if step != 2:
            return
        avg = extra["average"]
        params = avg._param_names
        before = {n: np.array(_host(scope.find_var(n))) for n in params}
        with (ptpu.scope_guard(scope) if pkg == "ref"
              else _nullcontext()):
            with avg.apply(scope):
                seen[pkg, "avg"] = {n: np.array(_host(scope.find_var(n)))
                                    for n in params}
        seen[pkg, "restored"] = {n: np.array(_host(scope.find_var(n)))
                                 for n in params}
        seen[pkg, "before"] = before
    _run_both(lambda m, **kw: m["opt"].Momentum(0.1, 0.9, **kw),
              between=between, average=True)
    for what in ("avg", "restored"):
        for n, want in seen["ref", what].items():
            np.testing.assert_allclose(seen["port", what][n], want,
                                       rtol=RTOL, atol=1e-7)
    for n, want in seen["port", "before"].items():
        np.testing.assert_array_equal(seen["port", "restored"][n], want)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


SCHEDULES = {
    "exponential": lambda m, o: m.ExponentialDecay(o, 2, 0.5),
    "exponential_staircase": lambda m, o: m.ExponentialDecay(
        o, 2, 0.5, staircase=True),
    "natural_exp": lambda m, o: m.NaturalExpDecay(o, 3, 0.2),
    "inverse_time": lambda m, o: m.InverseTimeDecay(o, 2, 0.7),
    "polynomial": lambda m, o: m.PolynomialDecay(o, 4, end_lr=0.01,
                                                 power=2.0),
    "polynomial_cycle": lambda m, o: m.PolynomialDecay(
        o, 3, end_lr=0.01, cycle=True),
    "piecewise": lambda m, o: m.PiecewiseDecay(o, [2, 4],
                                               [0.1, 0.05, 0.01]),
    "warmup": lambda m, o: m.LinearWarmup(o, 3, start_lr=0.0),
    "warmup_inner": lambda m, o: m.LinearWarmup(
        o, 2, start_lr=0.01, inner=m.ExponentialDecay(o, 2, 0.5)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_values(name):
    ref = SCHEDULES[name](ref_lrs, ref_opt.SGD(0.2))
    port = SCHEDULES[name](port_lrs, port_opt.SGD(0.2))
    assert [port.get_lr(s) for s in range(12)] == \
        [ref.get_lr(s) for s in range(12)]


def test_lr_schedule_drives_training():
    """A schedule stepped between runs: the learning rate crosses into
    the scope as a [1] float32 tensor, the updates follow it."""
    def between(pkg, step, scope, extra):
        sched = extra.setdefault("sched", SCHEDULES["piecewise"](
            ref_lrs if pkg == "ref" else port_lrs, extra["opt"]))
        lr = sched.step(scope)
        if pkg == "port":
            t = scope.find_var(extra["opt"]._lr_var.name)
            assert isinstance(t, torch.Tensor) and t.shape == (1,) and \
                t.dtype == torch.float32 and t.tolist() == [
                    float(np.float32(lr))]
    _run_both(lambda m, **kw: m["opt"].SGD(0.2, **kw), steps=5,
              between=between)


def test_program_only_optimizers_refuse_module_parameters():
    with pytest.raises(TypeError, match="program form only"):
        port_opt.Adagrad({"w": torch.zeros(2)}, 0.1)
    with pytest.raises(TypeError, match="program form"):
        port_opt.Adam({"w": torch.zeros(2)}, 0.1,
                      regularization=port_reg.L2Decay(0.1))
