"""The port's Executor (``paddle_tpu_torch/core/executor.py``) against
the reference's semantics.

* Counterparts of the nine tests of ``tests/test_executor.py``
  (persistable state across runs, the RNG key's advance and seed, feed
  shapes, a scope shared by two programs, the three NaN-guard tests, an
  uninitialized parameter), with the slice's ops (``sum`` for
  ``increment``, ``uniform_random`` for ``dropout``, ``elementwise_add``
  for ``scale``, an inf - inf for ``log(-1)``).
* The RNG: ``random_ops.split`` and the key of every random op bitwise
  JAX's; a startup program's ``uniform_random`` draws bitwise the
  reference's, its ``gaussian_random`` within 4 ulp at max(|x|, 1).
* ``nonfinite_guard`` leaves the state as it was (the key still
  advances); ``amp`` is read at each run; update ops write into the
  scope's tensors in place; temporaries leave the environment after
  their last reader; what is not ported raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import executor as port_exe
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.core.framework import RNG_STATE_VAR
from paddle_tpu_torch.initializer import Constant, Normal, Uniform
from paddle_tpu_torch.ops import random_ops
from paddle_tpu_torch.param_attr import ParamAttr


def _exe():
    return pc.Executor(device="cpu")


def _to_ref(program):
    return ref_ser.program_from_dict(
        json.loads(json.dumps(port_ser.program_to_dict(program))))


@pytest.fixture
def flags():
    yield port_config
    port_config.set_flags(check_nan_inf=False, nonfinite_guard=False,
                          amp=None)


def _counter_program():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        main.global_block().create_var(
            name="counter", shape=[1], dtype="float32", persistable=True,
            stop_gradient=True)
        svar = startup.global_block().create_var(
            name="counter", shape=[1], dtype="float32", persistable=True)
        Constant(0.0)(svar, startup.global_block())
        one = layers.fill_constant([1], "float32", 1.0)
        main.global_block().append_op(
            "sum", inputs={"X": ["counter", one.name]},
            outputs={"Out": ["counter"]}, infer_shape=False)
    return main, startup


def test_persistable_state_survives_runs():
    main, startup = _counter_program()
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    for _ in range(5):
        exe.run(main, scope=scope)
    np.testing.assert_allclose(scope.find_var("counter").numpy(), [5.0])
    # the global scope by default, as the reference
    with pc.scope_guard(pc.Scope()):
        exe.run(startup)
        exe.run(main)
        assert float(pc.global_scope().find_var("counter")) == 1.0


def _uniform_program(seed=None, n=100):
    main = pc.Program()
    main.random_seed = seed
    with pc.program_guard(main, pc.Program()):
        out = main.global_block().create_var(name="u", shape=[n],
                                             dtype="float32")
        Uniform(-1.0, 1.0)(out, main.global_block())
    return main, out


def test_rng_state_advances():
    main, out = _uniform_program()
    exe, scope = _exe(), pc.Scope()
    a, = exe.run(main, fetch_list=[out], scope=scope)
    b, = exe.run(main, fetch_list=[out], scope=scope)
    assert not np.array_equal(a, b), "draws must differ across runs"
    assert scope.has_var(RNG_STATE_VAR)
    # bitwise the reference's draws and keys, run for run
    ref = _to_ref(main)
    rexe, rscope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(rscope):
        ra, = rexe.run(ref, fetch_list=["u"])
        rb, = rexe.run(ref, fetch_list=["u"])
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(b, rb)
    np.testing.assert_array_equal(scope.find_var(RNG_STATE_VAR).numpy(),
                                  np.asarray(rscope.find_var(RNG_STATE_VAR)))


def test_rng_seed_reproducible():
    def run_once():
        main, out = _uniform_program(seed=42, n=50)
        return _exe().run(main, fetch_list=[out], scope=pc.Scope())[0]
    a = run_once()
    np.testing.assert_array_equal(a, run_once())
    main, _ = _uniform_program(seed=7, n=50)
    assert not np.array_equal(
        a, _exe().run(main, fetch_list=["u"], scope=pc.Scope())[0])


def test_fetch_multiple_and_feed_shapes_respecialize():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        y = layers.elementwise_add(x, x)
        z = layers.elementwise_add(y, x)
    exe = _exe()
    for bs in (2, 8, 3):
        xv = np.ones((bs, 4), dtype="float32")
        yv, zv = exe.run(main, feed={"x": xv}, fetch_list=[y, z],
                         scope=pc.Scope())
        assert yv.shape == (bs, 4)
        np.testing.assert_allclose(zv, 3 * xv)
    # one plan for the program and fetch list, whatever the feed shapes
    assert exe.compile_stats() == {"entries": 1, "compiles": 1}


def test_two_programs_share_scope_params():
    main, startup = pc.Program(), pc.Program()
    test_prog = pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        h = layers.fc(x, 3, param_attr=ParamAttr(name="w"), bias_attr=False)
    with pc.program_guard(test_prog, startup):
        x2 = layers.data("x", shape=[4])
        h2 = layers.fc(x2, 3, param_attr=ParamAttr(name="w"),
                       bias_attr=False)
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).randn(2, 4).astype("float32")
    a, = exe.run(main, feed={"x": xv}, fetch_list=[h], scope=scope)
    b, = exe.run(test_prog, feed={"x": xv}, fetch_list=[h2], scope=scope)
    np.testing.assert_allclose(a, b, rtol=1e-6)


def _nan_program():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        y = layers.data("y", shape=[4])
        s = layers.elementwise_add(x, y)     # inf + -inf -> NaN
        z = layers.relu(s)
    return main, s, z


def test_nan_guard_raises_with_offending_op_key(flags):
    """FLAGS_check_nan_inf parity: a non-finite op output fails the step
    with the ``op#i:type:var`` key of the producer and of the consumers
    the NaN reached."""
    main, s, z = _nan_program()
    flags.set_flags(check_nan_inf=True)
    inf = np.full((2, 4), np.inf, "float32")
    with pytest.raises(FloatingPointError) as ei:
        _exe().run(main, feed={"x": inf, "y": -inf}, fetch_list=[z],
                   scope=pc.Scope())
    msg = str(ei.value)
    assert "NaN/Inf detected" in msg
    assert ":elementwise_add:" in msg and "op#0" in msg and s.name in msg
    assert ":relu:" in msg
    # the keys are the reference's
    ptpu.config.set_flags(check_nan_inf=True)
    try:
        with pytest.raises(FloatingPointError) as ri:
            ptpu.Executor().run(_to_ref(main), feed={"x": inf, "y": -inf},
                                fetch_list=[z.name])
    finally:
        ptpu.config.set_flags(check_nan_inf=False)
    assert sorted(msg.split(": ", 1)[1].split(", ")) == \
        sorted(str(ri.value).split(": ", 1)[1].split(", "))


def test_nan_guard_passes_finite_program(flags):
    main, s, z = _nan_program()
    flags.set_flags(check_nan_inf=True)
    out, = _exe().run(main, feed={"x": np.ones((2, 4), "float32"),
                                  "y": np.ones((2, 4), "float32")},
                      fetch_list=[z], scope=pc.Scope())
    np.testing.assert_allclose(out, 2.0)


def test_nan_guard_off_lets_nan_through():
    main, s, z = _nan_program()
    inf = np.full((2, 4), np.inf, "float32")
    out, = _exe().run(main, feed={"x": inf, "y": -inf}, fetch_list=[s],
                      scope=pc.Scope())
    assert np.isnan(out).all()


def test_uninitialized_param_raises():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        h = layers.fc(x, 3)
    with pytest.raises(RuntimeError, match="startup"):
        _exe().run(main, feed={"x": np.ones((1, 4), "float32")},
                   fetch_list=[h], scope=pc.Scope())


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5])
def test_split_is_jax_split(seed):
    key = jax.random.PRNGKey(seed)
    ours = random_ops.split(random_ops.prng_key(seed))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jax.random.split(key)))
    np.testing.assert_array_equal(
        random_ops.split(random_ops.prng_key(seed), 5).numpy(),
        np.asarray(jax.random.split(key, 5)))


@pytest.mark.parametrize("std,mean", [(1.0, 0.0), (0.0625, 0.0),
                                      (0.3, 1.5)])
def test_startup_draws_are_the_reference_draws(std, mean):
    """One startup program with a Normal and a Uniform initializer (as
    the front end appends them), seeded: the uniforms bitwise, the
    normals within 4 ulp at max(|x|, 1) (XLA's float32 erf_inv, emulated
    to 2 ulp), the key after the run bitwise."""
    startup = pc.Program()
    startup.random_seed = 5
    block = startup.global_block()
    g = block.create_var(name="g", shape=[64, 3, 7, 7], persistable=True)
    u = block.create_var(name="u", shape=[300, 40], persistable=True)
    Normal(mean, std)(g, block)
    Uniform(-0.25, 0.25)(u, block)
    scope = pc.Scope()
    _exe().run(startup, scope=scope)
    rscope = ptpu.Scope()
    with ptpu.scope_guard(rscope):
        ptpu.Executor().run(_to_ref(startup))
    np.testing.assert_array_equal(scope.find_var("u").numpy(),
                                  np.asarray(rscope.find_var("u")))
    ours, theirs = scope.find_var("g").numpy(), np.asarray(
        rscope.find_var("g"))
    ulp = np.spacing(np.maximum(np.abs(theirs), 1).astype(np.float32))
    assert (np.abs(ours.astype(np.float64) - theirs) / ulp).max() <= 4
    np.testing.assert_array_equal(scope.find_var(RNG_STATE_VAR).numpy(),
                                  np.asarray(rscope.find_var(RNG_STATE_VAR)))


def test_normal_is_jax_normal_within_4_ulp():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.normal(key, (200000,), jnp.float32))
    got = random_ops.normal(random_ops.prng_key(9), 200000).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) / ulp).max() <= 4


def _momentum_program(lr=0.1):
    main, startup = pc.Program(), pc.Program()
    startup.random_seed = 1
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        y = layers.data("y", shape=[1], dtype="int64")
        logits = layers.fc(x, 3)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        port_opt.Momentum(lr, 0.9).minimize(loss, startup)
    return main, startup, loss


def _feed(bad=False):
    x = np.random.RandomState(2).randn(6, 4).astype("float32")
    if bad:
        x[0, 0] = np.nan
    return {"x": x, "y": np.array([[0], [1], [2], [0], [1], [2]])}


def test_nonfinite_guard_leaves_state_unchanged(flags):
    main, startup, loss = _momentum_program()
    main.random_seed = 3
    # a random op in the step, so the key is state too
    out = main.global_block().create_var(name="noise", shape=[2])
    Uniform()(out, main.global_block())
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    flags.set_flags(nonfinite_guard=True)
    before = {n: scope.find_var(n).clone() for n in scope.var_names()}
    l, = exe.run(main, feed=_feed(bad=True), fetch_list=[loss], scope=scope)
    assert np.isnan(l)
    for n, v in before.items():
        same = torch.equal(scope.find_var(n), v)
        assert same != (n == RNG_STATE_VAR), n     # only the key moved
    l, = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert np.isfinite(l)
    assert not torch.equal(scope.find_var("fc_0.w_0"), before["fc_0.w_0"])


def test_updates_write_into_the_scope_tensors():
    """Momentum's ParamOut and VelocityOut name its inputs: the update
    lands in the scope's own tensors (the reference's donated buffers);
    the running step matches the reference's."""
    main, startup, loss = _momentum_program()
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    w, v = scope.find_var("fc_0.w_0"), scope.find_var(
        "fc_0.w_0_velocity_acc_0")
    w0 = w.clone()
    losses = [exe.run(main, feed=_feed(), fetch_list=[loss],
                      scope=scope)[0] for _ in range(3)]
    assert scope.find_var("fc_0.w_0") is w and not torch.equal(w, w0)
    assert scope.find_var("fc_0.w_0_velocity_acc_0") is v
    rexe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        rexe.run(_to_ref(startup))
        want = [rexe.run(_to_ref(main), feed=_feed(),
                         fetch_list=[loss.name])[0] for _ in range(3)]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    # donate_state=False: new tensors, the same values
    w1 = scope.find_var("fc_0.w_0")
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope,
            donate_state=False)
    assert scope.find_var("fc_0.w_0") is not w1


def test_amp_is_read_at_each_run(flags):
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        h = layers.fc(x, 3, bias_attr=False)
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), "float32")}
    dtypes = []
    for amp in (None, "bfloat16", None):
        flags.set_flags(amp=amp)
        out, = exe.run(main, feed=feed, fetch_list=[h], scope=scope,
                       return_numpy=False)
        dtypes.append(out.dtype)
    assert dtypes == [torch.float32, torch.bfloat16, torch.float32]
    # one plan for the startup program, one for main: the flag is read
    # at each run and plans nothing anew
    assert exe.compile_stats()["compiles"] == 2


def test_temporaries_leave_after_their_last_reader():
    main, startup, loss = _momentum_program()
    plan = port_exe._Plan(main.global_block(), [loss.name])
    dropped = [n for names in plan.drops.values() for n in names]
    assert len(dropped) == len(set(dropped))
    assert loss.name not in dropped and "fc_0.w_0" not in dropped
    assert "fc_0.w_0@GRAD" in dropped and "x" in dropped
    ops = main.global_block().ops
    for i, names in plan.drops.items():
        for n in names:
            assert n in ops[i].input_names() + ops[i].output_names()
            assert all(n not in op.input_names() + op.output_names()
                       for op in ops[i + 1:])


def test_no_edge_kept_for_an_output_without_gradient(monkeypatch):
    """A differentiated op's output that no gradient reaches keeps no
    autograd edge to its ``vjp_grad``: ``softmax_with_cross_entropy``'s
    Softmax (the edge would hold the exp node and its [N, V] result);
    its Loss keeps one."""
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[6])
        label = layers.data("label", shape=[1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(x, 5), label))
        port_opt.SGD(0.1).minimize(loss, startup)
    seen = {}
    real = port_exe._execute_vjp_grad

    def spy(op, env, block, trace):
        fwd = op.attrs["fwd_op"]
        if fwd.type == "softmax_with_cross_entropy":
            roots, _ = trace.vjp_cache[id(fwd)]
            seen.update(zip(("Loss", "Softmax"), roots))
        return real(op, env, block, trace)
    monkeypatch.setattr(port_exe, "_execute_vjp_grad", spy)
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype(np.float32),
            "label": np.array([[0], [4], [2], [1]])}
    out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out)
    assert seen["Loss"] is not None and seen["Softmax"] is None


def test_what_is_not_ported_raises():
    exe = _exe()
    for call in (exe.lower, exe.cache_digest, exe.prime_aot,
                 exe.as_jax_function):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A, \"The compile cache"):
            call(pc.Program())
    with pytest.raises(NotImplementedError, match="Distribution"):
        pc.Executor(device="cpu", strategy=object())
    # narrow-wire feeds are ported: the declaration no longer raises
    w = layers.data("w", shape=[2], wire_dtype="uint8", scale=0.5)
    assert str(w.wire_dtype) == "uint8" and w.ingest["scale"] == 0.5
    with pytest.raises(TypeError, match="Program"):
        exe.run("not a program")


def test_gradients_hold_edges_not_tensors(monkeypatch):
    """Between a forward op and its ``vjp_grad`` the executor holds the
    autograd edges of the op's outputs and differentiated inputs, with
    their shapes, dtypes and devices: no tensor, so each goes with its
    last reader unless the op's backward saves it (what the backward
    reads, autograd saves)."""
    main, startup, loss = _momentum_program()
    seen = []
    real = port_exe._execute_vjp_grad

    def check(op, env, block, trace):
        if not seen:
            for roots, inputs in trace.vjp_cache.values():
                for root in roots + inputs:
                    if root is not None:
                        edge, shape, dtype, device = root
                        assert isinstance(
                            edge, torch.autograd.graph.GradientEdge)
                        assert isinstance(shape, torch.Size)
                assert any(r is not None for r in inputs)
            seen.append(len(trace.vjp_cache))
        return real(op, env, block, trace)
    monkeypatch.setattr(port_exe, "_execute_vjp_grad", check)
    exe, scope = _exe(), pc.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert seen == [4]   # mul, elementwise_add, the loss, mean


def test_an_input_is_not_held_for_its_gradient():
    """relu saves its output, not its input: under the executor as under
    autograd alone, relu's input leaves memory after its last reader,
    though relu's gradient is still to come."""
    import gc
    import weakref
    x = torch.randn(4, 8)
    trace = port_exe._TraceState()
    v = port_exe._Input.apply(x.detach(), trace.anchor)
    ref = weakref.ref(v)
    out = torch.relu(v)
    edge = port_exe._grad_root(v)
    out_edge = port_exe._grad_root(out)
    del v, out
    gc.collect()
    assert ref() is None
    g, = torch.autograd.grad([out_edge[0]], [edge[0]], [torch.ones(4, 8)])
    torch.testing.assert_close(g, (x > 0).float())
