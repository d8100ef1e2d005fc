"""Control flow against the reference (``ops/control_flow_ops.py`` and
``layers/control_flow.py`` in both packages): a ``StaticRNN`` and a
``While(max_iters)`` RNN train 3 Adam steps from the reference's startup
weights to its losses (within 1e-4) and parameters; a ``While`` LSTM
written with ``array_write`` gives the reference's outputs and weight
gradient; an unbounded ``While`` and a ``cond`` give the reference's
outputs and ``cond``'s gradient through the taken branch, reading back
once an iteration or a call (``HOST_READS``); ``append_backward`` refuses
an unbounded ``While``; ``check_nan_inf`` sees a NaN inside the loop.

And the executor's planner, under an emulated CUDA graph on the CPU
(``test_torch_graph_capture.py``'s): a forward program with a bounded
``While`` or a ``StaticRNN`` is captured at its second run and its
replays equal its eager run bitwise; one with an unbounded ``While`` or
a ``cond`` is refused when its plan is made, runs op by op, says why in
``capture_stats()``, and cannot be exported."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.ops import control_flow_ops as cf
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_graph_capture import _emulate

B, T, D, H = 4, 5, 3, 6
LR = 5e-3
STEPS = 3
LOSS_RTOL = 1e-4


pytestmark = pytest.mark.usefixtures("one_thread")


def _pkg(pkg):
    return (ptpu, ref_layers, ptpu.optimizer) if pkg == "ref" else \
        (pc, port_layers, port_opt)


def _static_rnn(pkg, train=True):
    fw, L, opt = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 6
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[T, D])
        y = L.data("y", shape=[1])
        h0 = L.fill_constant_batch_size_like(x, shape=[-1, H],
                                             dtype="float32", value=0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = L.fc([x_t, h_prev], H, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        last = L.sequence_pool(rnn(), "last")
        pred = L.fc(last, 1)
        loss = L.mean(L.square_error_cost(pred, y))
        if train:
            opt.Adam(learning_rate=LR).minimize(loss, startup)
    return main, startup, loss


def _while_rnn(pkg, train=True, max_iters=T):
    fw, L, opt = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 7
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[T, D])
        y = L.data("y", shape=[1])
        xt = L.transpose(x, perm=[1, 0, 2])
        i = L.fill_constant([1], "int32", 0)
        n = L.fill_constant([1], "int32", T)
        h = L.fill_constant_batch_size_like(x, shape=[-1, H],
                                            dtype="float32", value=0.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v, max_iters=max_iters)
        with w.block():
            x_t = L.reshape(L.gather(xt, i), [-1, D])
            h2 = L.fc([x_t, h], H, act="tanh")
            L.assign(h2, h)
            i2 = L.increment(i, 1, in_place=False)
            L.assign(i2, i)
            L.assign(L.less_than(i2, n), cond_v)
        pred = L.fc(h, 1)
        loss = L.mean(L.square_error_cost(pred, y))
        if train:
            opt.Adam(learning_rate=LR).minimize(loss, startup)
    return main, startup, loss


def _feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xv = rs.randn(B, T, D).astype(np.float32)
        out.append({"x": xv, "y": xv.sum(axis=(1, 2)).reshape(-1, 1) * 0.1})
    return out


@pytest.mark.parametrize("build", [_static_rnn, _while_rnn],
                         ids=["static_rnn", "while"])
def test_rnn_trains_as_the_reference(build):
    main, startup, loss = build("ref")
    pmain, pstartup, ploss = build("port")
    for a, b in ((main, pmain), (startup, pstartup)):
        assert json.dumps(port_ser.program_to_dict(b)) == \
            json.dumps(ref_ser.program_to_dict(a))
    exe, scope = ptpu.Executor(), ptpu.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    feeds = _feeds(STEPS)
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0]) for f in feeds]
    pexe = pc.Executor(device="cpu")
    pscope = port_io.scope_from_jax(init, device="cpu")
    got = [float(pexe.run(pmain, feed=f, fetch_list=[ploss],
                          scope=pscope)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for name in scope.var_names():
        w = np.asarray(scope.find_var(name))
        if name.startswith("@") or not np.issubdtype(w.dtype, np.floating):
            continue
        assert np.abs(pscope.find_var(name).numpy() - w).max() <= \
            2 * LR * STEPS, name


def _while_lstm(pkg, t=4, h=3, b=2):
    """The reference's While LSTM over a tensor array, with the gradient
    of its weight."""
    fw, L, _ = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[b, t, 4 * h], append_batch_size=False)
        w2 = main.global_block().create_parameter(
            name="w_shared", shape=[h, 4 * h], dtype="float32")
        xt = L.transpose(x, perm=[1, 0, 2])
        i = L.fill_constant([1], "int32", 0)
        n = L.fill_constant([1], "int32", t)
        hs = L.fill_constant_batch_size_like(x, shape=[-1, h],
                                             dtype="float32", value=0.0)
        cs = L.fill_constant_batch_size_like(x, shape=[-1, h],
                                             dtype="float32", value=0.0)
        seq = L.create_array(t, [b, h])
        cond_v = L.less_than(i, n)
        wl = L.While(cond_v, max_iters=t)
        with wl.block():
            x_t = L.reshape(L.gather(xt, i), [-1, 4 * h])
            gates = L.elementwise_add(x_t, L.mul(hs, w2))
            gc = L.slice(gates, [1], [0], [h])
            gi = L.slice(gates, [1], [h], [2 * h])
            gf = L.slice(gates, [1], [2 * h], [3 * h])
            go = L.slice(gates, [1], [3 * h], [4 * h])
            c_new = L.elementwise_add(
                L.elementwise_mul(L.sigmoid(gf), cs),
                L.elementwise_mul(L.sigmoid(gi), L.tanh(gc)))
            h_new = L.elementwise_mul(L.sigmoid(go), L.tanh(c_new))
            L.assign(h_new, hs)
            L.assign(c_new, cs)
            L.assign(L.array_write(h_new, i, seq), seq)
            i2 = L.increment(i, 1, in_place=False)
            L.assign(i2, i)
            L.assign(L.less_than(i2, n), cond_v)
        out = L.transpose(seq, perm=[1, 0, 2])
        loss = L.mean(out)
        if pkg == "ref":
            from paddle_tpu.core.backward import append_backward as ab
        else:
            ab = append_backward
        ab(loss, parameter_list=["w_shared"])
    return main, out


def test_while_lstm_over_a_tensor_array_matches_reference():
    rs = np.random.RandomState(3)
    xv = (rs.randn(2, 4, 12) * 0.4).astype(np.float32)
    wv = (rs.randn(3, 12) * 0.3).astype(np.float32)
    main, out = _while_lstm("ref")
    scope = ptpu.Scope()
    scope.set_var("w_shared", wv)
    want = ptpu.Executor().run(main, feed={"x": xv},
                               fetch_list=[out, "w_shared@GRAD"],
                               scope=scope)
    pmain, pout = _while_lstm("port")
    pscope = port_io.scope_from_jax({"w_shared": wv}, device="cpu")
    got = pc.Executor(device="cpu").run(pmain, feed={"x": xv},
                                        fetch_list=[pout, "w_shared@GRAD"],
                                        scope=pscope)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def _counting_loop(pkg, max_iters=None):
    fw, L, _ = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        n = L.data("n", shape=[1], dtype="int32", append_batch_size=False)
        x = L.data("x", shape=[4])
        i = L.fill_constant([1], "int32", 0)
        acc = L.fill_constant_batch_size_like(x, shape=[-1, 4],
                                              dtype="float32", value=0.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v, max_iters=max_iters)
        with w.block():
            L.assign(L.elementwise_add(L.scale(acc, 0.5), x), acc)
            L.assign(L.increment(i, 1, in_place=False), i)
            L.assign(L.less_than(i, n), cond_v)
    return main, [acc, i]


def _cond_program(pkg):
    fw, L, _ = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[4])
        flag = L.data("flag", shape=[], dtype="bool",
                      append_batch_size=False)
        w = main.global_block().create_parameter(
            name="cond_w", shape=[4, 2], dtype="float32")
        out = L.cond(flag, lambda: L.tanh(L.mul(x, w)),
                     lambda: L.scale(L.mul(x, w), 3.0))
        loss = L.mean(out)
        if pkg == "ref":
            from paddle_tpu.core.backward import append_backward as ab
        else:
            ab = append_backward
        ab(loss, parameter_list=["cond_w"])
    return main, [out, "cond_w@GRAD"]


def _run_both(build, feed, named=None, **kw):
    main, fetch = build("ref", **kw)
    scope = ptpu.Scope()
    for k, v in (named or {}).items():
        scope.set_var(k, v)
    want = ptpu.Executor().run(main, feed=feed, fetch_list=fetch,
                               scope=scope)
    pmain, pfetch = build("port", **kw)
    got = pc.Executor(device="cpu").run(
        pmain, feed=feed, fetch_list=pfetch,
        scope=port_io.scope_from_jax(named or {}, device="cpu"))
    return got, want


@pytest.mark.parametrize("trips", [0, 3, 7])
def test_unbounded_while_matches_reference(trips, monkeypatch):
    monkeypatch.setattr(cf, "HOST_READS", cf.HOST_READS.copy())
    before = cf.HOST_READS["while"]
    feed = {"n": np.array([trips], np.int32),
            "x": np.random.RandomState(trips).randn(2, 4)
            .astype(np.float32)}
    got, want = _run_both(_counting_loop, feed)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    # one read before each iteration and one that stops the loop
    assert cf.HOST_READS["while"] - before == trips + 1


@pytest.mark.parametrize("flag", [True, False])
def test_cond_and_its_gradient_match_reference(flag, monkeypatch):
    monkeypatch.setattr(cf, "HOST_READS", cf.HOST_READS.copy())
    rs = np.random.RandomState(4)
    feed = {"x": rs.randn(3, 4).astype(np.float32),
            "flag": np.array(flag)}
    named = {"cond_w": rs.randn(4, 2).astype(np.float32)}
    before = cf.HOST_READS["cond"]
    got, want = _run_both(_cond_program, feed, named)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    # one read a call (the reference's run reads nothing of the port's)
    assert cf.HOST_READS["cond"] - before == 1


def test_backward_through_an_unbounded_while_is_refused():
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = port_layers.data("x", shape=[4])
        h = port_layers.fc(x, 4)
        i = port_layers.fill_constant([1], "int32", 0)
        n = port_layers.fill_constant([1], "int32", 3)
        cond_v = port_layers.less_than(i, n)
        w = port_layers.While(cond_v)
        with w.block():
            port_layers.assign(port_layers.scale(h, 2.0), h)
            port_layers.assign(port_layers.increment(i, 1, in_place=False),
                               i)
            port_layers.assign(port_layers.less_than(i, n), cond_v)
        loss = port_layers.mean(h)
        with pytest.raises(ValueError, match="unbounded While"):
            append_backward(loss)


def _nested_unbounded_while(pkg, outer):
    """An unbounded While halving the hidden state twice, inside a
    StaticRNN's step or a bounded While's body; (main, startup, loss)."""
    fw, L, _ = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[T, D])

        def halve_twice(h):
            i = L.fill_constant([1], "int32", 0)
            n = L.fill_constant([1], "int32", 2)
            cond_v = L.less_than(i, n)
            w = L.While(cond_v)
            with w.block():
                L.assign(L.scale(h, 0.5), h)
                L.assign(L.increment(i, 1, in_place=False), i)
                L.assign(L.less_than(i, n), cond_v)

        if outer == "static_rnn":
            h0 = L.fill_constant_batch_size_like(x, shape=[-1, H],
                                                 dtype="float32", value=0.0)
            rnn = L.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(x)
                h_prev = rnn.memory(init=h0)
                h = L.fc([x_t, h_prev], H, act="tanh")
                halve_twice(h)
                rnn.update_memory(h_prev, h)
                rnn.step_output(h)
            out = rnn()
        else:
            xt = L.transpose(x, perm=[1, 0, 2])
            h = L.fc(L.reshape(L.gather(xt, L.fill_constant(
                [1], "int32", 0)), [-1, D]), H)
            j = L.fill_constant([1], "int32", 0)
            m = L.fill_constant([1], "int32", T)
            cond_v = L.less_than(j, m)
            w = L.While(cond_v, max_iters=T)
            with w.block():
                halve_twice(h)
                L.assign(L.increment(j, 1, in_place=False), j)
                L.assign(L.less_than(j, m), cond_v)
            out = h
        loss = L.mean(out)
    return main, startup, loss


@pytest.mark.parametrize("outer", ["static_rnn", "while"])
def test_backward_through_a_nested_unbounded_while_is_refused(outer):
    """The refusal looks into sub-blocks: the reference's vjp fails on a
    lax.while_loop nested in a scan or a bounded loop as well."""
    from paddle_tpu.core.backward import append_backward as ref_backward
    main, startup, loss = _nested_unbounded_while("ref", outer)
    with ptpu.program_guard(main, startup):
        ref_backward(loss)
    exe, scope = ptpu.Executor(), ptpu.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    pmain, pstartup, ploss = _nested_unbounded_while("port", outer)
    with pc.program_guard(pmain, pstartup), \
            pytest.raises(ValueError, match="unbounded While"):
        append_backward(ploss)


def test_check_nan_inf_sees_inside_the_static_rnn():
    """A NaN in one step's hidden state that the last output hides (a
    step past every row's length) is still reported, under the
    sub-block's name."""
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = port_layers.data("x", shape=[T, D])
        h0 = port_layers.fill_constant_batch_size_like(
            x, shape=[-1, D], dtype="float32", value=0.0)
        rnn = port_layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = port_layers.elementwise_mul(port_layers.sqrt(x_t), h_prev)
            rnn.update_memory(h_prev, port_layers.elementwise_add(h, x_t))
            rnn.step_output(h)
        first = port_layers.sequence_pool(rnn(), "first")
    xv = np.abs(np.random.RandomState(1).randn(B, T, D)).astype(np.float32)
    exe = pc.Executor(device="cpu")
    assert np.isfinite(exe.run(main, feed={"x": xv},
                               fetch_list=[first])[0]).all()
    xv[:, T - 1] = -1.0
    port_config.set_flags(check_nan_inf=True)
    try:
        with pytest.raises(FloatingPointError, match=r"sub1/op#"):
            exe.run(main, feed={"x": xv}, fetch_list=[first])
    finally:
        port_config.set_flags(check_nan_inf=False)


# -- the planner: captures and refusals ------------------------------------

def _run_thrice(main, feed, fetch, named=None):
    exe = pc.Executor(device="cpu")
    scope = port_io.scope_from_jax(named or {}, device="cpu")
    outs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(3)]
    return outs, exe


@pytest.mark.parametrize("build", ["while", "static_rnn"])
def test_bounded_loops_capture_and_replay_bitwise(build, monkeypatch):
    if build == "while":
        main, fetch = _counting_loop("port", max_iters=6)
        feed = {"n": np.array([4], np.int32),
                "x": np.random.RandomState(0).randn(2, 4)
                .astype(np.float32)}
        named = None
    else:
        pmain, pstartup, ploss = _static_rnn("port", train=False)
        scope = pc.Scope()
        pc.Executor(device="cpu").run(pstartup, scope=scope)
        named = {n: scope.find_var(n).numpy() for n in scope.var_names()
                 if not n.startswith("@")}
        main, fetch, feed = pmain, [ploss], _feeds(1)[0]
    eager, _ = _run_thrice(main, feed, fetch, named)
    with monkeypatch.context() as m:
        made = _emulate(m)
        outs, exe = _run_thrice(main, feed, fetch, named)
    stats = exe.capture_stats()
    assert stats["captures"] == len(made) == 1 and stats["replays"] == 2
    assert stats["refused"] == 0 and "refused_reasons" not in stats
    for run in outs:
        for g, w in zip(run, eager[0]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["while", "cond"])
def test_host_decided_control_flow_is_refused(kind, monkeypatch):
    if kind == "while":
        main, fetch = _counting_loop("port")
        feed = {"n": np.array([3], np.int32),
                "x": np.ones((2, 4), np.float32)}
        named = None
    else:
        main, fetch = _cond_program("port")
        main = _forward_only(main, fetch[0])
        fetch = fetch[:1]
        feed = {"x": np.ones((3, 4), np.float32), "flag": np.array(True)}
        named = {"cond_w": np.ones((4, 2), np.float32)}
    eager, _ = _run_thrice(main, feed, fetch, named)
    logged = []
    with monkeypatch.context() as m:
        made = _emulate(m)
        m.setattr(port_config, "get_flag", _flag_override(telemetry=True))
        from paddle_tpu_torch.core import executor as port_exe
        m.setattr(port_exe._log, "structured",
                  lambda event, **kw: logged.append((event, kw)))
        outs, exe = _run_thrice(main, feed, fetch, named)
        with pytest.raises(ValueError, match="cannot be exported"):
            exe.lower(main, feed=feed, fetch_list=fetch,
                      scope=port_io.scope_from_jax(named or {},
                                                   device="cpu"))
    stats = exe.capture_stats()
    assert made == [] and stats["captures"] == 0 and stats["refused"] == 1
    reason, = stats["refused_reasons"].values()
    assert ("unbounded while" if kind == "while" else "cond") in reason
    assert any(e == "aot_export_skipped" and kw["error"] == reason
               for e, kw in logged)
    for run in outs:
        for g, w in zip(run, eager[0]):
            np.testing.assert_array_equal(g, w)


def _flag_override(**over):
    real = port_config.get_flag

    def get_flag(name):
        return over[name] if name in over else real(name)
    return get_flag


def _forward_only(main, out):
    block = main.global_block()
    last = max(i for i, op in enumerate(block.ops)
               if out.name in op.output_names())
    del block.ops[last + 1:]
    main._version += 1
    return main


def test_static_rnn_under_amp_keeps_its_carry_float32():
    """Under the amp flag the step's fc computes in bfloat16 and its
    output is cast back to the memory's float32 at each step (the
    reference's ``_pin_carry_dtype``); the loss equals the reference's
    run under amp within 1e-2."""
    main, startup, loss = _static_rnn("ref", train=False)
    pmain, _, ploss = _static_rnn("port", train=False)
    scope = ptpu.Scope()
    ptpu.Executor().run(startup, scope=scope)
    named = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    feed = _feeds(1)[0]
    rnn = next(op for op in pmain.global_block().ops
               if op.type == "static_rnn")
    ptpu.config.set_flags(amp="bfloat16")
    port_config.set_flags(amp="bfloat16")
    try:
        want = ptpu.Executor().run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]
        pscope = port_io.scope_from_jax(named, device="cpu")
        exe = pc.Executor(device="cpu")
        got = exe.run(pmain, feed=feed, fetch_list=[ploss, rnn.outputs[
            "FinalStates"][0]], scope=pscope)
    finally:
        ptpu.config.set_flags(amp=None)
        port_config.set_flags(amp=None)
    assert got[1].dtype == np.float32
    np.testing.assert_allclose(got[0], want, rtol=1e-2)
