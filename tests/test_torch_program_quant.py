"""int8 compute through the port's executor (``core/executor.py`` reading
``program._quant_compute``; ``ops/quant_ops.maybe_quant_compute``,
``quant_conv2d``) and program arming (``serving/quant.py``
``arm_quant_compute(programs, scope)``), against the reference.

* Arming: on the LM's forward program, on a program with a
  ``transpose_Y`` matmul and on ResNet-8 for CIFAR, the port selects and
  tags the reference's names (``select_quant_vars``,
  ``select_compute_vars``, the tag's vars and key), its int8 weights and
  scales bitwise the reference's; a weight two programs read on
  different axes stays float32; arming again changes nothing.
* The int8 ``conv2d`` is bitwise the reference's compiled one over
  strides, paddings, dilations, groups and a filter whose integer sums
  pass 2**24 (where a float32 product would round). The compiled
  reference scales by ``amax * f32(1/127)`` (XLA folds the division);
  an eager call divides, and differs in the last bit.
* The armed LM forward, run by both executors from one scope: every
  armed ``mul`` of the program gives the reference's output bit for bit
  on the reference's input (B3's plain version on the CPU); the logits
  differ from the reference's only by the float32 rounding of the ops
  around the products (layer norms, gelu, attention: sums in other
  orders), held to PERF.md §2's int8 bound, 4 quantization steps of
  the head, and measured far below it. Bitwise end to end is not
  reachable: a layer norm's 1-ulp difference moves an activation
  row's amax, hence its scale.
* An armed reference scope crosses through ``io.scope_from_jax`` as it
  is and runs the port's armed program as the port's own arming does.
* The armed ResNet-8 forward: every armed ``conv2d`` and the ``mul``
  bitwise the reference's on the reference's inputs, the logits within
  1e-4 of their norm.
* ``paddle_quant_compute_ops_total`` counts each armed op once per
  program version, fetch list and tag ("dense" on the CPU), as the
  reference counts once per compile.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.layer_helper import LayerHelper as RefHelper
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu.ops import quant_ops as ref_qops
from paddle_tpu.serving import quant as ref_quant
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch.layer_helper import LayerHelper as PortHelper
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import quant_ops as port_qops
from paddle_tpu_torch.serving import quant as port_quant
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NET = dict(vocab_size=100, d_model=64, num_heads=2, d_ff=128, num_layers=2)
T, B = 16, 2
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
    return main, startup, logits.name


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
    return main, startup, logits.name


def _transposed(ref, shared_axis=False):
    """An fc (``mul``) and two matmuls against parameters, one with
    ``transpose_Y``; with ``shared_axis`` a second program reading the
    fc's weight through a ``transpose_Y`` matmul, so the two disagree on
    its axis."""
    fw, layers = _pkg(ref)
    helper_cls = RefHelper if ref else PortHelper
    with fw.unique_name.guard():
        main, startup = fw.Program(), fw.Program()
        other = fw.Program()
        startup.random_seed = 5
        with fw.program_guard(main, startup):
            x = layers.data("x", shape=[8])
            h = layers.fc(x, 6, param_attr="w_fc", bias_attr=False)
            helper = helper_cls("probe")
            wt = helper.create_parameter(None, shape=[5, 6], dtype="float32")
            wp = helper.create_parameter(None, shape=[6, 4], dtype="float32")
            a = layers.matmul(h, wt, transpose_y=True)
            b = layers.matmul(h, wp, alpha=0.5)
            out = layers.elementwise_add(layers.reduce_sum(a),
                                         layers.reduce_sum(b))
        if shared_axis:
            with fw.program_guard(other, fw.Program()):
                x2 = layers.data("x", shape=[6])
                w_fc = main.global_block().var("w_fc")
                other.global_block().create_parameter(
                    name="w_fc", shape=w_fc.shape, dtype="float32")
                layers.matmul(x2, other.global_block().var("w_fc"),
                              transpose_y=True)
    return (main, startup, out.name) if not shared_axis else \
        (main, startup, other)


BUILDERS = {"lm": _lm, "resnet": _resnet, "transposed": _transposed}


def _ref_scope(startup):
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    return scope


def _named(scope):
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()}


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_arm_selects_the_reference_names(kind):
    (rmain, rstart, _), (pmain, _, _) = BUILDERS[kind](True), \
        BUILDERS[kind](False)
    assert port_quant.select_quant_vars(pmain) == \
        ref_quant.select_quant_vars(rmain)
    assert port_quant.select_compute_vars(pmain) == \
        ref_quant.select_compute_vars(rmain)
    rscope = _ref_scope(rstart)
    pscope = port_io.scope_from_jax(_named(rscope), device="cpu")
    want = ref_quant.arm_quant_compute([rmain], rscope)
    got = port_quant.arm_quant_compute([pmain], pscope)
    assert got == want and want
    assert pmain._quant_compute == rmain._quant_compute
    for name in want:
        for n in (name, port_qops.scale_var_name(name)):
            np.testing.assert_array_equal(
                pscope.find_var(n).numpy(), np.asarray(rscope.find_var(n)),
                err_msg=n)
        assert pscope.find_var(name).dtype == torch.int8
    # arming again: the same names, tag and tensors
    before = {n: pscope.find_var(n) for n in pscope.var_names()}
    assert port_quant.arm_quant_compute([pmain, None], pscope) == want
    assert all(pscope.find_var(n) is t for n, t in before.items())
    assert pmain._quant_compute == rmain._quant_compute


def test_transpose_y_and_an_axis_conflict_stay_float32():
    rmain, rstart, rother = _transposed(True, shared_axis=True)
    pmain, _, pother = _transposed(False, shared_axis=True)
    alone = port_quant.select_compute_vars(pmain)
    assert "w_fc" in alone and len(alone) == 2      # w_fc and the plain one
    rscope = _ref_scope(rstart)
    pscope = port_io.scope_from_jax(_named(rscope), device="cpu")
    want = ref_quant.arm_quant_compute([rmain, rother], rscope)
    got = port_quant.arm_quant_compute([pmain, pother], pscope)
    assert got == want and "w_fc" not in got and len(got) == 1
    assert pscope.find_var("w_fc").dtype == torch.float32
    assert not hasattr(pother, "_quant_compute") and \
        not hasattr(rother, "_quant_compute")


CONV_CASES = [
    # (n, c, h, w, o, k, stride, pad, dilation, groups, large sums)
    (2, 8, 9, 9, 6, 3, 1, 1, 1, 1, False),
    (3, 8, 10, 10, 4, 3, 2, 1, 1, 2, False),
    (2, 6, 11, 11, 6, 3, 1, 2, 2, 3, False),
    (2, 16, 7, 7, 8, 1, 1, 0, 1, 1, False),
    (1, 4, 5, 5, 4, 5, 2, 2, 1, 4, False),
    (2, 512, 6, 6, 4, 3, 1, 1, 1, 1, True),
]


def _conv_case(case, seed=0):
    n, c, h, w, o, k, stride, pad, dil, groups, large = case
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((n, c, h, w)) * 3).astype(np.float32)
    if large:
        # every activation near its sample's amax, 4.432113, one of the
        # float32 values whose amax / 127 and amax * f32(1/127) differ
        wq = np.full((o, c // groups, k, k), 127, np.int8)
        amax = np.float32(4.432113)
        x = (rs.uniform(0.5, 0.99, x.shape) * amax).astype(np.float32)
        x[:, 0, 1, 1] = amax
        x[:, :, 0, 0] = 0.0          # a zero column among the rest
    else:
        wq = rs.randint(-127, 128, (o, c // groups, k, k)).astype(np.int8)
    ws = (rs.rand(o) * 0.01 + 1e-3).astype(np.float32)
    op = types.SimpleNamespace(attrs=dict(
        strides=[stride] * 2, paddings=[pad] * 2, dilations=[dil] * 2,
        groups=groups))
    return x, wq, ws, op


def _ref_conv(op, x, wq, ws, jit=True):
    f = lambda *a: ref_qops._quant_conv2d(op, *a)["Output"]  # noqa: E731
    f = jax.jit(f) if jit else f
    return np.asarray(f(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))


def _port_conv(op, x, wq, ws):
    return port_qops.quant_conv2d(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws),
        op.attrs["strides"], op.attrs["paddings"], op.attrs["dilations"],
        op.attrs["groups"]).numpy()


@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv2d_bitwise(case):
    x, wq, ws, op = _conv_case(case)
    np.testing.assert_array_equal(_port_conv(op, x, wq, ws),
                                  _ref_conv(op, x, wq, ws))
    if case[-1]:
        # the integer sums of a window pass 2**24, where float32 rounds
        scale = np.abs(x).max(axis=(1, 2, 3), keepdims=True) \
            * np.float32(port_qops.INV_127)
        xq = np.clip(np.rint(x / scale), -127, 127)
        assert xq[:, :, :3, :3].sum(axis=(1, 2, 3)).max() * 127 > 2 ** 24


def test_int8_conv2d_scale_is_the_compiled_references():
    """The reference's source divides ``amax / 127.0``; compiled, XLA
    multiplies by f32(1/127), and its executor runs compiled programs.
    The port multiplies: bitwise the compiled reference, and on this
    input not the eager one."""
    x, wq, ws, op = _conv_case(CONV_CASES[-1])
    got = _port_conv(op, x, wq, ws)
    np.testing.assert_array_equal(got, _ref_conv(op, x, wq, ws))
    amax = np.float32(4.432113)
    assert np.float32(amax / np.float32(127)) != amax * np.float32(
        port_qops.INV_127)
    assert not np.array_equal(got, _ref_conv(op, x, wq, ws, jit=False))


def _armed_inputs(main):
    """[(op, input slot, output slot)] of a program's armed ops."""
    tag = main._quant_compute["vars"]
    slots = {"mul": ("X", "Out"), "matmul": ("X", "Out"),
             "conv2d": ("Input", "Output")}
    weight = {"mul": "Y", "matmul": "Y", "conv2d": "Filter"}
    return [(op,) + slots[op.type] for op in main.global_block().ops
            if op.type in slots and op.inputs[weight[op.type]][0] in tag]


def _armed_runs(kind, feed):
    """Both executors on one armed scope: (reference fetches by name,
    port fetches by name, port scope, port program, armed names)."""
    (rmain, rstart, out), (pmain, _, _) = BUILDERS[kind](True), \
        BUILDERS[kind](False)
    rscope = _ref_scope(rstart)
    pscope = port_io.scope_from_jax(_named(rscope), device="cpu")
    armed = ref_quant.arm_quant_compute([rmain], rscope)
    assert port_quant.arm_quant_compute([pmain], pscope) == armed
    ops = _armed_inputs(pmain)
    names = [out] + [n for op, i, o in ops
                     for n in (op.inputs[i][0], op.outputs[o][0])]
    with ptpu.scope_guard(rscope):
        ref = ptpu.Executor().run(rmain, feed=feed, fetch_list=names)
    port = pc.Executor(device="cpu").run(pmain, feed=feed,
                                         fetch_list=names, scope=pscope)
    return (dict(zip(names, map(np.asarray, ref))), dict(zip(names, port)),
            pscope, pmain, ops, out)


def _each_armed_op_bitwise(ref, pscope, ops):
    """Each armed op through the executor's hook on the reference's
    input: the reference's output bit for bit."""
    env = {n: pscope.find_var(n) for n in pscope.var_names()}
    trace = types.SimpleNamespace(quant=None, quant_seen=set())
    for op, i, o in ops:
        trace.quant = {"vars": {op.inputs[k][0]: 0 for k in ("Y", "Filter")
                                if k in op.inputs}}
        wslot = "Filter" if op.type == "conv2d" else "Y"
        values = {i: [torch.tensor(ref[op.inputs[i][0]])],
                  wslot: [env[op.inputs[wslot][0]]]}
        got = port_qops.maybe_quant_compute(op, values, env, trace)
        np.testing.assert_array_equal(got[o].numpy(), ref[op.outputs[o][0]],
                                      err_msg=op.outputs[o][0])


def test_armed_lm_forward():
    ids = np.random.RandomState(0).randint(2, NET["vocab_size"], (B, T))
    ref, port, pscope, pmain, ops, logits = _armed_runs(
        "lm", {"toks": ids, "lbls": ids})
    assert len(ops) == 6 * NET["num_layers"] + 1
    _each_armed_op_bitwise(ref, pscope, ops)
    # the head's quantization step: a layer-norm output has |z| <=
    # sqrt(d - 1) * max|scale| + max|shift|
    d = NET["d_model"]
    ln = "layer_norm_%d" % (2 * NET["num_layers"])
    amax = (d - 1) ** 0.5 * float(pscope.find_var(ln + ".w_0").abs().max()) \
        + float(pscope.find_var(ln + ".w_1").abs().max())
    step = amax * float(pscope.find_var("lm_head.w@quant.scale").max())
    diff = np.abs(port[logits] - ref[logits]).max()
    assert diff <= LM_INT8_STEPS * step
    assert diff <= 1e-5 * np.abs(ref[logits]).max()


def test_an_armed_reference_scope_runs_in_the_port():
    """``io.scope_from_jax`` carries an armed reference scope (int8
    weights and their ``@quant.scale`` sidecars) as it is; arming the
    port's program on it tags without quantizing again, and the run
    equals the port's own arming of the float32 scope bit for bit."""
    (rmain, rstart, _), (pmain, _, logits) = _lm(True), _lm(False)
    rscope = _ref_scope(rstart)
    f32 = _named(rscope)
    armed = ref_quant.arm_quant_compute([rmain], rscope)
    carried = port_io.scope_from_jax(_named(rscope), device="cpu")
    for name in armed:
        assert carried.find_var(name).dtype == torch.int8
    before = {n: carried.find_var(n) for n in carried.var_names()}
    assert port_quant.arm_quant_compute([pmain], carried) == armed
    assert all(carried.find_var(n) is t for n, t in before.items())
    own = port_io.scope_from_jax(f32, device="cpu")
    assert port_quant.arm_quant_compute([pmain], own) == armed
    ids = np.random.RandomState(2).randint(2, NET["vocab_size"], (B, T))
    exe = pc.Executor(device="cpu")
    runs = [exe.run(pmain, feed={"toks": ids, "lbls": ids},
                    fetch_list=[logits], scope=sc)[0] for sc in (carried, own)]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_armed_resnet_forward():
    rs = np.random.RandomState(6)
    feed = {"img": rs.standard_normal((4, 3, 16, 16)).astype(np.float32),
            "label": rs.randint(0, 10, (4, 1)).astype(np.int64)}
    ref, port, pscope, pmain, ops, logits = _armed_runs("resnet", feed)
    assert sorted({op.type for op, _, _ in ops}) == ["conv2d", "mul"]
    _each_armed_op_bitwise(ref, pscope, ops)
    diff = np.linalg.norm(port[logits] - ref[logits])
    assert diff <= 1e-4 * np.linalg.norm(ref[logits])


def _count(op, path):
    return sum(s["value"] for s in metrics.REGISTRY.dump().get(
        "paddle_quant_compute_ops_total", {}).get("samples", ())
        if s["labels"] == {"op": op, "path": path})


def test_quant_counter_counts_once_per_program_version():
    main, startup, logits = _lm(False)
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    ids = np.random.RandomState(1).randint(2, NET["vocab_size"], (B, T))
    feed = {"toks": ids, "lbls": ids}
    plain = exe.run(main, feed=feed, fetch_list=[logits], scope=scope)[0]
    before = _count("mul", "dense")
    armed = port_quant.arm_quant_compute([main], scope)
    out = [exe.run(main, feed=feed, fetch_list=[logits], scope=scope)[0]
           for _ in range(2)]
    n = len(armed)
    assert _count("mul", "dense") == before + n
    np.testing.assert_array_equal(out[0], out[1])
    assert not np.array_equal(out[0], plain)
    assert np.abs(out[0] - plain).max() <= 0.05 * np.abs(plain).max()
    exe.run(main, feed=feed, fetch_list=[logits, "toks"], scope=scope)
    assert _count("mul", "dense") == before + 2 * n
    # the tag is read at each run: without it, the float32 route (which
    # an int8 weight cannot take) is not silently chosen
    del main._quant_compute
    with pytest.raises(RuntimeError):
        exe.run(main, feed=feed, fetch_list=[logits], scope=scope)
