"""The port's fused convolution + BN statistics (``paddle_tpu_torch/ops/
conv_bn.py``) and the other new ops of the ResNet path (``nn_ops``
``pool2d`` and ``batch_norm``, ``loss_ops``, ``metric_ops``,
``optimizer_ops``) against the reference's ops on the same numpy inputs.

The reference's ``conv_bn_stats`` takes its Pallas kernel (``_pallas_1x1``,
interpret mode on the CPU) for a 1x1 stride-1 f32 geometry and
``_reference`` otherwise; the port's wrapper on CPU tensors computes the
plain version (``F.conv2d`` plus the sums). Registered reference ops are
called with an ``ExecContext`` over numpy inputs, and their gradients
come from ``jax.vjp`` with cotangents on every differentiated output.

Tolerances (float32 throughout; the two sides sum in other orders):
y, normalized outputs and gradients to ``rtol = 1e-5`` plus an ``atol``
of 1e-5 of the tensor's largest magnitude; a channel sum to 1e-5 of the
sum of the magnitudes it adds (sums of signed terms cancel, so a
relative check of the sum alone would be ill-posed); running statistics
likewise, the variance ``E[y^2] - E[y]^2`` to 1e-5 of ``E[y^2]`` (the
formula both sides use cancels in float32). Exact where both sides do
the same operations in the same order (accuracy, the update ops). The
bf16 probe T1 is held to one bf16 rounding step of its output."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.registry import ExecContext
from paddle_tpu.ops import loss_ops as ref_loss
from paddle_tpu.ops import math_ops as ref_math
from paddle_tpu.ops import metric_ops as ref_metric
from paddle_tpu.ops import nn_ops as ref_nn
from paddle_tpu.ops import optimizer_ops as ref_opt
from paddle_tpu.ops import pallas_conv_bn as ref_cb
from paddle_tpu_torch.ops import conv_bn as port_cb
from paddle_tpu_torch.ops import loss_ops as port_loss
from paddle_tpu_torch.ops import metric_ops as port_metric
from paddle_tpu_torch.ops import nn_ops as port_nn
from paddle_tpu_torch.ops import optimizer_ops as port_opt
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _close(got, want, rtol=RTOL, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _ref_op(fn, attrs, **inputs):
    """Call a registered reference op on jnp inputs."""
    op = types.SimpleNamespace(attrs=attrs, outputs={})
    return fn(ExecContext(op, {k: [v] for k, v in inputs.items()}))


def _t(a):
    return torch.from_numpy(np.array(a))


# (N, C, H, W, O, k, stride, pad, groups): fusable 1x1 geometries (ragged
# rows and channels, and one with more rows than a Pallas block) and the
# ResNet's other geometries (7x7/2 stem, 3x3, 1x1/2 shortcut), one grouped
GEOMS = {
    "1x1-ragged": (3, 37, 5, 7, 19, 1, 1, 0, 1),
    "1x1-tiled": (2, 64, 16, 16, 32, 1, 1, 0, 1),
    "1x1-stride2": (2, 16, 8, 8, 24, 1, 2, 0, 1),
    "3x3": (2, 8, 9, 9, 12, 3, 1, 1, 1),
    "7x7-stride2": (2, 3, 16, 16, 8, 7, 2, 3, 1),
    "3x3-grouped": (2, 8, 6, 6, 8, 3, 1, 1, 2),
}


def _conv_inputs(geom, seed):
    n, c, h, w, o, k, _s, _p, g = geom
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, c, h, w)).astype(np.float32)
    wt = (rs.standard_normal((o, c // g, k, k)) /
          np.sqrt(c // g * k * k)).astype(np.float32)
    return x, wt


def _ref_stats(geom, x, w):
    _n, _c, _h, _w, _o, _k, s, p, g = geom
    return ref_cb.conv_bn_stats((s, s), (p, p), (1, 1), g, jnp.asarray(x),
                                jnp.asarray(w))


def _check_sums(got, want, y):
    """A channel sum against the reference's, to RTOL of the sum of the
    magnitudes it adds."""
    mags = np.abs(np.asarray(y, np.float64)).sum(axis=(0, 2, 3))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= RTOL * mags + 1e-30).all(), (err.max(), mags.min())


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_conv_bn_stats_forward(name):
    geom = GEOMS[name]
    x, w = _conv_inputs(geom, 0)
    want = [np.asarray(a) for a in _ref_stats(geom, x, w)]
    _n, _c, _h, _w, _o, _k, s, p, g = geom
    tx, tw = _t(x), _t(w)
    assert port_cb.fusable(tx, tw, s, p, 1, g) == (name.startswith("1x1")
                                                   and s == 1)
    y, cs, css = port_cb.conv_bn_stats(tx, tw, s, p, 1, g)
    _close(y.numpy(), want[0])
    _check_sums(cs.numpy(), want[1], want[0])
    _check_sums(css.numpy(), want[2], want[0] ** 2)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_conv_bn_stats_vjp(name):
    """Gradients with cotangents on y, sum_c and sumsq_c against the
    reference's custom_vjp (``_bwd``: jax.vjp of ``_reference``)."""
    geom = GEOMS[name]
    x, w = _conv_inputs(geom, 1)
    _n, _c, _h, _w, _o, _k, s, p, g = geom
    y_ref, _, _ = _ref_stats(geom, x, w)
    rs = np.random.RandomState(2)
    gy = rs.standard_normal(np.shape(y_ref)).astype(np.float32)
    gs = rs.standard_normal(geom[4]).astype(np.float32)
    gss = (rs.standard_normal(geom[4]) * 0.1).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: ref_cb.conv_bn_stats(
        (s, s), (p, p), (1, 1), g, a, b), jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = vjp((jnp.asarray(gy), jnp.asarray(gs), jnp.asarray(gss)))
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    y, cs, css = port_cb.conv_bn_stats(tx, tw, s, p, 1, g)
    torch.autograd.backward([y, cs, css], [_t(gy), _t(gs), _t(gss)])
    _close(tx.grad.numpy(), want_x)
    _close(tw.grad.numpy(), want_w)


def test_conv_bn_stats_1x1_wrapper_on_cpu_is_plain():
    """The B1 wrapper on CPU tensors returns the plain version and
    launches nothing; it refuses what the kernel does not take."""
    x, w = _conv_inputs(GEOMS["1x1-ragged"], 3)
    before = port_cb.conv_bn_stats_1x1.launches
    got = port_cb.conv_bn_stats_1x1(_t(x), _t(w))
    want = port_cb.conv_bn_stats_plain(_t(x), _t(w))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert port_cb.conv_bn_stats_1x1.launches == before
    with pytest.raises(ValueError, match="float32"):
        port_cb.conv_bn_stats_1x1(_t(x).double(), _t(w).double())
    with pytest.raises(ValueError, match="do not chain"):
        port_cb.conv_bn_stats_1x1(_t(x), _t(w)[:, :5])


def _bn_inputs(o, seed):
    rs = np.random.RandomState(seed)
    return [(rs.rand(o) + 0.5).astype(np.float32),
            (rs.standard_normal(o) * 0.1).astype(np.float32),
            (rs.standard_normal(o) * 0.1).astype(np.float32),
            (rs.rand(o) + 0.5).astype(np.float32)]


def _ref_conv2d_bn(geom, x, w, scale, bias, mean, var, is_test):
    _n, _c, _h, _w, _o, _k, s, p, g = geom
    attrs = {"strides": [s, s], "paddings": [p, p], "dilations": [1, 1],
             "groups": g, "momentum": 0.9, "epsilon": 1e-5,
             "is_test": is_test}
    return _ref_op(ref_cb._conv2d_bn, attrs, Input=x, Filter=w, Scale=scale,
                   Bias=bias, Mean=mean, Variance=var)


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("name", ["1x1-ragged", "1x1-tiled", "3x3",
                                  "1x1-stride2"])
def test_conv2d_bn_forward_and_running_stats(name, is_test):
    geom = GEOMS[name]
    x, w = _conv_inputs(geom, 4)
    scale, bias, mean, var = _bn_inputs(geom[4], 5)
    want = _ref_conv2d_bn(geom, *map(jnp.asarray, (x, w, scale, bias, mean,
                                                   var)), is_test)
    _n, _c, _h, _w, _o, _k, s, p, g = geom
    tmean, tvar = _t(mean), _t(var)
    y = port_cb.conv2d_bn(_t(x), _t(w), _t(scale), _t(bias), tmean, tvar,
                          s, p, 1, g, 0.9, 1e-5, is_test)
    _close(y.numpy(), want["Y"])
    _close(tmean.numpy(), want["MeanOut"], scale=np.abs(want["Y"]).max())
    # E[y^2] bounds the variance's cancellation error
    _close(tvar.numpy(), want["VarianceOut"],
           scale=float(np.mean(np.square(x))) + np.abs(var).max())
    if is_test:
        assert np.array_equal(tmean.numpy(), mean)
        assert np.array_equal(tvar.numpy(), var)


@pytest.mark.parametrize("name", ["1x1-ragged", "1x1-tiled", "3x3"])
def test_conv2d_bn_gradients(name):
    """d(sum(Y * ct)) / d(x, w, scale, bias) against jax.vjp of the
    reference op: the BN finish differentiates through the fused sums."""
    geom = GEOMS[name]
    x, w = _conv_inputs(geom, 6)
    scale, bias, mean, var = _bn_inputs(geom[4], 7)
    y0 = _ref_conv2d_bn(geom, *map(jnp.asarray, (x, w, scale, bias, mean,
                                                 var)), False)["Y"]
    ct = np.random.RandomState(8).standard_normal(
        np.shape(y0)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, d: _ref_conv2d_bn(
        geom, a, b, c, d, jnp.asarray(mean), jnp.asarray(var), False)["Y"],
        *map(jnp.asarray, (x, w, scale, bias)))
    want = vjp(jnp.asarray(ct))
    _n, _c, _h, _w, _o, _k, s, p, g = geom
    leaves = [_t(a).requires_grad_() for a in (x, w, scale, bias)]
    y = port_cb.conv2d_bn(*leaves, _t(mean), _t(var), s, p, 1, g)
    y.backward(_t(ct))
    for leaf, ref in zip(leaves, want):
        _close(leaf.grad.numpy(), ref, rtol=1e-4)


def _probe_module():
    path = os.path.join(ROOT, "tools", "fused_conv_bn_probe.py")
    spec = importlib.util.spec_from_file_location("_t1_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("r,c,o", [(256, 32, 48), (200, 24, 40)])
def test_conv1x1_bn_relu_plain_matches_probe(r, c, o):
    """T1's plain version against the probe's ``xla_path`` and its
    Pallas kernel (interpret mode), in bf16: y within one bf16 step of
    its magnitude (2^-7 relative; both accumulate in f32 and round once,
    but the reference's prologue rounds in other places), the f32 sums
    to 1e-2 of the sum of magnitudes (they are sums of the f32 product
    on the kernel's side, of the bf16-rounded y on xla_path's)."""
    probe = _probe_module()
    rs = np.random.RandomState(9)
    x = rs.standard_normal((r, c)).astype(np.float32)
    a = (rs.rand(c) + 0.5).astype(np.float32)
    b = (rs.standard_normal(c) * 0.1).astype(np.float32)
    w = (rs.standard_normal((c, o)) * 0.05).astype(np.float32)
    jx = [jnp.asarray(v, jnp.bfloat16) for v in (x, a, b, w)]
    refs = [probe.xla_path(*jx)]
    if r % 64 == 0:
        refs.append(probe.fused_conv1x1_bn(*jx, block_n=64))
    tx = [_t(v.astype(jnp.float32)).to(torch.bfloat16) for v in jx]
    y, s, ss = port_cb.conv1x1_bn_relu(*tx)
    assert y.dtype == torch.bfloat16 and y.shape == (r, o)
    yf = y.float().numpy()
    for ry, rsum, rss in refs:
        ryf = np.asarray(ry.astype(jnp.float32))
        np.testing.assert_allclose(yf, ryf, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(ryf).max())
        mags = np.abs(ryf).sum(axis=0)
        assert (np.abs(s.numpy() - np.asarray(rsum)) <= 1e-2 * mags).all()
        assert (np.abs(ss.numpy() - np.asarray(rss)) <=
                1e-2 * (ryf ** 2).sum(axis=0)).all()


# -- the other new ops ------------------------------------------------------

POOLS = {
    "max-3x3-s2-p1": dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                          pooling_type="max"),
    "avg-3x3-s2-p1-exclusive": dict(ksize=[3, 3], strides=[2, 2],
                                    paddings=[1, 1], pooling_type="avg"),
    "avg-3x3-s1-p1-inclusive": dict(ksize=[3, 3], strides=[1, 1],
                                    paddings=[1, 1], pooling_type="avg",
                                    exclusive=False),
    "avg-global": dict(ksize=[7, 7], pooling_type="avg",
                       global_pooling=True),
    "max-2x2-s2-ceil": dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0],
                            pooling_type="max", ceil_mode=True),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool2d(name):
    attrs = POOLS[name]
    x = np.random.RandomState(10).standard_normal(
        (2, 3, 7, 9)).astype(np.float32)
    want = _ref_op(ref_nn._pool2d, attrs, X=jnp.asarray(x))["Out"]
    ct = np.random.RandomState(11).standard_normal(
        np.shape(want)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: _ref_op(ref_nn._pool2d, attrs, X=v)["Out"],
                     jnp.asarray(x))
    want_g, = vjp(jnp.asarray(ct))
    tx = _t(x).requires_grad_()
    got = port_nn.pool2d(tx, attrs["ksize"], attrs["pooling_type"],
                         attrs.get("strides", 1), attrs.get("paddings", 0),
                         attrs.get("global_pooling", False),
                         attrs.get("ceil_mode", False),
                         attrs.get("exclusive", True))
    _close(got.detach().numpy(), want)
    got.backward(_t(ct))
    _close(tx.grad.numpy(), want_g)


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm(is_test):
    """Forward, running statistics (the reference's momentum direction
    and biased variance, not torch's) and input/scale/bias gradients."""
    rs = np.random.RandomState(12)
    x = (rs.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    scale, bias, mean, var = _bn_inputs(5, 13)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test}

    def ref(a, c, d):
        return _ref_op(ref_nn._batch_norm, attrs, X=a, Scale=c, Bias=d,
                       Mean=jnp.asarray(mean), Variance=jnp.asarray(var))

    want = ref(*map(jnp.asarray, (x, scale, bias)))
    ct = rs.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, d: ref(a, c, d)["Y"],
                     *map(jnp.asarray, (x, scale, bias)))
    want_g = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in (x, scale, bias)]
    tmean, tvar = _t(mean), _t(var)
    y = port_nn.batch_norm(leaves[0], leaves[1], leaves[2], tmean, tvar,
                           0.9, 1e-5, is_test)
    _close(y.detach().numpy(), want["Y"])
    _close(tmean.numpy(), want["MeanOut"])
    _close(tvar.numpy(), want["VarianceOut"],
           scale=float(np.mean(np.square(x))))
    y.backward(_t(ct))
    for leaf, g in zip(leaves, want_g):
        _close(leaf.grad.numpy(), g, rtol=1e-4)


@pytest.mark.parametrize("label_dtype", [np.int64, np.int32])
def test_softmax_with_cross_entropy_and_mean(label_dtype):
    """Loss, softmax and the gradient of the mean loss; int64 and int32
    labels give the same result (the cast is inside the op)."""
    rs = np.random.RandomState(14)
    logits = (rs.standard_normal((6, 11)) * 3).astype(np.float32)
    label = rs.randint(0, 11, (6, 1)).astype(label_dtype)

    def ref(z):
        out = _ref_op(ref_loss._softmax_with_cross_entropy, {},
                      Logits=z, Label=jnp.asarray(label))
        return out, _ref_op(ref_math._mean, {}, X=out["Loss"])["Out"]

    want, want_mean = ref(jnp.asarray(logits))
    want_g = jax.grad(lambda z: ref(z)[1])(jnp.asarray(logits))
    tz = _t(logits).requires_grad_()
    loss, softmax = port_loss.softmax_with_cross_entropy(tz, _t(label))
    m = port_loss.mean(loss)
    _close(loss.detach().numpy(), want["Loss"])
    _close(softmax.detach().numpy(), want["Softmax"])
    _close(m.item(), want_mean)
    m.backward()
    _close(tz.grad.numpy(), want_g)


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy(k):
    rs = np.random.RandomState(15)
    pred = rs.standard_normal((16, 7)).astype(np.float32)
    label = rs.randint(0, 7, (16, 1)).astype(np.int64)
    idx = jax.lax.top_k(jnp.asarray(pred), k)[1]
    want = _ref_op(ref_metric._accuracy, {}, Indices=idx,
                   Label=jnp.asarray(label))
    acc, correct, total = port_metric.accuracy(_t(pred), _t(label), k)
    assert int(correct) == int(want["Correct"])
    assert int(total) == int(want["Total"]) == 16
    assert float(acc) == float(want["Accuracy"])
    assert 0 < int(correct) < 16


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum(nesterov):
    rs = np.random.RandomState(16)
    p, g, v = (rs.standard_normal((4, 6)).astype(np.float32)
               for _ in range(3))
    lr = np.float32([0.1])
    want = _ref_op(ref_opt._momentum, {"mu": 0.9, "use_nesterov": nesterov},
                   Param=jnp.asarray(p), Grad=jnp.asarray(g),
                   Velocity=jnp.asarray(v), LearningRate=jnp.asarray(lr))
    tp, tv = _t(p), _t(v)
    port_opt.momentum(tp, _t(g), tv, 0.1, 0.9, nesterov)
    _close(tv.numpy(), want["VelocityOut"], rtol=1e-6)
    _close(tp.numpy(), want["ParamOut"], rtol=1e-6)


def test_sgd():
    rs = np.random.RandomState(17)
    p, g = (rs.standard_normal((5, 3)).astype(np.float32) for _ in range(2))
    want = _ref_op(ref_opt._sgd, {}, Param=jnp.asarray(p),
                   Grad=jnp.asarray(g),
                   LearningRate=jnp.asarray(np.float32([0.1])))
    tp = _t(p)
    port_opt.sgd(tp, _t(g), 0.1)
    _close(tp.numpy(), want["ParamOut"], rtol=1e-6)
