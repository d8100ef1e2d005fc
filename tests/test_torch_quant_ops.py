"""Kernel B3's plain version (``int8_matmul_plain``, and the wrapper
``quant_matmul_2d`` on CPU tensors) against the reference's dense int8
path ``_dense_int8_matmul`` compiled with ``jax.jit`` (as the
reference's executor runs it) and its Pallas kernel
``_pallas_int8_matmul`` in interpret mode; ``quantize_rows`` and the
weight quantizer ``quantize_array`` against the reference's.

Every comparison is bitwise (``np.array_equal``): the int8 product is
exact and every other step is one correctly rounded f32 operation in
the same order on both sides. XLA compiles the reference's
``amax / 127.0`` into ``amax * f32(1 / 127)``, which the port
reproduces; an eager call of the reference divides instead, and
:func:`test_eager_reference_divides` records where that differs. The
cases cover m 1, 3 and 8, ragged k and n, an all-zero row (scale 1.0)
and rows whose x / scale lands exactly on a half (rounded to even)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import quant_ops as ref_q
from paddle_tpu.serving import quant as ref_sq
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops import quant_ops as port_q
from paddle_tpu_torch.serving import quant as port_sq

SHAPES = [(37, 19), (64, 96), (200, 72)]   # (k, n), ragged and tiled


def _x(m, k, seed, zero_row=False, halves=False):
    x = np.random.RandomState(seed).standard_normal((m, k)).astype(np.float32)
    if zero_row:
        x[m // 2] = 0.0
    if halves:
        # amax 127 -> scale exactly 1, amax 254 -> scale exactly 2: the
        # other entries land on x / scale = j + 0.5
        x[0, :] = np.resize(np.float32([0.5, 1.5, 2.5, -3.5, -0.5]), k)
        x[0, 0] = 127.0
        if m > 1:
            x[1, :] = np.resize(np.float32([5.0, 7.0, -1.0, -3.0]), k)
            x[1, 1 % k] = -254.0
    return x


def _w(k, n, seed):
    w = np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32)
    return ref_sq.quantize_array(w, 1)


CASES = [(m, k, n, zero, halves) for m in (1, 3, 8) for k, n in SHAPES
         for zero, halves in ((False, False), (True, False), (False, True))
         if not (zero and m == 1)]


def _ids(c):
    m, k, n, zero, halves = c
    return "m%d-k%d-n%d%s%s" % (m, k, n, "-zero" if zero else "",
                                "-halves" if halves else "")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_quantize_rows_bitwise(case):
    m, k, _, zero, halves = case
    x = _x(m, k, 0, zero, halves)
    want_q, want_s = jax.jit(ref_q.quantize_rows)(jnp.asarray(x))
    got_q, got_s = port_q.quantize_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    if halves:
        assert got_q[0, 1].item() == 2 and got_q[0, 2 % k].item() in (2, 127)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_int8_matmul_bitwise_with_dense_and_pallas(case):
    m, k, n, zero, halves = case
    x = _x(m, k, 1, zero, halves)
    wq, ws = _w(k, n, 2)
    dense = np.asarray(jax.jit(ref_q._dense_int8_matmul)(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))
    pallas = np.asarray(ref_q._pallas_int8_matmul(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), interpret=True))
    t = torch.from_numpy
    plain = port_q.int8_matmul_plain(t(x), t(wq), t(ws)).numpy()
    launches = port_q.quant_matmul_2d.launches
    wrapped = port_q.quant_matmul_2d(t(x), t(wq), t(ws)).numpy()
    assert port_q.quant_matmul_2d.launches == launches   # CPU: plain
    assert plain.dtype == np.float32 and plain.shape == (m, n)
    assert np.array_equal(plain, dense)
    assert np.array_equal(plain, pallas)
    assert np.array_equal(wrapped, dense)
    if zero:
        assert not plain[m // 2].any()


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_array_bitwise_with_zero_channel(axis):
    w = np.random.RandomState(3).standard_normal((6, 5)).astype(np.float32)
    if axis == 1:
        w[:, 2] = 0.0
    else:
        w[4, :] = 0.0
    want_q, want_s = ref_sq.quantize_array(w, axis)
    got_q, got_s = port_sq.quantize_array(w, axis)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    assert np.array_equal(got_q, want_q) and np.array_equal(got_s, want_s)
    assert 1.0 in got_s.tolist()                 # the all-zero channel
    assert np.array_equal(port_sq.dequantize_array(got_q, got_s, axis),
                          ref_sq.dequantize_array(want_q, want_s, axis))


def test_mul_flattens_like_the_reference_quant_mul():
    """nn_ops.mul of a [B, T, k] activation with an int8 weight: the
    product of the [B*T, k] flattening, reshaped back; a float32
    weight keeps torch.matmul."""
    x = np.random.RandomState(4).standard_normal((2, 3, 40)).astype(
        np.float32)
    wq, ws = _w(40, 24, 5)
    want = np.asarray(jax.jit(ref_q._dense_int8_matmul)(
        jnp.asarray(x.reshape(6, 40)), jnp.asarray(wq), jnp.asarray(ws)))
    got = nn_ops.mul(torch.from_numpy(x), torch.from_numpy(wq),
                     torch.from_numpy(ws))
    assert tuple(got.shape) == (2, 3, 24)
    assert np.array_equal(got.reshape(6, 24).numpy(), want)
    with pytest.raises(ValueError, match="scales"):
        nn_ops.mul(torch.from_numpy(x), torch.from_numpy(wq))


def test_wrapper_upcasts_and_rejects_bad_inputs():
    x = np.random.RandomState(6).standard_normal((3, 16))
    wq, ws = _w(16, 8, 7)
    t = torch.from_numpy
    got = port_q.quant_matmul_2d(t(x), t(wq), t(ws))     # float64 x
    want = port_q.int8_matmul_plain(t(x.astype(np.float32)), t(wq), t(ws))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="int8"):
        port_q.quant_matmul_2d(t(x), t(wq).float(), t(ws))
    with pytest.raises(ValueError, match="chain"):
        port_q.quant_matmul_2d(t(x), t(wq[:8]), t(ws))
    with pytest.raises(ValueError, match="w_scale"):
        port_q.quant_matmul_2d(t(x), t(wq), t(ws[:4]))
    assert port_q.scale_var_name("lm_head.w") == "lm_head.w@quant.scale" \
        == ref_q.scale_var_name("lm_head.w")


def test_eager_reference_divides():
    """The one place the reference's own paths part: uncompiled,
    ``quantize_rows`` divides amax by 127 and its scale can differ from
    the compiled one (and the port's) in the last bit. Here it does for
    some row, and the port equals the compiled scale on every row."""
    x = _x(37, 256, 8)
    eager = np.asarray(ref_q.quantize_rows(jnp.asarray(x))[1])
    compiled = np.asarray(jax.jit(ref_q.quantize_rows)(jnp.asarray(x))[1])
    port = port_q.quantize_rows(torch.from_numpy(x))[1].numpy()
    assert np.array_equal(port, compiled)
    amax = np.abs(x).max(-1, keepdims=True)
    assert np.array_equal(eager, amax / np.float32(127.0))
    assert not np.array_equal(eager, compiled)
    assert np.abs(eager - compiled).max() <= np.spacing(compiled).max()
