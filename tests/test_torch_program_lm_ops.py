"""The op types the transformer LM's program adds to the port's registry,
each against the reference's op on the same inputs (numpy, seeded): both
computes are called directly on one op description, the reference's on
jax arrays, the port's on CPU tensors.

* ``lookup_table`` (with ``padding_idx``, ``keep_dims`` and the
  trailing-1 squeeze), ``sequence_mask``, ``elementwise_mul`` and
  ``elementwise_div`` (the ``axis`` broadcast), ``dropout`` in train
  mode (the mask from the op's key) and in test mode: bitwise.
* ``layer_norm`` (``begin_norm_axis`` 1 and 2, scale and bias optional),
  ``matmul`` (both transposes, ``alpha``), ``reduce_sum``: within 1e-6
  relative (sums in other orders).
* ``gelu``: the tanh approximation, within 8 ulp at max(|y|, 1) of
  ``jax.nn.gelu`` (XLA's float32 ``tanh`` is its own approximation; 4.9
  measured, where a 1-ulp step at |y| near 1 is 1.2e-7).
* ``multihead_attention``, causal and not, with ``KeyLength``, and with
  Tq != Tk (the dense branch): within 1e-5 of max|out| against the
  reference with its flash flag on (the Pallas kernel interpreted) and
  off (its dense branch); on ``meta`` tensors the output takes q's
  shape and dtype without reaching the kernel's wrapper.
* ``ring_axis``: without a strategy whose mesh has the axis the op is
  the plain one; with one (a one-rank axis here) it takes ring attention,
  within 1e-5 of the plain op.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.core import registry as ref_registry
from paddle_tpu_torch.core import registry as port_registry
from paddle_tpu_torch.ops import flash_attention as port_flash
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _op(op_type, inputs, attrs):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs),
        inputs={k: [k] for k, v in inputs.items() if v is not None},
        outputs={})


def _run(registry, op_type, inputs, attrs, wrap, rng_key=None):
    op = _op(op_type, inputs, attrs)
    values = {k: [wrap(v)] for k, v in inputs.items() if v is not None}
    ctx = registry.ExecContext(op, values, rng_key=rng_key)
    out = registry.normalize_outputs(
        op, registry.get_op_def(op_type).compute(ctx))
    return {k: np.asarray(v[0]) if wrap is jnp.asarray
            else v[0].detach().float().numpy() if v[0].dtype ==
            torch.bfloat16 else v[0].detach().numpy()
            for k, v in out.items()}


def _both(op_type, inputs, attrs=(), ref_key=None, port_key=None):
    attrs = dict(attrs)
    ref = _run(ref_registry, op_type, inputs, attrs, jnp.asarray, ref_key)
    port = _run(port_registry, op_type, inputs, attrs, torch.from_numpy,
                port_key)
    assert sorted(ref) == sorted(port), (sorted(ref), sorted(port))
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("padding_idx,keep_dims,trailing", [
    (None, False, False), (None, False, True), (None, True, True),
    (3, False, True), (0, False, False)])
def test_lookup_table_bitwise(padding_idx, keep_dims, trailing):
    rs = np.random.RandomState(1)
    w = rs.standard_normal((11, 6)).astype(np.float32)
    ids = rs.randint(0, 11, (2, 5) + ((1,) if trailing else ()))
    ids = ids.astype(np.int32)
    ref, port = _both("lookup_table", {"W": w, "Ids": ids},
                      {"padding_idx": padding_idx, "keep_dims": keep_dims})
    assert ref["Out"].shape == port["Out"].shape
    np.testing.assert_array_equal(port["Out"], ref["Out"])


def test_lookup_table_gradient_is_a_dense_scatter_add():
    """Repeated ids add their rows' cotangents; the padding row takes
    none (``jax.vjp`` of the reference's op)."""
    rs = np.random.RandomState(2)
    w = rs.standard_normal((7, 4)).astype(np.float32)
    ids = np.array([[1, 3, 1], [3, 0, 1]], np.int32)
    g = rs.standard_normal((2, 3, 4)).astype(np.float32)
    attrs = {"padding_idx": 3, "keep_dims": False}
    op = _op("lookup_table", {"W": w, "Ids": ids}, attrs)

    def ref_f(wj):
        ctx = ref_registry.ExecContext(op, {"W": [wj],
                                            "Ids": [jnp.asarray(ids)]})
        return ref_registry.get_op_def("lookup_table").compute(ctx)["Out"]
    _, vjp = jax.vjp(ref_f, jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    wt = torch.from_numpy(w).requires_grad_()
    ctx = port_registry.ExecContext(op, {"W": [wt],
                                         "Ids": [torch.from_numpy(ids)]})
    out = port_registry.get_op_def("lookup_table").compute(ctx)["Out"]
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-6, atol=0)
    assert not wt.grad[3].any()


@pytest.mark.parametrize("begin,scale,bias", [
    (1, True, True), (2, True, True), (2, False, True), (2, True, False)])
def test_layer_norm(begin, scale, bias):
    rs = np.random.RandomState(3)
    x = (rs.standard_normal((3, 5, 8)) * 3 + 1).astype(np.float32)
    norm = x.shape[begin:]
    s = rs.standard_normal(int(np.prod(norm))).astype(np.float32) \
        if scale else None
    b = rs.standard_normal(int(np.prod(norm))).astype(np.float32) \
        if bias else None
    ref, port = _both("layer_norm", {"X": x, "Scale": s, "Bias": b},
                      {"begin_norm_axis": begin, "epsilon": 1e-5})
    for slot in ("Y", "Mean", "Variance"):
        assert port[slot].shape == ref[slot].shape, slot
        assert _rel(port[slot], ref[slot]) <= 1e-6, slot


def test_gelu_within_8_ulp():
    rs = np.random.RandomState(4)
    x = np.concatenate([rs.standard_normal(4000) * 3,
                        np.linspace(-10, 10, 2001)]).astype(np.float32)
    ref, port = _both("gelu", {"X": x})
    ulp = np.spacing(np.maximum(np.abs(ref["Out"]), 1.0).astype(np.float32))
    assert (np.abs(port["Out"] - ref["Out"]) <= 8 * ulp).all()


@pytest.mark.parametrize("tx,ty,alpha", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 0.5),
    (True, True, 2.5)])
def test_matmul(tx, ty, alpha):
    rs = np.random.RandomState(5)
    x = rs.standard_normal((2, 4, 6) if not tx else (2, 6, 4))
    y = rs.standard_normal((6, 3) if not ty else (3, 6))
    ref, port = _both("matmul", {"X": x.astype(np.float32),
                                 "Y": y.astype(np.float32)},
                      {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha})
    assert port["Out"].shape == ref["Out"].shape == (2, 4, 3)
    assert _rel(port["Out"], ref["Out"]) <= 1e-6


@pytest.mark.parametrize("op_type", ["elementwise_mul", "elementwise_div"])
@pytest.mark.parametrize("yshape,axis", [
    ((3, 4, 5), -1), ((5,), -1), ((4,), 1), ((3, 4), 0)])
def test_elementwise_bitwise(op_type, yshape, axis):
    rs = np.random.RandomState(6)
    x = rs.standard_normal((3, 4, 5)).astype(np.float32)
    y = (rs.standard_normal(yshape) + 3).astype(np.float32)
    ref, port = _both(op_type, {"X": x, "Y": y}, {"axis": axis})
    np.testing.assert_array_equal(port["Out"], ref["Out"])


@pytest.mark.parametrize("dim,keep_dim", [
    (None, False), (None, True), (1, False), ([0, 2], True), (-1, False)])
def test_reduce_sum(dim, keep_dim):
    rs = np.random.RandomState(7)
    x = rs.standard_normal((3, 4, 5)).astype(np.float32)
    ref, port = _both("reduce_sum", {"X": x},
                      {"dim": dim, "keep_dim": keep_dim,
                       "reduce_all": dim is None})
    assert port["Out"].shape == ref["Out"].shape
    assert _rel(port["Out"], ref["Out"]) <= 1e-6


def test_sequence_mask_bitwise():
    length = np.array([[4], [0], [7], [2]], np.int32)
    ref, port = _both("sequence_mask", {"Length": length},
                      {"maxlen": 7, "dtype": "float32"})
    assert port["Out"].dtype == ref["Out"].dtype == np.float32
    np.testing.assert_array_equal(port["Out"], ref["Out"])


def _key(seed):
    """A reference op key (uint32 [2], one split of the seed's key as the
    executor splits it) and the port's int64 copy."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    return key, torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_train_masks_bitwise(p, dtype):
    rs = np.random.RandomState(8)
    x = rs.standard_normal((3, 7, 9)).astype(np.float32)
    ref_key, port_key = _key(int(p * 100))
    attrs = {"dropout_prob": p, "is_test": False}
    op = _op("dropout", {"X": x}, attrs)
    rctx = ref_registry.ExecContext(
        op, {"X": [jnp.asarray(x).astype(dtype)]}, rng_key=ref_key)
    ref = ref_registry.get_op_def("dropout").compute(rctx)
    pctx = port_registry.ExecContext(
        op, {"X": [torch.from_numpy(x).to(getattr(torch, dtype))]},
        rng_key=port_key)
    port = port_registry.get_op_def("dropout").compute(pctx)
    for slot in ("Out", "Mask"):
        got = port[slot]
        assert str(got.dtype) == "torch." + dtype, slot
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref[slot], np.float32),
                                      err_msg=slot)
    kept = float(port["Mask"].float().mean())
    assert abs(kept - (1 - p)) < 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_test_mode_scales(dtype):
    rs = np.random.RandomState(9)
    x = rs.standard_normal((4, 6)).astype(np.float32)
    attrs = {"dropout_prob": 0.3, "is_test": True}
    op = _op("dropout", {"X": x}, attrs)
    ref = ref_registry.get_op_def("dropout").compute(ref_registry.ExecContext(
        op, {"X": [jnp.asarray(x).astype(dtype)]}))
    port = port_registry.get_op_def("dropout").compute(
        port_registry.ExecContext(
            op, {"X": [torch.from_numpy(x).to(getattr(torch, dtype))]}))
    np.testing.assert_array_equal(port["Out"].float().numpy(),
                                  np.asarray(ref["Out"], np.float32))
    assert (port["Mask"] == 1).all() and port["Mask"].dtype == port["Out"].dtype


def _mha_inputs(tq, tk, lengths):
    rs = np.random.RandomState(10)
    b, heads, d = len(lengths) if lengths is not None else 2, 2, 32
    q = rs.standard_normal((b, tq, heads * d)).astype(np.float32)
    k = rs.standard_normal((b, tk, heads * d)).astype(np.float32)
    v = rs.standard_normal((b, tk, heads * d)).astype(np.float32)
    klen = None if lengths is None else np.array(lengths, np.int32)
    return {"Q": q, "K": k, "V": v, "KeyLength": klen}, heads


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("causal,tq,tk,lengths", [
    (True, 32, 32, None), (False, 32, 32, None), (True, 32, 32, [32, 19]),
    (False, 32, 32, [7, 32]), (False, 8, 32, [20, 32]), (True, 32, 48, None)])
def test_multihead_attention(flash, causal, tq, tk, lengths):
    inputs, heads = _mha_inputs(tq, tk, lengths)
    ptpu.config.set_flags(flash_attention=flash)
    try:
        ref, port = _both("multihead_attention", inputs,
                          {"num_heads": heads, "causal": causal,
                           "ring_axis": None})
    finally:
        ptpu.config.set_flags(flash_attention=False)
    assert port["Out"].shape == ref["Out"].shape == (inputs["Q"].shape)
    assert _rel(port["Out"], ref["Out"]) <= 1e-5


def test_multihead_attention_shape_rule_on_meta(monkeypatch):
    """Shape inference runs the op on ``meta`` tensors: the output is q's
    shape and dtype, and the kernel's wrapper (whose device check raises
    on meta tensors) is not reached."""
    monkeypatch.setattr(port_flash, "_on_cpu", None)
    op = _op("multihead_attention", {"Q": 1, "K": 1, "V": 1},
             {"num_heads": 2, "causal": True, "ring_axis": None})
    meta = torch.empty((3, 16, 64), dtype=torch.bfloat16, device="meta")
    out = port_registry.get_op_def("multihead_attention").compute(
        port_registry.ExecContext(op, {"Q": [meta], "K": [meta],
                                       "V": [meta]}))["Out"]
    assert out.device.type == "meta" and out.shape == meta.shape \
        and out.dtype == torch.bfloat16


def test_ring_axis_raises():
    """``ring_axis`` no longer raises (the name is kept): see the module
    docstring."""
    from paddle_tpu_torch import parallel
    inputs, heads = _mha_inputs(8, 8, None)
    values = {k: [torch.from_numpy(v)] for k, v in inputs.items()
              if v is not None}
    compute = port_registry.get_op_def("multihead_attention").compute

    def run(ring_axis):
        op = _op("multihead_attention", inputs,
                 {"num_heads": heads, "causal": True,
                  "ring_axis": ring_axis})
        return compute(port_registry.ExecContext(op, values))["Out"]
    plain = run(None)
    assert torch.equal(run("sp"), plain)
    prev = parallel.set_current_strategy(parallel.DistStrategy(
        parallel.make_mesh({"sp": 1})))
    try:
        ring = run("sp")
    finally:
        parallel.set_current_strategy(prev)
    assert _rel(ring.numpy(), plain.numpy()) <= 1e-5
