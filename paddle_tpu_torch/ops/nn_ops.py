"""The dense ops of the LM backbone, as plain tensor functions with the
reference's semantics (``paddle_tpu/ops/{nn_ops,activation_ops,
math_ops,tensor_ops}.py``). Matrix products of float32 weights go to
``torch.matmul``, as the reference left them to XLA; an int8 weight
(armed for int8 compute, ``serving/quant.py``) goes through kernel B3
(``ops/quant_ops.py``)."""

import torch
import torch.nn.functional as F

from .quant_ops import quant_matmul_2d

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather",
           "argmax"]


def layer_norm(x, scale, bias, eps=1e-5):
    """Normalize over the last axis with the biased variance, then scale
    and shift (reference ``layer_norm`` with begin_norm_axis = last)."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mul(x, w, w_scale=None):
    """x [..., in] times w [in, out] (the reference stores fc weights as
    [in, out]). An int8 ``w`` takes its f32 [out] ``w_scale``: x is
    flattened to [-1, in] for :func:`quant_matmul_2d` and the result
    reshaped back, as the reference's ``_quant_mul`` does."""
    if w.dtype != torch.int8:
        return torch.matmul(x, w)
    if w_scale is None:
        raise ValueError("an int8 weight needs its scales")
    k, n = w.shape
    y = quant_matmul_2d(x.reshape(-1, k).contiguous(), w, w_scale)
    return y.reshape(x.shape[:-1] + (n,))


def fc(x, w, b=None, act=None, w_scale=None):
    """The reference ``layers.fc``: mul, then the bias, then the
    activation."""
    y = mul(x, w, w_scale)
    if b is not None:
        y = y + b
    return act(y) if act is not None else y


def lookup_table(w, ids):
    """Embedding rows of ``w`` for int ids of any shape: ids [...] ->
    [..., width] (the ``keep_dims`` form the cached backbone uses)."""
    return w[ids]


def gather(x, index):
    """Rows ``index`` (flattened) of x along axis 0."""
    return x.index_select(0, index.reshape(-1))


def argmax(x, axis=-1):
    """Index of the first maximum, as ``jnp.argmax``."""
    return torch.argmax(x, dim=axis)
