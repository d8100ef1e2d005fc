"""The dense ops of the LM backbone, as plain tensor functions with the
reference's semantics (``paddle_tpu/ops/{nn_ops,activation_ops,
math_ops,tensor_ops}.py``). Matrix products go to ``torch.matmul``, as
the reference left them to XLA."""

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather",
           "argmax"]


def layer_norm(x, scale, bias, eps=1e-5):
    """Normalize over the last axis with the biased variance, then scale
    and shift (reference ``layer_norm`` with begin_norm_axis = last)."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mul(x, w):
    """x [..., in] times w [in, out] (the reference stores fc weights as
    [in, out])."""
    return torch.matmul(x, w)


def fc(x, w, b=None, act=None):
    """The reference ``layers.fc``: mul, then the bias, then the
    activation."""
    y = mul(x, w)
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
