"""The dense ops of the LM backbone and of the ResNet, as plain tensor
functions with the reference's semantics (``paddle_tpu/ops/{nn_ops,
activation_ops,math_ops,tensor_ops}.py``). Matrix products of float32
weights go to ``torch.matmul`` and convolutions to ``F.conv2d``, as the
reference left them to XLA; an int8 weight (armed for int8 compute,
``serving/quant.py``) goes through kernel B3 (``ops/quant_ops.py``).
The fused convolution + batch norm is ``ops/conv_bn.py``. Under amp
(``amp.py``) ``mul`` and ``conv2d`` are WHITE ops: their float32
operands are cast to the amp dtype first (``conv2d_bn`` is on neither
list and stays float32, as in the reference)."""

import torch
import torch.nn.functional as F

from ..amp import amp_cast
from .quant_ops import quant_matmul_2d

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather",
           "argmax", "conv2d", "pool2d", "batch_norm"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def layer_norm(x, scale, bias, eps=1e-5):
    """Normalize over the last axis with the biased variance, then scale
    and shift (reference ``layer_norm`` with begin_norm_axis = last)."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mul(x, w, w_scale=None, amp=None):
    """x [..., in] times w [in, out] (the reference stores fc weights as
    [in, out]). ``amp`` (a dtype, or None for amp off) casts float32
    operands to it, as the reference's executor does for this WHITE op:
    a bfloat16 product, its sums in f32, rounded to bfloat16. An int8
    ``w`` takes its f32 [out] ``w_scale``: x is flattened to [-1, in] for
    :func:`quant_matmul_2d` and the result reshaped back, as the
    reference's ``_quant_mul`` does."""
    if w.dtype != torch.int8:
        return torch.matmul(amp_cast("mul", x, amp), amp_cast("mul", w, amp))
    if w_scale is None:
        raise ValueError("an int8 weight needs its scales")
    k, n = w.shape
    y = quant_matmul_2d(x.reshape(-1, k).contiguous(), w, w_scale)
    return y.reshape(x.shape[:-1] + (n,))


def fc(x, w, b=None, act=None, w_scale=None, amp=None):
    """The reference ``layers.fc``: mul, then the bias, then the
    activation. Under amp a bfloat16 product plus a float32 bias is
    float32 (torch's promotion and ``jnp.add``'s agree for a 1-D bias)."""
    y = mul(x, w, w_scale, amp)
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


def conv2d(x, w, stride=1, padding=0, dilation=1, groups=1, amp=None):
    """NCHW input, OIHW filter, symmetric padding (reference
    ``conv2d``). ``amp`` (a dtype, or None for amp off) casts float32
    operands to it, as the reference's executor does for this WHITE op:
    a bfloat16 convolution with a bfloat16 output."""
    return F.conv2d(amp_cast("conv2d", x, amp), amp_cast("conv2d", w, amp),
                    None, _pair(stride), _pair(padding), _pair(dilation),
                    groups)


def pool2d(x, ksize, pool_type="max", strides=1, paddings=0,
           global_pooling=False, ceil_mode=False, exclusive=True):
    """Reference ``_pool`` over NCHW: ``global_pooling`` takes the whole
    plane; max pads with -inf; avg divides each window's sum by the
    count of its unpadded elements (``exclusive``) or by the window
    size; ``ceil_mode`` pads s - 1 more on the far side."""
    if global_pooling:
        ksize, strides, paddings = tuple(x.shape[2:]), (1, 1), (0, 0)
    ksize, strides, paddings = _pair(ksize), _pair(strides), _pair(paddings)
    extra = [s - 1 if ceil_mode else 0 for s in strides]
    pad = (paddings[1], paddings[1] + extra[1],
           paddings[0], paddings[0] + extra[0])
    if pool_type == "max":
        return F.max_pool2d(F.pad(x, pad, value=float("-inf")), ksize,
                            strides)
    summed = F.avg_pool2d(F.pad(x, pad), ksize, strides, divisor_override=1)
    if not exclusive:
        return summed / float(ksize[0] * ksize[1])
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), pad)
    counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    return summed / counts


def batch_norm(x, scale, bias, mean, variance, momentum=0.9, epsilon=1e-5,
               is_test=False):
    """Reference ``batch_norm`` over NCHW: in training the batch mean and
    the biased variance ``E[x^2] - E[x]^2`` (moments in f32), with the
    running statistics ``mean`` and ``variance`` updated IN PLACE, outside
    autograd, to ``momentum * old + (1 - momentum) * batch`` (torch's
    ``F.batch_norm`` weights the other way and keeps an unbiased running
    variance); ``is_test`` normalizes by the running statistics. Returns
    ``x * a + b`` with ``a = scale / sqrt(var + eps)`` and
    ``b = bias - mean * a``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if is_test:
        use_mean, use_var = mean, variance
    else:
        xs = x if x.dtype == torch.float32 else x.float()
        axes = (0,) + tuple(range(2, x.dim()))
        use_mean = xs.mean(dim=axes)
        use_var = (xs * xs).mean(dim=axes) - use_mean * use_mean
        with torch.no_grad():
            mean.copy_(momentum * mean + (1.0 - momentum) * use_mean)
            variance.copy_(momentum * variance + (1.0 - momentum) * use_var)
    inv = torch.rsqrt(use_var + epsilon)
    a = inv * scale
    b = bias - use_mean * a
    return x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)
