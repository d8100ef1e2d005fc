"""The dense ops of the LM backbone and of the ResNet, as plain tensor
functions with the reference's semantics (``paddle_tpu/ops/{nn_ops,
activation_ops,math_ops,tensor_ops}.py``). Matrix products of float32
weights go to ``torch.matmul`` and convolutions to ``F.conv2d``, as the
reference left them to XLA; an int8 weight (armed for int8 compute,
``serving/quant.py``) goes through kernel B3 (``ops/quant_ops.py``).
The fused convolution + batch norm is ``ops/conv_bn.py``. Under amp
(``amp.py``) ``mul`` and ``conv2d`` are WHITE ops: their float32
operands are cast to the amp dtype first (``conv2d_bn`` is on neither
list and stays float32, as in the reference).

The program ops ``mul``, ``conv2d``, ``pool2d``, ``batch_norm``,
``layer_norm`` and ``dropout`` are registered here with the reference's
slots and attributes (its ``ops/nn_ops.py`` and ``math_ops.py``); the
executor casts their inputs under amp before the call."""

import math

import torch
import torch.nn.functional as F

from ..amp import amp_cast
from ..core.registry import register_op
from .quant_ops import quant_matmul_2d
from .random_ops import uniform

__all__ = ["layer_norm", "gelu", "mul", "fc", "lookup_table", "gather",
           "argmax", "conv2d", "pool2d", "batch_norm", "batch_norm_stats"]


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
    """Reference ``_pool`` over NCHW (:func:`pool_nd` with each of
    ``ksize``, ``strides`` and ``paddings`` an int or a pair)."""
    return pool_nd(x, _pair(ksize), _pair(strides), _pair(paddings),
                   pool_type, exclusive, global_pooling, ceil_mode)


def batch_norm_stats(x, scale, bias, mean, variance, momentum=0.9,
                     epsilon=1e-5, is_test=False, channel_axis=1,
                     reduce=None, count_mult=1):
    """Reference ``batch_norm`` as a function: ``(y, mean_out,
    variance_out, saved_mean, saved_inv)``. In training the batch mean
    and the biased variance ``E[x^2] - E[x]^2`` (moments in f32), and the
    running statistics ``momentum * old + (1 - momentum) * batch`` (torch's
    ``F.batch_norm`` weights the other way and keeps an unbiased running
    variance); ``is_test`` normalizes by the running statistics and
    returns them as they are. ``y = x * a + b`` with
    ``a = scale / sqrt(var + eps)`` and ``b = bias - mean * a``;
    ``saved_inv`` is ``1 / sqrt(var + eps)``.

    ``reduce`` (under a distribution strategy, ``parallel/spmd.py``)
    sums the per-channel sums of x and x^2 over the data axis's ranks,
    each holding ``1 / count_mult`` of the batch, before the moments are
    finished: the statistics are the global batch's."""
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    if is_test:
        use_mean, use_var = mean, variance
        new_mean, new_var = mean, variance
    else:
        # moments in f32 at least (a float64 input keeps float64)
        xs = x if x.dtype in (torch.float32, torch.float64) else x.float()
        axes = tuple(i for i in range(x.dim()) if i != channel_axis)
        if reduce is None:
            use_mean = xs.mean(dim=axes)
            use_var = (xs * xs).mean(dim=axes) - use_mean * use_mean
        else:
            count = count_mult * (xs.numel() // xs.shape[channel_axis])
            use_mean = reduce(xs.sum(dim=axes)) / count
            use_var = reduce((xs * xs).sum(dim=axes)) / count \
                - use_mean * use_mean
        new_mean = momentum * mean + (1.0 - momentum) * use_mean
        new_var = momentum * variance + (1.0 - momentum) * use_var
    inv = torch.rsqrt(use_var + epsilon)
    a = inv * scale
    b = bias - use_mean * a
    y = x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)
    return y, new_mean, new_var, use_mean, inv


def batch_norm(x, scale, bias, mean, variance, momentum=0.9, epsilon=1e-5,
               is_test=False, update_stats=True):
    """:func:`batch_norm_stats` over NCHW with the running statistics
    ``mean`` and ``variance`` updated IN PLACE, outside autograd, unless
    ``is_test`` or not ``update_stats`` (a recomputed forward); returns
    y."""
    y, new_mean, new_var, _, _ = batch_norm_stats(
        x, scale, bias, mean, variance, momentum, epsilon, is_test)
    if update_stats and not is_test:
        with torch.no_grad():
            mean.copy_(new_mean)
            variance.copy_(new_var)
    return y


@register_op("mul")
def _mul(ctx):
    """Flattening matmul (reference mul_op.cc): X flattened to 2D at
    x_num_col_dims, Y at y_num_col_dims."""
    x, y = ctx.input("X"), ctx.input("Y")
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xd]), math.prod(xs[xd:]))
    y2 = y.reshape(math.prod(ys[:yd]), math.prod(ys[yd:]))
    return {"Out": torch.matmul(x2, y2).reshape(xs[:xd] + ys[yd:])}


@register_op("conv2d")
def _conv2d(ctx):
    return {"Output": conv2d(ctx.input("Input"), ctx.input("Filter"),
                             ctx.attr("strides", [1, 1]),
                             ctx.attr("paddings", [0, 0]),
                             ctx.attr("dilations", [1, 1]),
                             ctx.attr("groups", 1) or 1)}


@register_op("pool2d")
def _pool2d(ctx):
    return {"Out": pool2d(ctx.input("X"), ctx.attr("ksize"),
                          ctx.attr("pooling_type", "max"),
                          ctx.attr("strides", [1, 1]),
                          ctx.attr("paddings", [0, 0]),
                          ctx.attr("global_pooling", False),
                          ctx.attr("ceil_mode", False),
                          ctx.attr("exclusive", True))}


@register_op("batch_norm")
def _batch_norm(ctx):
    """Reference batch_norm_op.cc semantics: the running statistics come
    out as new tensors (MeanOut, VarianceOut), which the executor writes
    to the scope; SavedVariance is the inverse standard deviation."""
    x = ctx.input("X")
    channel_axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" \
        else x.dim() - 1
    y, mean, var, saved_mean, inv = batch_norm_stats(
        x, ctx.input("Scale"), ctx.input("Bias"), ctx.input("Mean"),
        ctx.input("Variance"), ctx.attr("momentum", 0.9),
        ctx.attr("epsilon", 1e-5), ctx.attr("is_test", False), channel_axis)
    return {"Y": y, "MeanOut": mean, "VarianceOut": var,
            "SavedMean": saved_mean, "SavedVariance": inv}


@register_op("layer_norm")
def _layer_norm(ctx):
    """Reference ``layer_norm`` over the axes from ``begin_norm_axis`` on:
    ``(x - mean) * rsqrt(var + eps)`` with ``var`` the mean of the
    squared deviation, then the optional scale and bias, reshaped to
    those axes. One ``torch.native_layer_norm`` call (the kernel of the
    nn.Module LM's :func:`layer_norm`, one fused pass each way that saves
    only x and its row statistics for the gradient) gives Y, the row
    means and rsqrt(var + eps); ``Mean`` is those means and ``Variance``
    ``rstd**-2 - eps`` (the leading axes' shape, x's dtype, no gradient).
    The reference writes the same function as separate passes, so Y and
    Mean differ from its in the last bits, and Variance by a few ulps of
    ``var + eps``."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    norm = tuple(x.shape[begin:])
    lead = x.shape[:begin]
    if x.device.type == "meta":
        # shape inference: the shapes alone (torch's meta layer norm
        # decomposes the whole computation, milliseconds an op)
        stats = torch.empty(lead, dtype=x.dtype, device="meta")
        return {"Y": torch.empty_like(x), "Mean": stats, "Variance": stats}
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    y, mean, rstd = torch.native_layer_norm(
        x, norm, None if scale is None else scale.reshape(norm),
        None if bias is None else bias.reshape(norm), eps)
    with torch.no_grad():
        var = rstd.reshape(lead).pow(-2) - eps
    return {"Y": y, "Mean": mean.detach().reshape(lead).to(x.dtype),
            "Variance": var.to(x.dtype)}


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform(key, shape, float32) < float32(p)``, bitwise JAX's (the
    uniform is, ``ops/random_ops.py``). A bool tensor on the key's
    device."""
    n = math.prod(shape)
    return (uniform(key, n) < torch.tensor(p, dtype=torch.float32)) \
        .reshape(tuple(shape))


@register_op("dropout", needs_rng=True)
def _dropout(ctx):
    """Reference ``dropout``: in training a mask kept with probability 1
    - p, drawn from the op's own key (the executor splits the scope's key
    before the op, as the reference's does), so the masks are the
    reference's bit for bit; ``is_test`` scales by (1 - p), the constant
    rounded to x's dtype first as JAX's weak typing rounds it, and the
    mask is all ones."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False):
        return {"Out": x * torch.tensor(1.0 - p, dtype=x.dtype),
                "Mask": torch.ones_like(x)}
    mask = bernoulli(ctx.rng_key, 1.0 - p, x.shape).to(x.dtype)
    return {"Out": x * mask, "Mask": mask}


# -- the rest of the reference's nn ops ----------------------------------
# Convolutions stay torch's (cuDNN on the card), as the reference leaves
# them to XLA; pooling pads explicitly (max with -inf) and pools without
# padding, so any padding the reference takes is taken here too.

def _conv_attrs(ctx, n):
    def tup(name, default):
        v = ctx.attr(name, default)
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n
    return (tup("strides", [1] * n), tup("paddings", [0] * n),
            tup("dilations", [1] * n))


@register_op("batch_conv2d")
def _batch_conv2d(ctx):
    """Each image convolved with its own filters: Input [B, C, H, W],
    Filter [B, O, C, kh, kw] -> [B, O, oh, ow], one grouped convolution
    (groups B), as the reference's vmapped convolution lowers."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    strides, pads, dils = _conv_attrs(ctx, 2)
    b, c = x.shape[0], x.shape[1]
    o = w.shape[1]
    out = F.conv2d(x.reshape((1, b * c) + tuple(x.shape[2:])),
                   w.reshape((b * o,) + tuple(w.shape[2:])), None, strides,
                   pads, dils, b)
    return {"Output": out.reshape((b, o) + tuple(out.shape[2:]))}


@register_op("conv3d")
def _conv3d(ctx):
    strides, pads, dils = _conv_attrs(ctx, 3)
    return {"Output": F.conv3d(ctx.input("Input"), ctx.input("Filter"), None,
                               strides, pads, dils,
                               ctx.attr("groups", 1) or 1)}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx):
    """The gradient of a convolution: Filter [in, out, kh, kw], output
    ``(in - 1) * stride - 2 * pad + dilation * (k - 1) + 1``."""
    strides, pads, dils = _conv_attrs(ctx, 2)
    return {"Output": F.conv_transpose2d(
        ctx.input("Input"), ctx.input("Filter"), None, strides, pads, 0, 1,
        dils)}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx):
    strides, pads, dils = _conv_attrs(ctx, 3)
    return {"Output": F.conv_transpose3d(
        ctx.input("Input"), ctx.input("Filter"), None, strides, pads, 0, 1,
        dils)}


@register_op("factorization_machine")
def _factorization_machine(ctx):
    """The second-order interaction ``0.5 * sum_k((x V)_k^2 - (x^2
    V^2)_k)``, [..., 1]."""
    x, v = ctx.input("X"), ctx.input("V")
    xv = x @ v
    x2v2 = (x * x) @ (v * v)
    return {"Out": 0.5 * torch.sum(xv * xv - x2v2, dim=-1, keepdim=True)}


def pool_nd(x, ksize, strides, pads, pooling_type="max", exclusive=True,
            global_pooling=False, ceil_mode=False):
    """The reference's ``_pool`` over the spatial axes of x [N, C, ...]:
    ``global_pooling`` takes the whole extent; max pads with -inf; avg
    divides a window's sum by the count of its unpadded elements
    (``exclusive``) or by the window's size; ``ceil_mode`` pads s - 1
    more on the far side."""
    nd = x.dim() - 2
    if global_pooling:
        ksize, strides, pads = tuple(x.shape[2:]), (1,) * nd, (0,) * nd
    pad = []
    for p, s in reversed(list(zip(pads, strides))):
        pad += [p, p + (s - 1 if ceil_mode else 0)]
    max_pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
    avg_pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd - 1]
    if pooling_type == "max":
        return max_pool(F.pad(x, pad, value=float("-inf")), ksize, strides)
    summed = avg_pool(F.pad(x, pad), ksize, strides, divisor_override=1)
    if not exclusive:
        return summed / torch.full((), float(math.prod(ksize)),
                                   dtype=x.dtype, device=x.device)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), pad)
    return summed / avg_pool(ones, ksize, strides, divisor_override=1)


@register_op("pool3d")
def _pool3d(ctx):
    return {"Out": pool_nd(ctx.input("X"), tuple(ctx.attr("ksize")),
                           tuple(ctx.attr("strides", [1, 1, 1])),
                           tuple(ctx.attr("paddings", [0, 0, 0])),
                           ctx.attr("pooling_type", "max"),
                           ctx.attr("exclusive", True),
                           ctx.attr("global_pooling", False),
                           ctx.attr("ceil_mode", False))}


@register_op("pool2d_with_index")
def _pool2d_with_index(ctx):
    """Max pooling and, in ``Mask`` (int32), each maximum's flat index
    ``h * W + w`` in its channel's unpadded plane."""
    x = ctx.input("X")
    out, idx = F.max_pool2d(x, _pair(ctx.attr("ksize")),
                            _pair(ctx.attr("strides", [1, 1])),
                            _pair(ctx.attr("paddings", [0, 0])),
                            return_indices=True)
    return {"Out": out, "Mask": idx.to(torch.int32)}


@register_op("lrn")
def _lrn(ctx):
    """Local response norm across channels: ``mid = k + alpha * sum`` of
    the squares over a window of n channels (zero-padded), ``x /
    mid^beta``; the window summed in the reference's order."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    half = n // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = pad[:, 0:c]
    for i in range(1, n):
        acc = acc + pad[:, i:i + c]
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc
    return {"Out": x / torch.pow(mid, ctx.attr("beta", 0.75)),
            "MidOut": mid}


@register_op("maxout")
def _maxout(ctx):
    x = ctx.input("X")
    g = ctx.attr("groups")
    n, c = x.shape[0], x.shape[1]
    return {"Out": x.reshape((n, c // g, g) + tuple(x.shape[2:]))
            .amax(dim=2)}


@register_op("norm")
def _norm(ctx):
    """Cross-channel L2 normalization, scaled per channel."""
    x, scale = ctx.input("X"), ctx.input("Scale")
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) +
                      ctx.attr("epsilon", 1e-10))
    return {"Out": x / norm * scale.reshape(1, -1, 1, 1)}


@register_op("l2_normalize")
def _l2_normalize(ctx):
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(x * x, dim=ctx.attr("axis", -1),
                                keepdim=True) + ctx.attr("epsilon", 1e-12))
    return {"Out": x / norm, "Norm": norm}


@register_op("conv_shift")
def _conv_shift(ctx):
    """Circular correlation: ``out[b, i] = sum_j x[b, (i + j - M // 2)
    mod N] * y[b, j]``."""
    x, y = ctx.input("X"), ctx.input("Y")
    n, m = x.shape[1], y.shape[1]
    ar = torch.arange(n, device=x.device)
    idx = (ar[:, None] + torch.arange(m, device=x.device)[None, :] -
           m // 2) % n
    return {"Out": torch.einsum("bnm,bm->bn", x[:, idx], y)}


@register_op("row_conv")
def _row_conv(ctx):
    """Lookahead convolution over time of X [B, T, D] with Filter [k, D]:
    ``out[t] = sum_i x[t + i] * w[i]``, zero past the end."""
    x, w = ctx.input("X"), ctx.input("Filter")
    k, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, k - 1))
    out = pad[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + t] * w[i]
    return {"Out": out}


@register_op("spp")
def _spp(ctx):
    """Spatial pyramid pooling: level l pools into 2^l x 2^l bins
    (window and stride ceil(H / 2^l), padding to cover, the window size
    as an average's divisor), each level flattened, all concatenated."""
    x = ctx.input("X")
    pool_type = ctx.attr("pooling_type", "max")
    n, _, h, w = x.shape
    outs = []
    for lvl in range(ctx.attr("pyramid_height", 3)):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        out = pool_nd(x, (kh, kw), (kh, kw), (ph, pw), pool_type,
                      exclusive=False)
        outs.append(out.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}


@register_op("unpool")
def _unpool(ctx):
    """Max-unpooling: each value of X added at its ``Indices`` entry (a
    flat index into an ``unpooled_height`` x ``unpooled_width`` plane
    of its channel, as ``pool2d_with_index`` gives it)."""
    x, idx = ctx.input("X"), ctx.input("Indices")
    n, c = x.shape[0], x.shape[1]
    oh, ow = ctx.attr("unpooled_height"), ctx.attr("unpooled_width")
    flat = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out = flat.scatter_add(2, idx.reshape(n, c, -1).to(torch.int64),
                           x.reshape(n, c, -1))
    return {"Out": out.reshape(n, c, oh, ow)}


@register_op("im2sequence")
def _im2sequence(ctx):
    """Image patches to rows: [N * oh * ow, C * kh * kw], the rows in
    (image, patch row, patch column) order, each row channel-major as
    ``conv_general_dilated_patches`` lays it out; no padding."""
    x = ctx.input("X")
    kernels = _pair(ctx.attr("kernels"))
    patches = F.unfold(x, kernels, stride=_pair(ctx.attr("strides", [1, 1])))
    n, ckk, _ = patches.shape
    return {"Out": patches.transpose(1, 2).reshape(-1, ckk)}
