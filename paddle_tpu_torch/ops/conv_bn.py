"""Fused convolution + batch-norm statistics (reference
``paddle_tpu/ops/pallas_conv_bn.py``): the wrapper of kernel B1, its
plain version, the autograd Function around both, and the fused
``conv2d_bn`` op.

:func:`conv_bn_stats` returns ``(y, sum_c, sumsq_c)``: the convolution's
output and the f32 sums of y and of y * y over every axis but the
channel. A 1x1, stride-1, unpadded, ungrouped f32 convolution takes
kernel B1 (``csrc/conv_bn_stats.cu``, wrapper :func:`conv_bn_stats_1x1`),
which replaces ``_pallas_1x1``; every other geometry takes the plain
version (``F.conv2d`` plus the two sums) on any device, as the reference
takes its ``_reference`` there. On CPU tensors, and on meta tensors
(a program's shape inference), the wrapper computes the plain version;
on CUDA tensors it launches the kernel or raises, and counts launches in
``conv_bn_stats_1x1.launches``. The program op ``conv2d_bn`` is
registered here.

The backward (:class:`ConvBnStats`) is the reference's ``_bwd``: the
vjp of the plain function with cotangents on all three outputs, i.e.
the convolution's input and weight gradients of
``g = g_y + g_s + 2 y g_ss`` (``aten.convolution_backward``). The batch
norm that follows differentiates through the sums, so g_s and g_ss are
not zero in training.

:func:`conv1x1_bn_relu` is the probe T1 (``tools/fused_conv_bn_probe.py``,
kernel ``csrc/conv1x1_bn_relu.cu``): a 1x1 convolution over bf16 rows
with the prologue ``relu(x * a + b)`` and its output's sums in the
epilogue, on the tensor cores; it is not on a training path.
"""

import collections

import torch

from . import _build
from ..core.registry import register_op
from .flash_attention import _on_cpu, _require
from .nn_ops import _pair, conv2d

__all__ = ["conv_bn_stats_plain", "conv_bn_stats_1x1", "fusable",
           "ConvBnStats", "conv_bn_stats", "conv2d_bn", "conv2d_bn_stats",
           "conv1x1_bn_relu_plain", "conv1x1_bn_relu"]

# kernel B1's tiles, (output channels, pixels) per CTA, by the id its C
# entry takes (``kTiles`` in csrc/conv_bn_stats.cu): the two ``_plan``
# picks; C is padded to a multiple of B1_BK and O to one of B1_O_ALIGN in
# its transposed weight
B1_TILES = ((64, 128), (128, 64))
B1_BK, B1_O_ALIGN = 16, 128
# T1's tile, (rows, output columns) per CTA (``kT1BM``, ``kT1BN`` in
# csrc/conv1x1_bn_relu.cu): a CTA keeps its rows' z tile and walks every
# column tile, one partial sum a row tile; the fastest of the tiles swept
# at each of the probe's cases (``python3 -m
# paddle_tpu_torch.probes.conv_bn t1``; PERF.md)
T1_TILE = (128, 64)

Plan = collections.namedtuple("Plan", "tile bm bn ctas p_tiles c_pad o_pad")
T1Plan = collections.namedtuple("T1Plan", "bm bn row_tiles o_tiles")


def _cdiv(a, b):
    return -(-a // b)


def _plan(n, c, p, o, tile=None, tiles=B1_TILES):
    """Kernel B1's launch for x [n, c, p] and w [o, c]: the tile id, its
    (bm, bn), the CTAs of the grid, the pixel tiles (one partial sum of
    each channel apiece), and the padded [c_pad, o_pad] of the
    transposed weight. O <= 64 takes 64 x 128, a whole channel tile;
    wider O 128 x 64, the fastest of the three tiles swept or within
    1.5% of it at each such shape of ResNet-50 (``python3 -m
    paddle_tpu_torch.probes.conv_bn b1``; PERF.md). ``tile`` forces a
    tile id of ``tiles``, the table of the build launched (the probe's
    sweep builds edited tables)."""
    r = n * p
    if tile is None:
        tile = 0 if o <= 64 else 1
    bm, bn = tiles[tile]
    p_tiles = _cdiv(r, bn)
    return Plan(tile, bm, bn, p_tiles * _cdiv(o, bm), p_tiles,
                _cdiv(c, B1_BK) * B1_BK, _cdiv(o, B1_O_ALIGN) * B1_O_ALIGN)


def _plain_route(*tensors):
    """True for tensors that take the plain version: CPU tensors, and
    meta tensors (a program's shape inference, which needs shapes and no
    data); False for CUDA tensors (``flash_attention._on_cpu``)."""
    if all(t.is_meta for t in tensors):
        return True
    return _on_cpu(*tensors)


def _channel_view(v):
    return v.reshape(1, -1, 1, 1)


def conv_bn_stats_plain(x, w, stride=1, padding=0, dilation=1, groups=1):
    """The plain version (reference ``_reference``): ``F.conv2d`` on
    NCHW / OIHW, then the f32 sums of y and y * y per output channel."""
    y = conv2d(x, w, stride, padding, dilation, groups)
    ys = y if y.dtype in (torch.float32, torch.float64) else y.float()
    return y, ys.sum(dim=(0, 2, 3)), (ys * ys).sum(dim=(0, 2, 3))


def fusable(x, w, stride=1, padding=0, dilation=1, groups=1):
    """True for the geometry kernel B1 takes: a 1x1, stride-1,
    unpadded, undilated, ungrouped f32 convolution (reference
    ``_forward``; the compiled TPU path also asked C and O to be
    multiples of 128, the kernel here takes any)."""
    return (w.shape[2] == 1 and w.shape[3] == 1 and _pair(stride) == (1, 1)
            and _pair(padding) == (0, 0) and _pair(dilation) == (1, 1)
            and groups == 1 and x.dtype == torch.float32
            and w.dtype == torch.float32)


def conv_bn_stats_1x1(x, w):
    """Kernel B1: x f32 [N, C, H, W], w f32 [O, C, 1, 1] ->
    (y f32 [N, O, H, W], sum_c f32 [O], sumsq_c f32 [O]). Any N, C, O,
    H, W >= 1."""
    _require(x.dim() == 4 and w.dim() == 4 and w.shape[2:] == (1, 1)
             and x.shape[1] == w.shape[1],
             "x [N, C, H, W] and w [O, C, 1, 1] do not chain: %s %s",
             tuple(x.shape), tuple(w.shape))
    _require(x.dtype == torch.float32 and w.dtype == torch.float32,
             "x and w must be float32, got %s %s", x.dtype, w.dtype)
    if _plain_route(x, w):
        return conv_bn_stats_plain(x, w)
    n, c, h, wd = x.shape
    o, p = w.shape[0], h * wd
    _require(n >= 1 and c >= 1 and o >= 1 and p >= 1, "empty conv %s %s",
             tuple(x.shape), tuple(w.shape))
    y, s, ss = _launch(x.contiguous(), w.contiguous(), _plan(n, c, p, o))
    conv_bn_stats_1x1.launches += 1
    return y, s, ss


conv_bn_stats_1x1.launches = 0


def _scratch(x, o, plan):
    """B1's scratch for ``plan`` on x's device: the transposed weight
    [c_pad, o_pad] and the partial sums of y and y * y [2, p_tiles, o]."""
    return (torch.empty((plan.c_pad, plan.o_pad), dtype=torch.float32,
                        device=x.device),
            torch.empty((2, plan.p_tiles, o), dtype=torch.float32,
                        device=x.device))


def _launch(x, w, plan, scratch=None, fn=None):
    """One launch of B1's C entry on contiguous CUDA x and w by ``plan``,
    on ``scratch`` (as :func:`_scratch` makes it; default: allocated
    here) through the ctypes entry ``fn`` (default: the build of the
    source as it is); not counted."""
    n, c, h, wd = x.shape
    o, p = w.shape[0], h * wd
    _require(plan.ctas < 2 ** 31, "grid too large: %d CTAs", plan.ctas)
    y = torch.empty((n, o, h, wd), dtype=torch.float32, device=x.device)
    wt, part = _scratch(x, o, plan) if scratch is None else scratch
    sums = torch.empty((2, o), dtype=torch.float32, device=x.device)
    fn = fn or _build.entry("conv_bn_stats_f32")
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), wt.data_ptr(),
             part[0].data_ptr(), part[1].data_ptr(), sums[0].data_ptr(),
             sums[1].data_ptr(), n, c, p, o, plan.tile,
             _build.stream(x.device))
    _build.check(err, "conv_bn_stats_f32")
    return y, sums[0], sums[1]


class ConvBnStats(torch.autograd.Function):
    """(y, sum_c, sumsq_c) of a convolution; B1 for a fusable geometry,
    the plain version otherwise. Backward: the convolution's input and
    weight gradients of g_y + g_s + 2 y g_ss."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        if fusable(x, w, stride, padding, dilation, groups):
            y, s, ss = conv_bn_stats_1x1(x, w)
        else:
            y, s, ss = conv_bn_stats_plain(x, w, stride, padding, dilation,
                                           groups)
        ctx.save_for_backward(x, w, y)
        ctx.geometry = (list(_pair(stride)), list(_pair(padding)),
                        list(_pair(dilation)), groups)
        return y, s, ss

    @staticmethod
    def backward(ctx, g_y, g_s, g_ss):
        x, w, y = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.geometry
        g = g_y.float() + _channel_view(g_s) \
            + 2.0 * y.float() * _channel_view(g_ss)
        g = g.to(y.dtype)
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, stride, padding, dilation, False, [0, 0], groups,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


def conv_bn_stats(x, w, stride=1, padding=0, dilation=1, groups=1):
    """``(y, sum_c, sumsq_c)`` of ``conv2d(x, w)`` with its gradient
    (reference ``conv_bn_stats``; geometry as ints or pairs)."""
    return ConvBnStats.apply(x, w, stride, padding, dilation, groups)


def conv2d_bn_stats(x, w, scale, bias, mean, variance, stride=1,
                    padding=0, dilation=1, groups=1, momentum=0.9,
                    epsilon=1e-5, is_test=False, reduce=None,
                    count_mult=1):
    """conv2d + batch_norm in one op (reference ``_conv2d_bn``) as a
    function: ``(y, mean_out, variance_out, saved_mean, saved_inv)``.

    Training: the batch mean and biased variance come from the fused
    sums (``E[y^2] - E[y]^2``, as the reference), the running statistics
    out are ``momentum * old + (1 - momentum) * batch``. ``is_test``: a
    plain convolution normalized by the running statistics, returned as
    they are. ``y * a + b`` with ``a = scale / sqrt(var + eps)`` and
    ``b = bias - mean * a``; ``saved_inv`` is ``1 / sqrt(var + eps)``.

    ``reduce`` (under a distribution strategy, ``parallel/spmd.py``)
    sums B1's per-channel sums over the data axis's ranks, each holding
    ``1 / count_mult`` of the batch, before the finish: the statistics
    are the global batch's."""
    if is_test:
        y = conv2d(x, w, stride, padding, dilation, groups)
        use_mean, use_var = mean, variance
        new_mean, new_var = mean, variance
    else:
        y, csum, csq = conv_bn_stats(x, w, stride, padding, dilation, groups)
        count = y.shape[0] * y.shape[2] * y.shape[3]
        if reduce is not None:
            csum, csq, count = reduce(csum), reduce(csq), count * count_mult
        use_mean = csum / count
        use_var = csq / count - use_mean * use_mean
        new_mean = momentum * mean + (1.0 - momentum) * use_mean
        new_var = momentum * variance + (1.0 - momentum) * use_var
    inv = torch.rsqrt(use_var + epsilon)
    a = inv * scale
    b = bias - use_mean * a
    out = y * _channel_view(a).to(y.dtype) + _channel_view(b).to(y.dtype)
    return out, new_mean, new_var, use_mean, inv


def conv2d_bn(x, w, scale, bias, mean, variance, stride=1, padding=0,
              dilation=1, groups=1, momentum=0.9, epsilon=1e-5,
              is_test=False, update_stats=True):
    """:func:`conv2d_bn_stats` with the running statistics ``mean`` and
    ``variance`` updated IN PLACE, outside autograd, unless ``is_test``
    or not ``update_stats`` (a recomputed forward); returns y."""
    y, new_mean, new_var, _, _ = conv2d_bn_stats(
        x, w, scale, bias, mean, variance, stride, padding, dilation,
        groups, momentum, epsilon, is_test)
    if update_stats and not is_test:
        with torch.no_grad():
            mean.copy_(new_mean)
            variance.copy_(new_var)
    return y


@register_op("conv2d_bn")
def _conv2d_bn(ctx):
    """The reference's ``conv2d_bn`` op: batch_norm's slots and outputs
    plus the convolution's Input and Filter; B1 for a 1x1 stride-1 f32
    convolution on the card. The running statistics come out as new
    tensors, which the executor writes to the scope."""
    y, mean, var, saved_mean, inv = conv2d_bn_stats(
        ctx.input("Input"), ctx.input("Filter"), ctx.input("Scale"),
        ctx.input("Bias"), ctx.input("Mean"), ctx.input("Variance"),
        ctx.attr("strides", [1, 1]), ctx.attr("paddings", [0, 0]),
        ctx.attr("dilations", [1, 1]), int(ctx.attr("groups", 1) or 1),
        ctx.attr("momentum", 0.9), ctx.attr("epsilon", 1e-5),
        ctx.attr("is_test", False))
    return {"Y": y, "MeanOut": mean, "VarianceOut": var,
            "SavedMean": saved_mean, "SavedVariance": inv}


def conv1x1_bn_relu_plain(x, a, b, w):
    """The plain version of the probe T1 (reference ``xla_path``): x
    [R, C], a and b [C], w [C, O] of one dtype (bf16 in the probe) ->
    (y [R, O] of x's dtype, sum_c f32 [O], sumsq_c f32 [O]), with
    ``z = relu(x * a + b)`` in f32 rounded to x's dtype, the product
    accumulated in f32 and the sums taken of the f32 product."""
    z = torch.relu(x.float() * a.float() + b.float()).to(x.dtype)
    y = torch.matmul(z.float(), w.float())
    return y.to(x.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def _t1_plan(r, c, o, tile=T1_TILE):
    """T1's launch for x [r, c] and w [c, o] at ``tile`` (bm rows, bn
    columns; the build's own, or a probe's edited build's): the row tiles
    (the grid: a CTA each, one partial sum of each column apiece) and the
    column tiles each CTA walks."""
    bm, bn = tile
    return T1Plan(bm, bn, _cdiv(r, bm), _cdiv(o, bn))


def conv1x1_bn_relu(x, a, b, w):
    """The probe T1 on the tensor cores: x bf16 [R, C], a and b bf16
    [C], w bf16 [C, O] -> (y bf16 [R, O], sum_c f32 [O], sumsq_c f32
    [O]). Any R, C, O >= 1. Counts launches in
    ``conv1x1_bn_relu.launches``."""
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0]
             and a.shape == (x.shape[1],) and b.shape == (x.shape[1],),
             "x [R, C], a [C], b [C] and w [C, O] do not chain: %s %s %s %s",
             tuple(x.shape), tuple(a.shape), tuple(b.shape), tuple(w.shape))
    _require(all(t.dtype == torch.bfloat16 for t in (x, a, b, w)),
             "x, a, b and w must be bfloat16")
    if _on_cpu(x, a, b, w):
        return conv1x1_bn_relu_plain(x, a, b, w)
    r, c = x.shape
    o = w.shape[1]
    _require(r >= 1 and c >= 1 and o >= 1, "bad shape %s", (r, c, o))
    x, a, b, w = (t.contiguous() for t in (x, a, b, w))
    out = _launch_t1(x, a, b, w, _t1_plan(r, c, o))
    conv1x1_bn_relu.launches += 1
    return out


conv1x1_bn_relu.launches = 0


def _launch_t1(x, a, b, w, plan, part=None, fn=None):
    """One call of T1's C entry (the product, then the finish of the
    sums) on contiguous CUDA inputs by ``plan``, with the partial sums in
    ``part`` (f32 [2, row_tiles, O]; default: allocated here) through the
    ctypes entry ``fn`` (default: the build of the source as it is); not
    counted."""
    r, c = x.shape
    o = w.shape[1]
    _require(plan.row_tiles < 2 ** 31, "grid too large: %d CTAs",
             plan.row_tiles)
    y = torch.empty((r, o), dtype=torch.bfloat16, device=x.device)
    if part is None:
        part = torch.empty((2, plan.row_tiles, o), dtype=torch.float32,
                           device=x.device)
    sums = torch.empty((2, o), dtype=torch.float32, device=x.device)
    fn = fn or _build.entry("conv1x1_bn_relu_bf16")
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
             y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
             sums[0].data_ptr(), sums[1].data_ptr(), r, c, o,
             _build.stream(x.device))
    _build.check(err, "conv1x1_bn_relu_bf16")
    return y, sums[0], sums[1]
