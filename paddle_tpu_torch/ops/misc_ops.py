"""Misc ops (reference ``paddle_tpu/ops/misc_ops.py``): ``print``,
``roi_pool``, and the legacy layer tail ``switch_order``,
``scale_shift``, ``resize``, ``kmax_seq_score`` and ``scale_sub_region``.

``print`` is the one op here that reads back to the host: it prints the
reference's text (``message: <array>``) at every run, where the
reference's ``jax.debug.print`` fires inside its compiled step. So a
program holding it is neither captured nor exported
(``control_flow_ops.host_read_reason``), and its reads count in
``control_flow_ops.HOST_READS["print"]``.

``roi_pool`` gives each pixel of a ROI the index of the bin it falls in
and takes the bins' maxima with one ``scatter_reduce`` (``amax``) over
the pixels, linear in the pixels where the reference's mask is
[C, H, W, ph, pw] a ROI; ``amax``'s gradient is split evenly among tied
maxima, as JAX's ``max``'s is.
"""

import torch

from ..core.registry import register_op
from .beam_search_ops import top_k_stable
from .control_flow_ops import HOST_READS


@register_op("print")
def _print(ctx):
    x = ctx.input("X")
    if x.device.type != "meta":
        HOST_READS["print"] += 1
        print("%s: %s" % (ctx.attr("message", "print"),
                          x.detach().cpu().numpy()), flush=True)
    return {"Out": x}


@register_op("roi_pool")
def _roi_pool(ctx):
    """ROI max pooling. X [N, C, H, W]; ROIs [R, 5] (batch index, x1, y1,
    x2, y2) in input scale, rounded half to even after ``spatial_scale``.
    Out [R, C, pooled_height, pooled_width], 0 for a bin with no pixel;
    Argmax zeros, as the reference's."""
    x = ctx.input("X")
    rois = ctx.input("ROIs").to(torch.float32)
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    _, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device

    def corner(i):
        return torch.round(rois[:, i] * scale).to(torch.int32)[:, None]
    x1, y1, x2, y2 = corner(1), corner(2), corner(3), corner(4)
    rh = (y2 - y1 + 1).clamp(min=1)
    rw = (x2 - x1 + 1).clamp(min=1)
    ys = torch.arange(h, dtype=torch.int32, device=dev)[None, :]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    ybin = torch.where((ys >= y1) & (ys <= y2),
                       torch.div((ys - y1) * ph, rh, rounding_mode="floor"),
                       -1)                                   # [R, H]
    xbin = torch.where((xs >= x1) & (xs <= x2),
                       torch.div((xs - x1) * pw, rw, rounding_mode="floor"),
                       -1)                                   # [R, W]
    inside = (ybin[:, :, None] >= 0) & (xbin[:, None, :] >= 0)
    # pixels outside the ROI go to a spare bin, dropped below
    bins = torch.where(inside, ybin[:, :, None] * pw + xbin[:, None, :],
                       ph * pw).reshape(r, 1, h * w).expand(r, c, h * w)
    img = x[rois[:, 0].to(torch.int64)].reshape(r, c, h * w)
    neg = torch.finfo(x.dtype).min
    pooled = torch.full((r, c, ph * pw + 1), neg, dtype=x.dtype,
                        device=dev).scatter_reduce(
        2, bins.to(torch.int64), img, "amax", include_self=False)
    pooled = pooled[:, :, :ph * pw].reshape(r, c, ph, pw)
    out = torch.where(pooled == neg, torch.zeros_like(pooled), pooled)
    return {"Out": out, "Argmax": torch.zeros(out.shape, dtype=torch.int32,
                                              device=dev)}


@register_op("switch_order")
def _switch_order(ctx):
    """NCHW <-> NHWC."""
    x = ctx.input("X")
    if ctx.attr("to_nhwc", True):
        return {"Out": x.permute(0, 2, 3, 1)}
    return {"Out": x.permute(0, 3, 1, 2)}


@register_op("scale_shift")
def _scale_shift(ctx):
    """y = w * x + b, with a trainable scalar w and b."""
    out = ctx.input("X") * ctx.input("Scale").reshape(())
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias").reshape(())
    return {"Out": out}


@register_op("resize")
def _resize(ctx):
    """Rows reshaped to a trailing ``size``."""
    return {"Out": ctx.input("X").reshape(-1, ctx.attr("size"))}


@register_op("kmax_seq_score")
def _kmax_seq_score(ctx):
    """The indices of each padded sequence's ``beam_size`` best scores
    [B, beam_size] int32, equal scores lowest index first; -1 past the
    sequence's length or its T. Padding never selects; a real -inf score
    still counts."""
    scores = ctx.input("X")
    k = ctx.attr("beam_size")
    if scores.dim() > 2:
        scores = scores.reshape(scores.shape[0], -1)
    b, t = scores.shape
    kk = min(k, t)
    dev = scores.device
    if ctx.has_input("Length"):
        length = ctx.input("Length").reshape(-1)
        mask = torch.arange(t, device=dev)[None, :] < length[:, None]
        scores = torch.where(mask, scores,
                             torch.full_like(scores, -float("inf")))
        n_valid = length.clamp(max=kk)
    else:
        n_valid = torch.full((b,), kk, device=dev)
    _, idx = top_k_stable(scores, kk)
    valid = torch.arange(kk, device=dev)[None, :] < n_valid[:, None]
    idx = torch.where(valid, idx, -1).to(torch.int32)
    if kk < k:
        idx = torch.cat([idx, torch.full((b, k - kk), -1, dtype=torch.int32,
                                         device=dev)], dim=1)
    return {"Out": idx}


@register_op("scale_sub_region")
def _scale_sub_region(ctx):
    """Each sample's sub-region of NCHW X scaled by ``value``; Indices
    [N, 6] (c1, c2, h1, h2, w1, w2), 1-based and inclusive."""
    x = ctx.input("X")
    ind = ctx.input("Indices").to(torch.int32)
    value = ctx.attr("value", 1.0)
    n, c, h, w = x.shape
    dev = x.device

    def inside(size, lo, hi, shape):
        i = torch.arange(size, device=dev).reshape(shape)
        return (i >= ind[:, lo].reshape(-1, 1, 1, 1) - 1) & \
            (i <= ind[:, hi].reshape(-1, 1, 1, 1) - 1)
    sel = inside(c, 0, 1, (1, c, 1, 1)) & inside(h, 2, 3, (1, 1, h, 1)) & \
        inside(w, 4, 5, (1, 1, 1, w))
    return {"Out": torch.where(sel, x * value, x)}
