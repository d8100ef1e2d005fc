"""Loss ops (reference ``paddle_tpu/ops/loss_ops.py`` and
``math_ops.py`` ``mean``): the softmax and plain cross entropies, the
sigmoid, square, hinge, Huber, log, margin-rank, modified-Huber, rank
and smooth-L1 losses, and the sampled ones, ``nce`` (its negatives drawn
with the reference's ``randint`` from the op's key) and ``hsigmoid``
(the complete binary tree's codes). Constants follow
``activation_ops.py``."""

import math

import torch

from ..amp import amp_cast
from ..core.registry import register_op
from .activation_ops import _t, abs_, clip
from .random_ops import randint

__all__ = ["softmax_with_cross_entropy", "mean"]


def softmax_with_cross_entropy(logits, label, amp=None):
    """Per-row cross entropy of ``softmax(logits)`` over the last axis:
    logits [N, D] -> loss [N, 1], for hard labels: ints of any width and
    shape with N entries, cast here (the reference's feed carries them
    as int32). Returns ``(loss, softmax)``, the reference's Loss and
    Softmax. Under amp (``amp`` a dtype) it is a BLACK op: bfloat16
    logits are cast to float32 first."""
    logits = amp_cast("softmax_with_cross_entropy", logits, amp)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, 1, label.reshape(-1, 1).to(torch.int64))
    return loss, torch.exp(logp)


def mean(x):
    """Mean of every element, as a 0-d tensor."""
    return x.mean()


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx):
    """Hard labels as :func:`softmax_with_cross_entropy`; with
    ``soft_label`` the label rows are distributions: ``-sum(label *
    log_softmax)`` over the last axis."""
    if ctx.attr("soft_label", False):
        logp = torch.log_softmax(ctx.input("Logits"), dim=-1)
        loss = -torch.sum(ctx.input("Label") * logp, dim=-1, keepdim=True)
        return {"Softmax": torch.exp(logp), "Loss": loss}
    loss, softmax = softmax_with_cross_entropy(ctx.input("Logits"),
                                               ctx.input("Label"))
    return {"Softmax": softmax, "Loss": loss}


@register_op("mean")
def _mean(ctx):
    return {"Out": mean(ctx.input("X"))}


def _log1p_exp_neg_abs(x):
    """``log1p(exp(-|x|))``, the stable tail of a sigmoid cross
    entropy."""
    return torch.log1p(torch.exp(-abs_(x)))


def _sigmoid_xent(x, label):
    """``max(x, 0) - x * label + log1p(exp(-|x|))``."""
    return torch.maximum(x, _t(0.0, x)) - x * label + _log1p_exp_neg_abs(x)


@register_op("cross_entropy")
def _cross_entropy(ctx):
    """Cross entropy of probabilities X [N, D]: against an integer label
    [N, 1] ``-log(max(x[label], 1e-20))``; with ``soft_label`` or a float
    label ``-sum(label * log(max(x, 1e-20)))`` over the row."""
    x, label = ctx.input("X"), ctx.input("Label")
    if ctx.attr("soft_label", False) or label.is_floating_point():
        loss = -torch.sum(label * torch.log(clip(x, 1e-20)), dim=1,
                          keepdim=True)
    else:
        picked = torch.gather(x, 1, label.reshape(-1, 1).to(torch.int64))
        loss = -torch.log(clip(picked, 1e-20))
    return {"Y": loss}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_cross_entropy_with_logits(ctx):
    return {"Out": _sigmoid_xent(ctx.input("X"), ctx.input("Label"))}


@register_op("square_error_cost")
def _square_error_cost(ctx):
    d = ctx.input("X") - ctx.input("Y")
    return {"Out": d * d}


@register_op("hinge_loss")
def _hinge_loss(ctx):
    logits, label = ctx.input("Logits"), ctx.input("Labels")
    return {"Loss": torch.maximum(_t(0.0, logits),
                                  1.0 - (2.0 * label - 1.0) * logits)}


@register_op("huber_loss")
def _huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    delta = ctx.attr("delta", 1.0)
    r = y - x
    a = abs_(r)
    loss = torch.where(a <= delta, 0.5 * (r * r), delta * (a - 0.5 * delta))
    return {"Out": loss, "Residual": r}


@register_op("log_loss")
def _log_loss(ctx):
    p, label = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps) -
            (1.0 - label) * torch.log(1.0 - p + eps)}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx):
    x1, x2, label = ctx.input("X1"), ctx.input("X2"), ctx.input("Label")
    out = torch.maximum(_t(0.0, x1),
                        -label * (x1 - x2) + ctx.attr("margin", 0.0))
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    z = (2.0 * y - 1.0) * x
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z) * (1.0 - z),
                                   _t(0.0, z)))
    return {"Out": loss, "IntermediateVal": z}


@register_op("rank_loss")
def _rank_loss(ctx):
    left, right = ctx.input("Left"), ctx.input("Right")
    d = left - right
    return {"Out": torch.log1p(torch.exp(d)) - ctx.input("Label") * d}


@register_op("smooth_l1_loss")
def _smooth_l1_loss(ctx):
    """Per-row sum of the smooth L1 of ``(x - y) * inside_weight`` (0.5
    sigma^2 d^2 below 1 / sigma^2, else |d| - 0.5 / sigma^2), times
    ``outside_weight``; and the weighted difference."""
    x, y = ctx.input("X"), ctx.input("Y")
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    diff = x - y
    if ctx.has_input("InsideWeight"):
        diff = diff * ctx.input("InsideWeight")
    a = abs_(diff)
    val = torch.where(a < 1.0 / s2, 0.5 * s2 * (diff * diff), a - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        val = val * ctx.input("OutsideWeight")
    return {"Out": torch.sum(val.reshape(val.shape[0], -1), dim=1,
                             keepdim=True), "Diff": diff}


@register_op("nce", needs_rng=True)
def _nce(ctx):
    """Noise-contrastive estimation: ``num_neg_samples`` uniform negative
    classes a row, drawn by ``randint`` from the op's key (the
    reference's samples, bit for bit), scored against the true ones with
    the noise correction ``log(k / num_classes)``; the per-row cost, the
    sampled logits and the sampled ids (true first)."""
    x, label, w = ctx.input("Input"), ctx.input("Label"), ctx.input("Weight")
    num_neg = ctx.attr("num_neg_samples", 10)
    num_classes = ctx.attr("num_total_classes", w.shape[0])
    batch = x.shape[0]
    label = label.reshape(batch, -1).to(torch.int32)
    num_true = label.shape[1]
    if x.device.type == "meta":
        samples = torch.empty((batch, num_neg), dtype=torch.int32,
                              device="meta")
    else:
        samples = randint(ctx.rng_key, (batch, num_neg), 0, num_classes)
    all_ids = torch.cat([label, samples], dim=1)
    ids = all_ids.to(torch.int64)
    logits = torch.einsum("bd,btd->bt", x, w[ids])
    if ctx.has_input("Bias"):
        logits = logits + ctx.input("Bias").reshape(-1)[ids]
    # jnp.log of the float32 constant, correctly rounded
    shift = float(torch.tensor(math.log(float(torch.tensor(
        num_neg * (1.0 / num_classes), dtype=torch.float32))),
        dtype=torch.float32))
    corrected = logits - shift
    labels = torch.cat([torch.ones((batch, num_true), dtype=x.dtype,
                                   device=x.device),
                        torch.zeros((batch, num_neg), dtype=x.dtype,
                                    device=x.device)], dim=1)
    loss = _sigmoid_xent(corrected, labels)
    return {"Cost": torch.sum(loss, dim=1, keepdim=True),
            "SampleLogits": logits, "SampleLabels": all_ids}


@register_op("hsigmoid")
def _hsigmoid(ctx):
    """Hierarchical sigmoid over a complete binary tree: label l has the
    code c = l + num_classes; its path node j is ``(c >> (j + 1)) - 1``
    with bit ``(c >> j) & 1``, nodes below 0 masked out; the loss sums
    the sigmoid cross entropies along the path."""
    x, w, label = ctx.input("X"), ctx.input("W"), ctx.input("Label")
    num_classes = ctx.attr("num_classes")
    max_len = int(2 * num_classes - 1).bit_length() - 1
    c = label.reshape(-1).to(torch.int32) + num_classes
    js = torch.arange(max_len, dtype=torch.int32, device=x.device)
    idx = (c[:, None] >> (js[None, :] + 1)) - 1
    bit = ((c[:, None] >> js[None, :]) & 1).to(x.dtype)
    valid = (idx >= 0).to(x.dtype)
    idx = torch.clamp(idx, min=0).to(torch.int64)
    logits = torch.einsum("nd,nld->nl", x, w[idx])
    if ctx.has_input("Bias"):
        logits = logits + ctx.input("Bias").reshape(-1)[idx]
    return {"Out": torch.sum(_sigmoid_xent(logits, bit) * valid, dim=1,
                             keepdim=True)}
