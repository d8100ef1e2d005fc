"""Loss ops of the ResNet path (reference ``paddle_tpu/ops/loss_ops.py``
``softmax_with_cross_entropy`` and ``math_ops.py`` ``mean``), and their
program ops."""

import torch

from ..amp import amp_cast
from ..core.registry import register_op

__all__ = ["softmax_with_cross_entropy", "mean"]


def softmax_with_cross_entropy(logits, label, amp=None):
    """Per-row cross entropy of ``softmax(logits)`` over the last axis:
    logits [N, D] -> loss [N, 1], for hard labels: ints of any width and
    shape with N entries, cast here (the reference's feed carries them
    as int32). Returns ``(loss, softmax)``, the reference's Loss and
    Softmax. Under amp (``amp`` a dtype) it is a BLACK op: bfloat16
    logits are cast to float32 first. The reference's ``soft_label``
    form is not ported."""
    logits = amp_cast("softmax_with_cross_entropy", logits, amp)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, 1, label.reshape(-1, 1).to(torch.int64))
    return loss, torch.exp(logp)


def mean(x):
    """Mean of every element, as a 0-d tensor."""
    return x.mean()


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx):
    if ctx.attr("soft_label", False):
        raise NotImplementedError(
            "soft_label is not ported yet: ROADMAP Queue A, \"LeNet-5/MNIST "
            "slice\"")
    loss, softmax = softmax_with_cross_entropy(ctx.input("Logits"),
                                               ctx.input("Label"))
    return {"Softmax": softmax, "Loss": loss}


@register_op("mean")
def _mean(ctx):
    return {"Out": mean(ctx.input("X"))}
