"""Loss ops of the ResNet path (reference ``paddle_tpu/ops/loss_ops.py``
``softmax_with_cross_entropy`` and ``math_ops.py`` ``mean``)."""

import torch

from ..amp import amp_cast

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
