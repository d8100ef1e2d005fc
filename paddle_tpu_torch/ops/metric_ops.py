"""Metric ops of the ResNet path (reference ``paddle_tpu/ops/
metric_ops.py`` ``accuracy`` after ``top_k``, as ``layers.accuracy``
chains them), and the program op ``accuracy``."""

import torch

from ..core.registry import register_op

__all__ = ["accuracy"]


def accuracy(input, label, k=1):
    """Top-k accuracy of predictions [N, D] against int labels with N
    entries: ``(accuracy f32, correct int32, total int32)``; a row hits
    when its label is among its k largest entries."""
    with torch.no_grad():
        idx = torch.topk(input, k, dim=-1).indices
        hit = (idx == label.reshape(-1, 1).to(idx.dtype)).any(dim=1)
        correct = hit.sum().to(torch.int32)
        total = torch.tensor(idx.shape[0], dtype=torch.int32,
                             device=input.device)
        return correct.float() / total.float(), correct, total


@register_op("accuracy")
def _accuracy(ctx):
    """Top-k indices [N, k] (from ``top_k``) against the labels: the hit
    ratio, and the hits and rows as int32."""
    idx = ctx.input("Indices")
    label = ctx.input("Label").reshape(-1, 1)
    hit = (idx == label.to(idx.dtype)).any(dim=1)
    total = torch.tensor(idx.shape[0], dtype=torch.int32, device=idx.device)
    correct = hit.sum().to(torch.int32)
    return {"Accuracy": correct.float() / total.float(),
            "Correct": correct, "Total": total}
