"""Activation ops of the ResNet program (reference ``paddle_tpu/ops/
activation_ops.py`` ``relu`` and ``softmax``)."""

import torch

from ..core.registry import register_op


@register_op("relu")
def _relu(ctx):
    return {"Out": torch.relu(ctx.input("X"))}


@register_op("softmax")
def _softmax(ctx):
    return {"Out": torch.softmax(ctx.input("X"), dim=-1)}
