"""Activation ops of the ResNet and LM programs (reference
``paddle_tpu/ops/activation_ops.py`` ``relu``, ``softmax`` and
``gelu``)."""

import torch

from ..core.registry import register_op
from .nn_ops import gelu


@register_op("relu")
def _relu(ctx):
    return {"Out": torch.relu(ctx.input("X"))}


@register_op("softmax")
def _softmax(ctx):
    return {"Out": torch.softmax(ctx.input("X"), dim=-1)}


@register_op("gelu")
def _gelu(ctx):
    """``jax.nn.gelu``'s default, the tanh approximation, as the
    ``nn.Module`` LM computes it (``nn_ops.gelu``, ``F.gelu(approximate=
    "tanh")``): within 2 ulp of XLA's float32 expression of the same
    formula (``tests/test_torch_program_lm.py``)."""
    return {"Out": gelu(ctx.input("X"))}
