"""The sequence op the LM's ``length`` form needs (reference
``paddle_tpu/ops/sequence_ops.py`` ``sequence_mask``). The reference's
other sequence ops are not ported yet (ROADMAP Queue A, "RNN and seq2seq
configs")."""

import torch

from ..core.framework import torch_dtype
from ..core.registry import register_op


@register_op("sequence_mask")
def _sequence_mask(ctx):
    """[B, maxlen] mask of ``dtype``: 1 where the column is below the
    row's length (``Length`` flattened to [B])."""
    length = ctx.input("Length").reshape(-1)
    maxlen = ctx.attr("maxlen")
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    cols = torch.arange(maxlen, device=length.device)
    return {"Out": (cols[None, :] < length[:, None]).to(dtype)}
