"""Mixed precision (config flag ``amp``): the reference's op lists and cast
rule, copied from ``paddle_tpu/core/executor.py`` (``AMP_WHITE``,
``AMP_BLACK``, ``_amp_cast``). ``torch.autocast`` is not used: its op
lists are not these.

WHITE ops are the matrix-unit flop sinks: their float32 inputs are cast
to the amp dtype. BLACK ops are numerically sensitive reductions: their
float inputs are forced to float32. Every other op runs in whichever
dtype flows in. The cast is an ordinary tensor op inside autograd, so the
gradient of a float32 parameter comes back float32 through it: float32
master weights, as the reference's cast inside ``jax.vjp`` gives."""

import torch

from . import config as _config

__all__ = ["AMP_WHITE", "AMP_BLACK", "amp_cast", "amp_dtype", "flag_dtype"]

AMP_WHITE = frozenset({
    "conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
    "mul", "matmul", "bilinear_tensor_product",
    # fused recurrent scans: per-step gate matmuls dominate; the scan
    # carries stay bf16 end-to-end (cast once at the boundary)
    "dynamic_lstm", "dynamic_gru", "attention_gru_decoder",
    "sequence_conv",
})
AMP_BLACK = frozenset({
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost",
    "huber_loss", "nce", "cos_sim", "squared_l2_distance",
})


def amp_dtype(flag):
    """The torch dtype of an ``amp`` flag value (None or a dtype name such
    as "bfloat16"); None stays None."""
    if flag is None:
        return None
    dt = getattr(torch, str(flag), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError("amp must be None or a floating dtype name, got %r"
                         % (flag,))
    return dt


def flag_dtype():
    """The dtype of the ``amp`` flag as it is now (None when it is off).
    Models call it at each forward and loss, as the reference's
    ``Executor.run`` reads the flag at each run."""
    return amp_dtype(_config.get_flag("amp"))


def amp_cast(op_type, val, amp):
    """The reference's ``_amp_cast``: a float32 input of a WHITE op to
    ``amp``, a non-float32 float input of a BLACK op to float32, anything
    else unchanged. ``amp`` None (amp off) changes nothing."""
    if amp is None or not isinstance(val, torch.Tensor) \
            or not val.is_floating_point():
        return val
    if op_type in AMP_WHITE and val.dtype == torch.float32:
        return val.to(amp)
    if op_type in AMP_BLACK and val.dtype != torch.float32:
        return val.float()
    return val
