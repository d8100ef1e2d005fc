"""int8 weight compute for serving: the port's copy of what a
generation session needs from the reference's ``paddle_tpu/serving/
quant.py``.

:func:`arm_quant_compute` quantizes a model's weights in place, the
live-session arming of the reference: symmetric per-output-channel int8
(``scale_c = max|w_c| / 127``) on axis 1 of each [in, out] weight the
model consumes only through ``mul``, the int8 weight replacing the
float32 one and its f32 scales beside it. The products of those weights
then run int8 x int8 -> int32 through kernel B3 (``ops/quant_ops.py``).

The reference selects the weights from its Program IR
(``select_compute_vars``); the port has none, so the selection is
structural: the model names its mul weights
(``models.transformer.lm_mul_weight_names``), and a test holds that
list against the reference's selection. Quantization runs in numpy, so
int8 weights and scales are bitwise the reference's.

A speculative session's self-draft shares the target's tensors by
reference name; it is armed in the same call as the target (the
reference's one-scope rule: one scope, one selection), by binding the
draft to the target's int8 tensors and scales, so no float32 copy of an
armed weight survives in either model.

Not ported yet: artifact-load arming (``install_quant_compute``,
``quant.json``, ``quantize_model_dir``).
"""

import numpy as np
import torch

from ..models.transformer import lm_mul_weight_names
from ..ops.quant_ops import SCALE_SUFFIX, scale_var_name

__all__ = ["QUANT_OPS", "SCALE_SUFFIX", "scale_var_name", "quantize_array",
           "dequantize_array", "arm_quant_compute"]

# op type -> (weight input slot, per-output-channel axis of that weight):
# the reference's table, cut to the one op the port's models arm
QUANT_OPS = {"mul": ("Y", -1)}


def quantize_array(w, axis):
    """Symmetric per-channel int8: returns ``(q int8, scales f32)`` with
    ``scales.shape == (w.shape[axis],)`` and ``w ~= q * scales`` along
    ``axis`` (max abs error <= scale / 2 per element); an all-zero
    channel gets scale 1.0."""
    w = np.asarray(w, dtype=np.float32)
    axis = axis % w.ndim
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=reduce_axes) if reduce_axes \
        else np.abs(w)
    scales = (amax / 127.0).astype(np.float32)
    scales = np.where(scales == 0.0, np.float32(1.0), scales)
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    q = np.clip(np.rint(w / scales.reshape(shape)), -127, 127) \
        .astype(np.int8)
    return q, scales


def dequantize_array(q, scales, axis):
    """Inverse of :func:`quantize_array` (up to rounding): f32 array."""
    q = np.asarray(q)
    scales = np.asarray(scales, dtype=np.float32)
    axis = axis % q.ndim
    shape = [1] * q.ndim
    shape[axis] = q.shape[axis]
    return q.astype(np.float32) * scales.reshape(shape)


def arm_quant_compute(model, shared=()):
    """Quantize ``model``'s mul weights in place (a
    ``models.transformer.TransformerLM``) and return their sorted
    reference names, the reference session's ``_quant_armed``.
    Idempotent: a weight that is already int8 (it came armed, and the
    model takes int8 weights only with their scales) is kept as it
    is. Each model of ``shared`` (one whose tensors are ``model``'s by
    reference name, the self-draft) is bound to the armed tensors in the
    same call."""
    axis = QUANT_OPS["mul"][1]
    names = lm_mul_weight_names(model.num_layers)
    for name in names:
        w, _ = model.mul_weight(name)
        if w.dtype != torch.int8:
            q, s = quantize_array(w.detach().cpu().numpy(), axis)
            model.set_int8_weight(name, torch.from_numpy(q),
                                  torch.from_numpy(s))
    for other in shared:
        other.bind_params(model.reference_state(), model.device)
    return names
