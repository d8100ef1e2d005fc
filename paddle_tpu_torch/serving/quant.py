"""int8 weight compute: the port's copy of the reference's
``paddle_tpu/serving/quant.py`` live arming, for generation sessions and
for programs.

:func:`arm_quant_compute` quantizes weights in place: symmetric
per-output-channel int8 (``scale_c = max|w_c| / 127``), the int8 weight
replacing the float32 one and its f32 scales beside it. The products of
those weights then run int8 x int8 -> int32 through kernel B3
(``ops/quant_ops.py``), a convolution's through the integer convolution
``quant_ops.quant_conv2d``. Quantization runs in numpy, so int8 weights
and scales are bitwise the reference's. It takes one of two forms:

* ``arm_quant_compute(programs, scope, fallback_ops, pallas)``, the
  reference's: the weights come from the Program IR
  (:func:`select_compute_vars`), a var is armed only where every program
  that reads it selects it on the same axis, the scope's float32 tensor
  is replaced by the int8 one and ``<name>@quant.scale``, and each
  program is tagged (``program._quant_compute``, which the executor reads
  at each run). Idempotent: an int8 var whose scales are in the scope is
  tagged as it is.
* ``arm_quant_compute(model, shared)``, for a ``models.transformer.
  TransformerLM`` served by a session, which has no IR: the model names
  its mul weights (``models.transformer.lm_mul_weight_names``), and a
  test holds that list against the reference's selection. A speculative
  session's self-draft shares the target's tensors by reference name; it
  is armed in the same call as the target (the reference's one-scope
  rule: one scope, one selection), by binding the draft to the target's
  int8 tensors and scales, so no float32 copy of an armed weight
  survives in either model.

Artifacts carry int8 weights too (the reference's export half):
:func:`quantize_model_dir` rewrites an exported ``params.npz`` so the
quantizable weights are int8, with their scales in ``quant.json``
(byte-identical to the reference's); :func:`maybe_dequantize` rebuilds
float32 weights at load (the default), and :func:`install_quant_compute`
keeps the weights the compute path can serve int8 in the scope, their
scales beside them, no float32 copy made, and tags the program
(``io.load_inference_model(..., quant_compute=True)``, which
``ServingEngine`` passes under the ``serving_quant_compute`` flag).
Dequantization is one float32 multiply of the int8 value by its scale,
bitwise numpy's, on the tensor's own device.

The tag keeps the reference's ``pallas`` entry (False unless given: the
port has no ``quant_pallas`` flag), which routes nothing: a CUDA tensor
always takes B3, a CPU tensor the dense plain route.
"""

import json
import os
from collections.abc import Sequence

import numpy as np
import torch

from ..core.framework import Parameter, Program
from ..models.transformer import lm_mul_weight_names
from ..ops.quant_ops import SCALE_SUFFIX, scale_var_name

__all__ = ["QUANT_OPS", "DEFAULT_FALLBACK_OPS", "SCALE_SUFFIX",
           "QUANT_META_FILE", "scale_var_name", "quantize_array",
           "dequantize_array", "select_quant_vars", "select_compute_vars",
           "quantize_model_dir", "load_quant_meta", "maybe_dequantize",
           "install_quant_compute", "arm_quant_compute"]

QUANT_META_FILE = "quant.json"

# op type -> (weight input slot, per-output-channel axis of that weight)
QUANT_OPS = {
    "mul": ("Y", -1),
    "matmul": ("Y", -1),
    "conv2d": ("Filter", 0),
}

# parameters consumed by any of these stay high precision (the
# reference's list: sensitive reductions and normalizers)
DEFAULT_FALLBACK_OPS = frozenset({
    "softmax", "layer_norm", "batch_norm", "lookup_table",
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
})


def quantize_array(w, axis):
    """Symmetric per-channel int8: returns ``(q int8, scales f32)`` with
    ``scales.shape == (w.shape[axis],)`` and ``w ~= q * scales`` along
    ``axis`` (max abs error <= scale / 2 per element); an all-zero
    channel gets scale 1.0."""
    w = np.asarray(w, dtype=np.float32)
    axis = axis % w.ndim
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    # max|w| as max(max w, -min w): the same values without a full-size
    # |w| temporary
    amax = np.maximum(w.max(axis=reduce_axes), -w.min(axis=reduce_axes)) \
        if reduce_axes else np.abs(w)
    scales = (amax / 127.0).astype(np.float32)
    scales = np.where(scales == 0.0, np.float32(1.0), scales)
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    # the reference's divide, rint and clip, in place on one temporary
    q = np.divide(w, scales.reshape(shape))
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    return q.astype(np.int8), scales


def dequantize_array(q, scales, axis):
    """Inverse of :func:`quantize_array` (up to rounding): f32 array."""
    q = np.asarray(q)
    scales = np.asarray(scales, dtype=np.float32)
    axis = axis % q.ndim
    shape = [1] * q.ndim
    shape[axis] = q.shape[axis]
    return q.astype(np.float32) * scales.reshape(shape)


def select_quant_vars(program, fallback_ops=DEFAULT_FALLBACK_OPS):
    """{parameter name: per-output-channel axis} of every float32
    parameter of ``program`` with at least 2 axes that is consumed only
    through the weight slot of a QUANT_OPS op, on one axis, and by no op
    of ``fallback_ops`` (reference ``select_quant_vars``)."""
    block = program.global_block()
    consumers = {}
    for op in block.ops:
        for slot, names in op.inputs.items():
            for n in names:
                if isinstance(block.var_or_none(n), Parameter):
                    consumers.setdefault(n, []).append((op.type, slot))
    out = {}
    for name, uses in consumers.items():
        var = block.var(name)
        if str(var.dtype) != "float32" or var.shape is None \
                or len(var.shape) < 2:
            continue
        if any(op_type in fallback_ops for op_type, _ in uses):
            continue
        axes = set()
        for op_type, slot in uses:
            spec = QUANT_OPS.get(op_type)
            if spec is None or spec[0] != slot:
                break
            axes.add(spec[1] % len(var.shape))
        else:
            if len(axes) == 1:
                out[name] = axes.pop()
    return out


def select_compute_vars(program, fallback_ops=DEFAULT_FALLBACK_OPS):
    """The part of :func:`select_quant_vars` the int8 compute path can
    serve, its scaled axis out of every contraction (reference
    ``select_compute_vars``): 2-D weights of ``mul`` and ``matmul``,
    ``y_num_col_dims`` 1, no ``transpose_Y``, 4-D ``conv2d`` filters."""
    targets = select_quant_vars(program, fallback_ops=fallback_ops)
    block = program.global_block()
    bad = set()
    for op in block.ops:
        spec = QUANT_OPS.get(op.type)
        if spec is None:
            continue
        for n in op.inputs.get(spec[0], []):
            if n not in targets:
                continue
            nd = len(block.var(n).shape)
            if op.type in ("mul", "matmul") and nd != 2:
                bad.add(n)
            elif op.type == "mul" and \
                    op.attrs.get("y_num_col_dims", 1) != 1:
                bad.add(n)
            elif op.type == "matmul" and \
                    op.attrs.get("transpose_Y", False):
                bad.add(n)
            elif op.type == "conv2d" and nd != 4:
                bad.add(n)
    return {n: a for n, a in targets.items() if n not in bad}


def _tag_program(program, vars_, pallas):
    """Attach the tag the executor reads at each run; its ``key`` (order
    stable) keys the executor's plan, so arming again with the same vars
    reuses it."""
    vars_ = dict(vars_)
    program._quant_compute = {
        "vars": vars_,
        "pallas": bool(pallas),
        "key": (tuple(sorted(vars_.items())), bool(pallas)),
    }


def quantize_model_dir(dirname, program=None,
                       fallback_ops=DEFAULT_FALLBACK_OPS, dtype="int8"):
    """Rewrite an exported inference-model dir in place: quantizable
    params in ``params.npz`` become int8 and ``quant.json`` records the
    per-var scales (reference ``quantize_model_dir``). Returns the list
    of quantized var names."""
    if dtype not in ("int8", True):
        raise ValueError("unsupported quantize mode %r (only 'int8')"
                         % (dtype,))
    if program is None:
        from ..core.serialization import program_from_dict
        with open(os.path.join(dirname, "__model__")) as f:
            program = program_from_dict(json.load(f)["program"])
    targets = select_quant_vars(program, fallback_ops=fallback_ops)

    npz_path = os.path.join(dirname, "params.npz")
    meta_path = os.path.join(dirname, "params.meta.json")
    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}
    with open(meta_path) as f:
        meta = json.load(f)

    quantized = {}
    for key, name in meta.items():
        axis = targets.get(name)
        if axis is None or key not in arrays:
            continue
        q, scales = quantize_array(arrays[key], axis)
        arrays[key] = q
        quantized[name] = {"axis": int(axis),
                           "scales": [float(s) for s in scales]}
    np.savez(npz_path[:-len(".npz")], **arrays)
    with open(os.path.join(dirname, QUANT_META_FILE), "w") as f:
        json.dump({"version": 1, "dtype": "int8", "vars": quantized}, f)
    # post-hoc quantization of an already-manifested artifact refreshes
    # the digests (params.npz was rewritten in place); inside
    # save_inference_model the manifest lands after
    from .. import io as _io
    if os.path.exists(os.path.join(dirname, "manifest.json")):
        _io.write_artifact_manifest(dirname)
    return sorted(quantized)


def load_quant_meta(dirname):
    """The dir's quant.json dict, or None when not quantized."""
    path = os.path.join(dirname, QUANT_META_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _dequantize(q, scales, axis):
    """:func:`dequantize_array` of a scope value: a tensor stays on its
    device (one float32 multiply, bitwise numpy's), anything else goes
    through numpy."""
    if not isinstance(q, torch.Tensor):
        return dequantize_array(q, scales, axis)
    axis = axis % q.ndim
    shape = [1] * q.ndim
    shape[axis] = q.shape[axis]
    s = torch.from_numpy(np.asarray(scales, dtype=np.float32)).to(q.device)
    return q.to(torch.float32) * s.reshape(shape)


def maybe_dequantize(dirname, scope):
    """If ``dirname`` carries quant.json, replace each quantized var in
    ``scope`` with its dequantized float32 value (the transparent load
    path). Returns the list of dequantized names."""
    meta = load_quant_meta(dirname)
    if meta is None:
        return []
    done = []
    for name, info in meta["vars"].items():
        q = scope.find_var(name)
        if q is None:
            continue
        scope.set_var(name, _dequantize(q, info["scales"], info["axis"]))
        done.append(name)
    return done


def install_quant_compute(dirname, program, scope, pallas=None):
    """Artifact-load arming: keep the int8 weights that the compute path
    can serve AS int8 in ``scope`` (their scales become
    ``<name>@quant.scale`` vars on the weight's device — the float32 copy
    is never made), dequantize the rest exactly like the default load,
    and tag ``program``. ``pallas`` is kept in the tag and routes
    nothing (B3 on CUDA, the dense plain route on the CPU). Returns the
    list of compute-armed names."""
    meta = load_quant_meta(dirname)
    if meta is None:
        return []
    compute = select_compute_vars(program)
    armed = {}
    for name, info in meta["vars"].items():
        q = scope.find_var(name)
        if q is None:
            continue
        axis = compute.get(name)
        if axis is not None and int(info["axis"]) == axis:
            scales = np.asarray(info["scales"], dtype=np.float32)
            scope.set_var(scale_var_name(name), torch.from_numpy(
                scales).to(q.device) if isinstance(q, torch.Tensor)
                else scales)
            armed[name] = axis
        else:
            scope.set_var(name, _dequantize(q, info["scales"],
                                            info["axis"]))
    if armed:
        _tag_program(program, armed, pallas)
    return sorted(armed)


def _arm_programs(programs, scope, fallback_ops=DEFAULT_FALLBACK_OPS,
                  pallas=None):
    """The reference's ``arm_quant_compute(programs, scope)``; returns
    the sorted armed names. A scope tensor is quantized on the host and
    put back on its device."""
    programs = [p for p in programs if p is not None]
    if not programs:
        return []
    selections = [select_compute_vars(p, fallback_ops=fallback_ops)
                  for p in programs]
    referenced = [{n for op in p.global_block().ops
                   for names in op.inputs.values() for n in names}
                  for p in programs]
    candidates = {}
    for sel in selections:
        candidates.update(sel)
    armed = {}
    for name, axis in candidates.items():
        if any(name in refs and sel.get(name) != axis
               for refs, sel in zip(referenced, selections)):
            continue
        w = scope.find_var(name)
        if w is None:
            continue
        device = w.device if isinstance(w, torch.Tensor) else None
        if str(w.dtype) in ("int8", "torch.int8"):
            if scope.find_var(scale_var_name(name)) is None:
                continue    # a foreign int8 var without scales
        else:
            host = w.detach().cpu().numpy() if device is not None \
                else np.asarray(w)
            q, scales = quantize_array(host, axis)
            scope.set_var(name, torch.from_numpy(q).to(device) if device
                          is not None else q)
            scope.set_var(scale_var_name(name),
                          torch.from_numpy(scales).to(device) if device
                          is not None else scales)
        armed[name] = axis
    for p, sel in zip(programs, selections):
        tag = {n: a for n, a in sel.items() if n in armed}
        if tag:
            _tag_program(p, tag, pallas)
    return sorted(armed)


def arm_quant_compute(target, *args, **kwargs):
    """Arm for int8 compute, by the first argument's kind: a sequence of
    Programs (None entries skipped) takes ``(programs, scope,
    fallback_ops=DEFAULT_FALLBACK_OPS, pallas=None)``, the reference's
    live arming of a scope; anything else is a ``TransformerLM`` and
    takes ``(model, shared=())``. Both return the sorted armed names."""
    if isinstance(target, Sequence) and not isinstance(target, str) and \
            all(p is None or isinstance(p, Program) for p in target):
        return _arm_programs(target, *args, **kwargs)
    return _arm_model(target, *args, **kwargs)


def _arm_model(model, shared=()):
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
