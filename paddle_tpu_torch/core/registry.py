"""Op registry and execution context (reference
``paddle_tpu/core/registry.py``).

An op is ONE torch function (``compute``) of an :class:`ExecContext`.
The same function is the op's runtime kernel (the Executor calls it on
the step's tensors) and its build-time shape inference (it runs on
``meta`` tensors, which carry shapes and dtypes and no data, where the
reference runs ``jax.eval_shape``). Gradients need no per-op code: the
backward appends generic ``vjp_grad`` ops that the Executor answers with
autograd through the forward op's own compute (``executor.py``).

The op modules register their ops when imported; :func:`get_op_def`
imports them on first use, so building or running a program needs no
import of them by the caller.
"""

import importlib

import torch

from .framework import convert_dtype, torch_dtype

__all__ = ["OpDef", "register_op", "get_op_def", "registered_ops", "PENDING",
           "ExecContext", "flat_input_slots", "flat_output_slots",
           "normalize_outputs", "infer_shape"]

# Build-time stand-in for unknown (-1) dimensions during shape inference.
_DIM_PLACEHOLDER = 8191

# the modules whose import registers the port's ops
OP_MODULES = ("activation_ops", "attention_ops", "beam_search_ops",
              "conv_bn", "control_flow_ops", "crf_ctc_ops", "decoding_ops",
              "detection_ops", "generation_ops", "legacy_tail_ops",
              "loss_ops", "math_ops", "metric_ops", "misc_ops", "nested_ops",
              "nn_ops", "optimizer_ops", "random_ops", "seq2seq_ops",
              "sequence_ops", "sparse_ops", "tensor_ops")
# the modules outside ``ops/`` whose import registers ops: the distributed
# lookup and its gradient
OTHER_OP_MODULES = ("paddle_tpu_torch.embeddings.sharded",)

_registry = {}
_loaded = []

# The reference's op types the port does not register yet, each mapped to
# the citation of the ROADMAP Queue A item that brings it (by its title),
# which a program holding one fails with at build or run time. Nothing is
# pending: the port registers all 219 of the reference's op types.
PENDING = {}


class OpDef:
    def __init__(self, type, compute, infer_shape=None, needs_rng=False,
                 skip_eval_shape=False):
        self.type = type
        self.compute = compute
        # an op's own shape function ``(op, block)``, where its compute
        # cannot relate its output shapes to its inputs' (a sub-block's)
        self.custom_infer_shape = infer_shape
        self.needs_rng = needs_rng
        # Ops whose compute cannot run abstractly (their shapes come from
        # attrs, or from a sub-block).
        self.skip_eval_shape = skip_eval_shape


def register_op(type, compute=None, **kwargs):
    """Register an op. Usable as a decorator:  @register_op("relu")"""
    def deco(fn):
        if type in _registry:
            raise ValueError("op %r already registered" % type)
        _registry[type] = OpDef(type, fn, **kwargs)
        return fn
    if compute is not None:
        return deco(compute)
    return deco


def _load_ops():
    if not _loaded:
        for mod in OP_MODULES:
            importlib.import_module("paddle_tpu_torch.ops." + mod)
        for mod in OTHER_OP_MODULES:
            importlib.import_module(mod)
        _loaded.append(True)


def get_op_def(type):
    _load_ops()
    try:
        return _registry[type]
    except KeyError:
        if type in PENDING:
            raise NotImplementedError(
                "op type %r is not ported yet: %s" % (type, PENDING[type])) \
                from None
        raise NotImplementedError("no op registered for type %r" % type)


def registered_ops():
    _load_ops()
    return sorted(_registry)


class ExecContext:
    """What an op's compute sees: bound input tensors + attrs (+ rng key).

    ``trace`` is the executor's per-run state (None under shape
    inference): its ``amp`` dtype, and ``inplace``, which lets an update
    op write its output into the input tensor the output names (the
    reference's donated buffers).
    """

    __slots__ = ("op", "_values", "rng_key", "block", "trace")

    def __init__(self, op, values, rng_key=None, block=None, trace=None):
        self.op = op
        self._values = values  # slot -> list of values (None for missing)
        self.rng_key = rng_key
        self.block = block
        self.trace = trace

    def input(self, slot, default=None):
        vals = self._values.get(slot)
        if not vals:
            return default
        return vals[0]

    def inputs(self, slot):
        return self._values.get(slot) or []

    def has_input(self, slot):
        vals = self._values.get(slot)
        return bool(vals) and vals[0] is not None

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def output_names(self, slot):
        return self.op.outputs.get(slot, [])

    def in_place(self, out_slot, in_slot):
        """True when this run may write ``out_slot`` into the tensor of
        ``in_slot``: the executor allows it and both name one variable."""
        return bool(getattr(self.trace, "inplace", False)) and \
            self.op.outputs.get(out_slot) == self.op.inputs.get(in_slot)


def flat_input_slots(op):
    """Deterministic (slot, index) ordering of an op's inputs (for vjp)."""
    out = []
    for slot in sorted(op.inputs):
        for i in range(len(op.inputs[slot])):
            out.append((slot, i))
    return out


def flat_output_slots(op):
    out = []
    for slot in sorted(op.outputs):
        for i in range(len(op.outputs[slot])):
            out.append((slot, i))
    return out


def normalize_outputs(op, result):
    """compute() returns {slot: value-or-list}; normalize to {slot: list}."""
    norm = {}
    for slot, val in result.items():
        if isinstance(val, (list, tuple)):
            norm[slot] = list(val)
        else:
            norm[slot] = [val]
    return norm


def infer_shape(op, block):
    """Set output var shapes/dtypes by running compute() on meta tensors."""
    opdef = get_op_def(op.type)
    if opdef.custom_infer_shape is not None:
        opdef.custom_infer_shape(op, block)
        return
    if opdef.skip_eval_shape:
        return

    values = {}
    for slot, names in op.inputs.items():
        vals = []
        for name in names:
            var = block.var_or_none(name)
            if var is None or var.shape is None:
                return  # cannot infer
            shape = tuple(_DIM_PLACEHOLDER if d in (-1, None) else d
                          for d in var.shape)
            vals.append(torch.empty(shape, dtype=torch_dtype(var.dtype),
                                    device="meta"))
        values[slot] = vals

    rng = torch.zeros(2, dtype=torch.int64, device="meta") \
        if opdef.needs_rng else None
    try:
        with torch.no_grad():
            result = normalize_outputs(op, opdef.compute(ExecContext(
                op, values, rng_key=rng, block=block)))
    except Exception as e:  # surface op name for debuggability
        raise type(e)("shape inference failed for op %r: %s" % (op.type, e)) \
            from e

    for slot, names in op.outputs.items():
        for name, val in zip(names, result.get(slot, [])):
            var = block.var_or_none(name)
            if var is None or not isinstance(val, torch.Tensor):
                continue
            var.shape = tuple(-1 if d == _DIM_PLACEHOLDER else d
                              for d in val.shape)
            var.dtype = convert_dtype(val.dtype)
