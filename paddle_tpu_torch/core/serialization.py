"""Program <-> JSON dict: portable, versioned, data-only serialization
(reference ``paddle_tpu/core/serialization.py``: the same JSON, so a
program serialized by either package loads in the other and serializes
again byte for byte).

Reference analog: ``framework.proto:33-146`` — ProgramDesc as a versioned
schema that inference engines load without running code. We serialize the
IR as JSON instead of protobuf: the IR is small (op type + name lists +
attrs) and JSON keeps the ``__model__`` export human-readable and safe to
load from untrusted sources (no code execution on load, unlike pickle).

Attr values beyond JSON primitives are tagged:
* tuples          -> {"__tuple__": [...]}
* dtypes          -> {"__dtype__": "float32"}
* numpy arrays    -> {"__ndarray__": {"dtype", "shape", "data"}}
* Operator refs   -> {"__op_ref__": [block_idx, op_idx]}  (vjp_grad.fwd_op)
* nested dicts    -> {"__map__": {...}}
"""

import numpy as np

from .framework import (BFLOAT16, Program, Block, Variable, Parameter,
                        Operator, dtype_name)

FORMAT_VERSION = 1

__all__ = ["program_to_dict", "program_from_dict", "FORMAT_VERSION"]


def _encode_attr(value, op_index, top_level=True):
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, tuple):
        return {"__tuple__": [_encode_attr(v, op_index, False)
                              for v in value]}
    if isinstance(value, list):
        return [_encode_attr(v, op_index, False) for v in value]
    if isinstance(value, np.dtype) or value is BFLOAT16:
        return {"__dtype__": dtype_name(value)}
    if isinstance(value, np.ndarray):
        return {"__ndarray__": {"dtype": value.dtype.name,
                                "shape": list(value.shape),
                                "data": value.ravel().tolist()}}
    if isinstance(value, Operator):
        # The patch pass rewrites op.attrs[key]; a ref buried inside a
        # tuple/list/map could not be patched in place, so refuse rather
        # than silently corrupt on load.
        if not top_level:
            raise TypeError("Operator references are only supported as "
                            "top-level attr values")
        ref = op_index.get(id(value))
        if ref is None:
            raise ValueError("attr references an Operator outside the "
                             "program being serialized")
        return {"__op_ref__": list(ref)}
    if isinstance(value, dict):
        return {"__map__": {k: _encode_attr(v, op_index, False)
                            for k, v in value.items()}}
    raise TypeError("cannot serialize op attr of type %r (value %r) — "
                    "attrs must be data, not live objects"
                    % (type(value).__name__, value))


def _decode_attr(value, pending_refs, holder, top_level=True):
    if isinstance(value, dict):
        if "__tuple__" in value:
            return tuple(_decode_attr(v, pending_refs, holder, False)
                         for v in value["__tuple__"])
        if "__dtype__" in value:
            name = value["__dtype__"]
            return BFLOAT16 if name == "bfloat16" else np.dtype(name)
        if "__ndarray__" in value:
            d = value["__ndarray__"]
            return np.array(d["data"], dtype=d["dtype"]).reshape(d["shape"])
        if "__op_ref__" in value:
            if not top_level:
                raise ValueError("nested Operator reference in attr — "
                                 "unsupported format")
            pending_refs.append((holder, tuple(value["__op_ref__"])))
            return None  # patched in the second pass
        if "__map__" in value:
            return {k: _decode_attr(v, pending_refs, holder, False)
                    for k, v in value["__map__"].items()}
        raise ValueError("unrecognized tagged attr: %r" % (value,))
    if isinstance(value, list):
        return [_decode_attr(v, pending_refs, holder, False)
                for v in value]
    return value


def _encode_var(v):
    return {
        "class": "Parameter" if isinstance(v, Parameter) else "Variable",
        "name": v.name,
        "shape": list(v.shape) if v.shape is not None else None,
        "dtype": dtype_name(v.dtype),
        "persistable": bool(v.persistable),
        "stop_gradient": bool(v.stop_gradient),
        "trainable": bool(v.trainable),
        "is_data": bool(getattr(v, "is_data", False)),
    }


def program_to_dict(program):
    op_index = {}
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            op_index[id(op)] = (b.idx, i)
    blocks = []
    for b in program.blocks:
        blocks.append({
            "idx": b.idx,
            "parent_idx": b.parent_idx,
            "vars": [_encode_var(v) for v in b.vars.values()],
            "ops": [{
                "type": op.type,
                "inputs": {k: list(v) for k, v in op.inputs.items()},
                "outputs": {k: list(v) for k, v in op.outputs.items()},
                "attrs": {k: _encode_attr(v, op_index)
                          for k, v in op.attrs.items()},
            } for op in b.ops],
        })
    return {"format_version": FORMAT_VERSION,
            "random_seed": program.random_seed,
            "blocks": blocks}


def program_from_dict(data):
    version = data.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError("unsupported program format version %r (this "
                         "build reads version %d)" % (version,
                                                      FORMAT_VERSION))
    program = Program()
    program.random_seed = data.get("random_seed")
    # Materialize all blocks first (ops may reference sub-blocks by idx).
    for bd in data["blocks"]:
        if bd["idx"] == 0:
            continue
        block = Block(program, bd["idx"], bd["parent_idx"])
        assert len(program.blocks) == bd["idx"], "non-contiguous block idx"
        program.blocks.append(block)
    pending_refs = []
    for bd in data["blocks"]:
        block = program.blocks[bd["idx"]]
        for vd in bd["vars"]:
            cls = Parameter if vd["class"] == "Parameter" else Variable
            kwargs = dict(name=vd["name"], shape=vd["shape"],
                          dtype=vd["dtype"], trainable=vd["trainable"])
            if cls is Variable:
                kwargs.update(persistable=vd["persistable"])
            var = cls(block, **kwargs)
            # Parameter.__init__ doesn't take these; set for both classes
            # so e.g. a frozen parameter stays frozen after a round-trip.
            var.stop_gradient = vd["stop_gradient"]
            var.persistable = vd["persistable"]
            var.is_data = vd["is_data"]
            block.vars[var.name] = var
        for od in bd["ops"]:
            op = Operator(block, od["type"], od["inputs"], od["outputs"])
            op.attrs = {k: _decode_attr(v, pending_refs, (op, k))
                        for k, v in od["attrs"].items()}
            block.ops.append(op)
            for ns in op.outputs.values():
                for n in ns:
                    v = block.var_or_none(n)
                    if v is not None and v.op is None:
                        v.op = op
    # Second pass: resolve Operator references now that all ops exist.
    for (op, attr_key), (b_idx, o_idx) in pending_refs:
        op.attrs[attr_key] = program.blocks[b_idx].ops[o_idx]
    program._bump_version()
    return program
