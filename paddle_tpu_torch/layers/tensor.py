"""Tensor layers of the program front end (reference
``paddle_tpu/layers/tensor.py``): ``fill_constant``, ``reshape``, and
for the cached generation programs ``transpose``, ``gather``,
``argmax``, ``slice``, ``decode_sample`` and ``decode_verify``."""

from ..layer_helper import LayerHelper
from ..core.framework import convert_dtype

__all__ = ["fill_constant", "reshape", "transpose", "gather", "argmax",
           "slice", "decode_sample", "decode_verify"]


def _unary(helper, op_type, x, attrs, dtype=None, slot_in="X"):
    out = helper.create_tmp_variable(dtype or x.dtype)
    helper.append_op(type=op_type, inputs={slot_in: [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def fill_constant(shape, dtype, value, out=None, **kwargs):
    helper = LayerHelper("fill_constant", **kwargs)
    if out is None:
        out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(type="fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)}, infer_shape=False)
    out.shape = tuple(shape)
    out.dtype = convert_dtype(dtype)
    return out


def reshape(x, shape, **kwargs):
    helper = LayerHelper("reshape", **kwargs)
    return _unary(helper, "reshape", x, {"shape": list(shape)})



def transpose(x, perm, **kwargs):
    helper = LayerHelper("transpose", **kwargs)
    return _unary(helper, "transpose", x, {"axis": list(perm)})


def gather(input, index, **kwargs):
    helper = LayerHelper("gather", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def argmax(x, axis=-1, **kwargs):
    helper = LayerHelper("arg_max", **kwargs)
    return _unary(helper, "arg_max", x, {"axis": axis}, dtype="int64")


def slice(input, axes, starts, ends, **kwargs):
    helper = LayerHelper("slice", **kwargs)
    return _unary(helper, "slice", input,
                  {"axes": list(axes), "starts": list(starts),
                   "ends": list(ends)}, slot_in="Input")


def decode_sample(logits, seed, step, mask=None, temperature=1.0,
                  top_k=0, top_p=1.0, **kwargs):
    """Counter-keyed sampling (``ops/decoding_ops.py``): one token per row
    of ``logits`` [N, V] under ``decoding_key(seed[i], step[i])``, an
    optional additive ``mask`` [N, V] added first. Returns [N] int64."""
    helper = LayerHelper("decode_sample", **kwargs)
    inputs = {"Logits": [logits.name], "Seed": [seed.name],
              "Step": [step.name]}
    if mask is not None:
        inputs["Mask"] = [mask.name]
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="decode_sample", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"temperature": float(temperature),
                            "top_k": int(top_k), "top_p": float(top_p)})
    return out


def decode_verify(logits, window, seed, hist, kind="greedy",
                  temperature=1.0, top_k=0, top_p=1.0, **kwargs):
    """The speculative accept step (``ops/decoding_ops.py``): the target
    policy's token at every window position and the accepted draft
    count. Returns (tokens [W] int64, accept [1] int32)."""
    helper = LayerHelper("decode_verify", **kwargs)
    toks = helper.create_tmp_variable("int64", stop_gradient=True)
    accept = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(
        type="decode_verify",
        inputs={"Logits": [logits.name], "Window": [window.name],
                "Seed": [seed.name], "Hist": [hist.name]},
        outputs={"Tokens": [toks.name], "Accept": [accept.name]},
        attrs={"kind": kind, "temperature": float(temperature),
               "top_k": int(top_k), "top_p": float(top_p)})
    return toks, accept
