"""Tensor layers of the program front end (reference
``paddle_tpu/layers/tensor.py``)."""

from ..layer_helper import LayerHelper
from ..core.framework import convert_dtype

__all__ = ["create_tensor", "cast", "concat", "sums", "assign",
           "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
           "reshape", "transpose", "flip", "split", "expand", "gather",
           "scatter", "pad", "crop", "sequence_reshape_noop", "argmax",
           "argmin", "decode_sample", "decode_verify", "stack", "slice",
           "shape", "increment", "multiplex", "array_write", "array_read",
           "create_array"]

def create_tensor(dtype, name=None, persistable=False, **kwargs):
    helper = LayerHelper("create_tensor", name=name, **kwargs)
    return helper.block.create_var(
        name=name or helper.name, dtype=convert_dtype(dtype),
        persistable=persistable)


def _unary(helper, op_type, x, attrs, dtype=None, slot_in="X"):
    out = helper.create_tmp_variable(dtype or x.dtype)
    helper.append_op(type=op_type, inputs={slot_in: [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def cast(x, dtype, **kwargs):
    helper = LayerHelper("cast", **kwargs)
    return _unary(helper, "cast", x, {"out_dtype": dtype},
                  dtype=convert_dtype(dtype))


def concat(input, axis=0, **kwargs):
    helper = LayerHelper("concat", **kwargs)
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="concat",
                     inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def sums(input, **kwargs):
    helper = LayerHelper("sum", **kwargs)
    out = helper.create_tmp_variable(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out


def assign(input, output=None, **kwargs):
    helper = LayerHelper("assign", **kwargs)
    if output is None:
        output = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input.name]},
                     outputs={"Out": [output.name]})
    return output


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  **kwargs):
    helper = LayerHelper("fill_constant_batch_size_like", **kwargs)
    out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype="float32", **kwargs):
    return fill_constant(shape, dtype, 1.0, **kwargs)


def zeros(shape, dtype="float32", **kwargs):
    return fill_constant(shape, dtype, 0.0, **kwargs)


def reshape(x, shape, **kwargs):
    helper = LayerHelper("reshape", **kwargs)
    return _unary(helper, "reshape", x, {"shape": list(shape)})



def transpose(x, perm, **kwargs):
    helper = LayerHelper("transpose", **kwargs)
    return _unary(helper, "transpose", x, {"axis": list(perm)})


def flip(x, axis, **kwargs):
    helper = LayerHelper("flip", **kwargs)
    return _unary(helper, "flip", x, {"axis": int(axis)})


def split(input, num_or_sections, dim=0, **kwargs):
    helper = LayerHelper("split", **kwargs)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, None
        n_out = num
    else:
        num, sections = None, list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_tmp_variable(input.dtype) for _ in range(n_out)]
    helper.append_op(type="split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def expand(x, expand_times, **kwargs):
    helper = LayerHelper("expand", **kwargs)
    return _unary(helper, "expand", x, {"expand_times": list(expand_times)})


def gather(input, index, **kwargs):
    helper = LayerHelper("gather", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def scatter(input, index, updates, **kwargs):
    helper = LayerHelper("scatter", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input.name], "Index": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]})
    return out


def pad(x, paddings, pad_value=0.0, **kwargs):
    helper = LayerHelper("pad", **kwargs)
    return _unary(helper, "pad", x, {"paddings": list(paddings),
                                     "pad_value": pad_value})


def crop(x, offsets, shape, **kwargs):
    helper = LayerHelper("crop", **kwargs)
    return _unary(helper, "crop", x, {"offsets": list(offsets),
                                      "shape": list(shape)})


def sequence_reshape_noop(x, new_dim, **kwargs):
    """A reshape of the trailing axis to ``new_dim``."""
    return reshape(x, [-1, new_dim], **kwargs)


def argmax(x, axis=-1, **kwargs):
    helper = LayerHelper("arg_max", **kwargs)
    return _unary(helper, "arg_max", x, {"axis": axis}, dtype="int64")


def argmin(x, axis=-1, **kwargs):
    helper = LayerHelper("arg_min", **kwargs)
    return _unary(helper, "arg_min", x, {"axis": axis}, dtype="int64")


def stack(x, axis=0, **kwargs):
    helper = LayerHelper("stack", **kwargs)
    out = helper.create_tmp_variable(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": [v.name for v in x]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends, **kwargs):
    helper = LayerHelper("slice", **kwargs)
    return _unary(helper, "slice", input,
                  {"axes": list(axes), "starts": list(starts),
                   "ends": list(ends)}, slot_in="Input")


def shape(input, **kwargs):
    helper = LayerHelper("shape", **kwargs)
    return _unary(helper, "shape", input, {}, dtype="int64",
                  slot_in="Input")


def increment(x, value=1.0, in_place=True, **kwargs):
    helper = LayerHelper("increment", **kwargs)
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": value},
                     infer_shape=False)
    return out


def create_array(max_len, elem_shape, dtype="float32", **kwargs):
    """A [max_len, ...] buffer of zeros, the reference's stand-in for a
    tensor array."""
    return fill_constant([max_len] + list(elem_shape), dtype, 0.0,
                         **kwargs)


def array_write(x, i, array, **kwargs):
    """array[i] = x (runtime index i, clamped into bounds); returns the
    updated array."""
    helper = LayerHelper("array_write", **kwargs)
    out = helper.create_tmp_variable(array.dtype)
    helper.append_op(type="array_write",
                     inputs={"Array": [array.name], "X": [x.name],
                             "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_read(array, i, **kwargs):
    """Returns array[i] (runtime index, clamped into bounds)."""
    helper = LayerHelper("array_read", **kwargs)
    out = helper.create_tmp_variable(array.dtype)
    helper.append_op(type="array_read",
                     inputs={"Array": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def multiplex(inputs, index, **kwargs):
    helper = LayerHelper("multiplex", **kwargs)
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": [v.name for v in inputs],
                             "Ids": [index.name]},
                     outputs={"Out": [out.name]})
    return out


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
