"""Tensor layers of the program front end (reference
``paddle_tpu/layers/tensor.py``): ``fill_constant`` and ``reshape``."""

from ..layer_helper import LayerHelper
from ..core.framework import convert_dtype

__all__ = ["fill_constant", "reshape"]


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

