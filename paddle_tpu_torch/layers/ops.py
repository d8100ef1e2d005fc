"""Unary layer wrappers of the program front end (reference
``paddle_tpu/layers/ops.py``, which generates them for its activations),
and ``scale``."""

from ..layer_helper import LayerHelper

_ACTIVATIONS = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "sqrt", "abs", "ceil", "floor", "round", "reciprocal",
    "log", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_shrink",
    "thresholded_relu", "hard_sigmoid", "swish", "gelu", "silu", "softmax",
    "sign",
]

__all__ = list(_ACTIVATIONS) + ["scale"]


def _make_unary(op_type):
    def layer(x, name=None, **kwargs):
        attrs = {k: v for k, v in kwargs.items()
                 if k not in ("main_program", "startup_program")}
        helper = LayerHelper(op_type, name=name, **kwargs)
        out = helper.create_tmp_variable(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


for _name in _ACTIVATIONS:
    globals()[_name] = _make_unary(_name)


def scale(x, scale=1.0, bias=0.0, name=None, **kwargs):
    helper = LayerHelper("scale", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": scale, "bias": bias})
    return out
