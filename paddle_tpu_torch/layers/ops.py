"""Unary layer wrappers of the program front end (reference
``paddle_tpu/layers/ops.py``, which generates them for its activations):
``relu``, ``gelu`` and ``softmax``."""

from ..layer_helper import LayerHelper

_ACTIVATIONS = ["relu", "gelu", "softmax"]

__all__ = list(_ACTIVATIONS)


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
