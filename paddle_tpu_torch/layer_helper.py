"""LayerHelper — shared machinery for layer functions (reference
``paddle_tpu/layer_helper.py``, copied).

Parity with reference ``python/paddle/v2/fluid/layer_helper.py``: creates
parameters (in the main program's global block AND the startup program with
an initializer op), temporaries, and appends ops/activations.
"""

from .core import unique_name
from .core.framework import (default_main_program, default_startup_program,
                             convert_dtype)
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or \
            default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr.to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate("%s.w" % self.name)
        init = attr.initializer or default_initializer or \
            attr.default_initializer(is_bias)
        dtype = convert_dtype(dtype)
        gblock = self.main_program.global_block()
        existing = gblock.vars.get(name)
        if existing is not None:
            # weight sharing via a repeated ParamAttr name (fluid idiom)
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    "parameter %r reused with shape %s != %s"
                    % (name, shape, existing.shape))
            return existing
        # main program: Parameter in global block
        param = self.block.create_parameter(
            name=name, shape=shape, dtype=dtype, initializer=init,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip,
            trainable=attr.trainable, learning_rate=attr.learning_rate)
        # startup program: persistable var + init op
        sblock = self.startup_program.global_block()
        if not sblock.has_var(name):
            svar = sblock.create_var(name=name, shape=shape, dtype=dtype,
                                     persistable=True)
            init(svar, sblock)
        return param

    def create_tmp_variable(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate("%s.tmp" % self.name),
            dtype=convert_dtype(dtype), stop_gradient=stop_gradient)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None, initializer=None):
        """A persistable non-parameter var (metric state, lr, counters)."""
        gblock = self.main_program.global_block()
        name = name or unique_name.generate("%s.global" % self.name)
        var = gblock.create_var(name=name, shape=shape,
                                dtype=convert_dtype(dtype),
                                persistable=persistable, stop_gradient=True)
        if initializer is not None:
            sblock = self.startup_program.global_block()
            if not sblock.has_var(name):
                svar = sblock.create_var(name=name, shape=shape,
                                         dtype=convert_dtype(dtype),
                                         persistable=True)
                initializer(svar, sblock)
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def input_dtype(self, x):
        return x.dtype

    def append_activation(self, out_var):
        act = self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, str):
            act_type, act_attrs = act, {}
        else:
            act = dict(act)
            act_type = act.pop("type")
            act_attrs = act
        tmp = self.create_tmp_variable(out_var.dtype)
        self.append_op(type=act_type, inputs={"X": [out_var.name]},
                       outputs={"Out": [tmp.name]}, attrs=act_attrs)
        return tmp

    def append_bias_op(self, out_var, bias_attr, dim_start=1, dim_end=None):
        """Add a bias over dims [dim_start, dim_end) of out_var."""
        if bias_attr is False:
            return out_var
        size = out_var.shape[dim_start:dim_end]
        bias = self.create_parameter(ParamAttr.to_attr(bias_attr),
                                     shape=list(size), dtype=out_var.dtype,
                                     is_bias=True)
        tmp = self.create_tmp_variable(out_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [out_var.name], "Y": [bias.name]},
                       outputs={"Out": [tmp.name]},
                       attrs={"axis": dim_start})
        return tmp
