"""ParamAttr — per-parameter config (reference ``paddle_tpu/param_attr.py``,
copied; ``python/paddle/v2/fluid/param_attr.py``)."""

from .initializer import XavierInitializer, ConstantInitializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if arg is False:
            return False
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))

    def default_initializer(self, is_bias):
        if self.initializer is not None:
            return self.initializer
        return ConstantInitializer(0.0) if is_bias else XavierInitializer()
