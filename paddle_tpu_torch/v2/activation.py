"""v2 activation descriptors (reference ``python/paddle/v2/activation.py``
wrapping config BaseActivation classes).

The port's copy of ``paddle_tpu/v2/activation.py``: it imports nothing
of that package.
"""

__all__ = ["Linear", "Relu", "Sigmoid", "Tanh", "Softmax", "Exp",
           "Identity"]


class _Act:
    name = None

    def __repr__(self):
        return "activation.%s" % type(self).__name__


class Linear(_Act):
    name = None


Identity = Linear


class Relu(_Act):
    name = "relu"


class Sigmoid(_Act):
    name = "sigmoid"


class Tanh(_Act):
    name = "tanh"


class Softmax(_Act):
    name = "softmax"


class Exp(_Act):
    name = "exp"
