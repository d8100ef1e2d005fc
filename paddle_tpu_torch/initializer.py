"""Parameter initializers (reference ``paddle_tpu/initializer.py``).

Constant / Uniform / Normal / Xavier / MSRA / NumpyArray as ops appended
to the startup program: an initializer appends ONE op, and running the startup
program draws the reference's initial weights (``ops/random_ops.py``).
"""

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "MSRA",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer", "MSRAInitializer", "NumpyArrayInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return (1, shape[0] if shape else 1)
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        # conv filters are [out_c, in_c, *spatial]; fc weights [in, out]
        if len(shape) > 2:
            fan_in = shape[1] * receptive
            fan_out = shape[0] * receptive
        else:
            fan_in, fan_out = shape[0], shape[1]
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)},
                        infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": float(self.low),
                               "max": float(self.high), "seed": self.seed},
                        infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale), "seed": self.seed},
                        infer_shape=False)


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fi + fo)))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fi))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fi))
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """Initialize from a literal array (one ``assign_value`` op)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            "assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape),
                   "dtype": var.dtype,
                   "values": self.value.ravel().tolist()},
            infer_shape=False)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
