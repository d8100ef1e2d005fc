"""v2 optimizers (reference ``python/paddle/v2/optimizer.py``): thin
constructors over the fluid-style optimizer classes (the v2 surface
took regularization/model_average kwargs; regularization maps through,
model averaging is optimizer.ModelAverage).

The port's copy of ``paddle_tpu/v2/optimizer.py``: it imports nothing of
that package.
"""

from .. import optimizer as _opt
from .. import regularizer as _reg

__all__ = ["Momentum", "Adam", "AdaGrad", "RMSProp", "AdaDelta",
           "Optimizer"]


def _regularization(rate):
    return _reg.L2Decay(rate) if rate else None


def Momentum(momentum=0.9, learning_rate=0.01,
             regularization_rate=0.0, **kwargs):
    return _opt.Momentum(learning_rate=learning_rate, momentum=momentum,
                         regularization=_regularization(
                             regularization_rate))


def Adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
         regularization_rate=0.0, **kwargs):
    return _opt.Adam(learning_rate=learning_rate, beta1=beta1,
                     beta2=beta2, epsilon=epsilon,
                     regularization=_regularization(regularization_rate))


def AdaGrad(learning_rate=1e-2, regularization_rate=0.0, **kwargs):
    return _opt.Adagrad(learning_rate=learning_rate,
                        regularization=_regularization(
                            regularization_rate))


def RMSProp(learning_rate=1e-2, regularization_rate=0.0, **kwargs):
    return _opt.RMSProp(learning_rate=learning_rate,
                        regularization=_regularization(
                            regularization_rate))


def AdaDelta(learning_rate=1.0, regularization_rate=0.0, **kwargs):
    return _opt.AdaDelta(learning_rate=learning_rate,
                         regularization=_regularization(
                             regularization_rate))


Optimizer = _opt.Optimizer
