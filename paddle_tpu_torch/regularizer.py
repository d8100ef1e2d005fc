"""Weight-decay regularizers appended as ops (reference
``paddle_tpu/regularizer.py``): ``grad + coeff * param`` (L2) or ``grad +
coeff * sign(param)`` (L1), a parameter's own regularizer before the
optimizer's."""

from .core import unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class _Regularizer:
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(_Regularizer):
    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=unique_name.generate("%s.l2decay" % param.name),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [param.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self._coeff}, infer_shape=False)
        return decay


class L1DecayRegularizer(_Regularizer):
    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=unique_name.generate("%s.sign" % param.name),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]}, infer_shape=False)
        decay = block.create_var(
            name=unique_name.generate("%s.l1decay" % param.name),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [sign.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self._coeff}, infer_shape=False)
        return decay


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """``grad += decay(param)`` for each pair, the parameter's
    regularizer winning over ``regularization``; returns the new pairs.
    A sparse gradient would skip the decay, as in the reference, but the
    port builds none (``append_backward`` refuses them)."""
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None or \
                getattr(grad, "selected_rows", None) is not None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = reg(param, grad, block)
        new_grad = block.create_var(
            name=unique_name.generate("%s.reg_grad" % param.name),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [new_grad.name]}, infer_shape=False)
        out.append((param, new_grad))
    return out
