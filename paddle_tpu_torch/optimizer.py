"""Optimizers (reference ``paddle_tpu/optimizer.py`` ``SGD``,
``Momentum`` and ``Adam``), in two forms served by one class per name.

The ``nn.Module`` form takes ``{reference name: parameter}`` first (for
a ResNet, ``model.reference_parameters()``) and keeps its accumulators
under the reference's scope names: the velocity of parameter ``p`` is
``p_velocity_acc_0`` and the learning rate ``learning_rate_0``, so a
reference scope's optimizer state loads by name
(``io.params_from_jax``); Adam's are ``p_moment1_acc_0``,
``p_moment2_acc_0``, ``p_beta1_pow_acc_0`` and ``p_beta2_pow_acc_0``.
An optimizer of this form trains its parameters: it turns their
``requires_grad`` on. :meth:`step` applies the update ops of
``ops/optimizer_ops.py`` in place to every parameter that has a
gradient.

The program form takes the learning rate first, as the reference's
does (``Momentum(0.1, 0.9)``), and :meth:`minimize` appends the
backward (``core/backward.py``) and one update op per parameter to the
loss's program, with its accumulators and learning rate as persistable
variables initialized by the startup program, under the same names.
The reference's regularization, gradient clipping, global step and
per-parameter learning rates are not ported yet (ROADMAP Queue A,
"LeNet-5/MNIST slice"); using one raises."""

import torch

from .core import unique_name
from .core.backward import append_backward
from .core.framework import Variable, default_startup_program
from .initializer import ConstantInitializer
from .ops import optimizer_ops

__all__ = ["SGD", "Momentum", "Adam"]

LR_NAME = "learning_rate_0"

_TODO = "ROADMAP Queue A, \"LeNet-5/MNIST slice\""


def _forms(args, kwargs, names, defaults):
    """(params, [value of each of ``names``]) of a constructor call: the
    nn.Module form passes the parameters first, the program form starts
    at the learning rate (a number or a Variable)."""
    args, kwargs = list(args), dict(kwargs)
    params = kwargs.pop("params", None)
    if args and params is None and \
            not isinstance(args[0], (int, float, Variable)):
        params = args.pop(0)
    if len(args) > len(names):
        raise TypeError("too many arguments: %r" % (args,))
    values = dict(zip(names, defaults))
    values.update(zip(names, args))
    for k, v in kwargs.items():
        if k not in names:
            raise TypeError("unexpected argument %r" % k)
        values[k] = v
    if values.get("regularization") is not None or \
            values.get("global_step") is not None:
        raise NotImplementedError(
            "regularization and global_step are not ported yet: " + _TODO)
    return params, [values[n] for n in names]


class _Optimizer:
    def __init__(self, params, learning_rate):
        if learning_rate is None:
            raise TypeError("learning_rate is required")
        self.params = None if params is None else dict(params)
        self._learning_rate = learning_rate
        self.learning_rate = learning_rate \
            if isinstance(learning_rate, Variable) else float(learning_rate)
        self._lr_var = None
        self._accumulators = {}
        for p in (self.params or {}).values():
            p.requires_grad_(True)

    def _module_params(self):
        if self.params is None:
            raise TypeError("%s was built for a program (no parameters "
                            "given): use minimize" % type(self).__name__)
        return self.params

    def accumulators(self):
        """{reference scope name: accumulator tensor}."""
        return {}

    def zero_grad(self):
        for p in self._module_params().values():
            p.grad = None

    def step(self):
        for name, p in self._module_params().items():
            if p.grad is not None:
                self._update(name, p, p.grad)

    def _update(self, name, param, grad):
        raise NotImplementedError

    # -- the program form (reference Optimizer) ------------------------------
    def _create_lr_var(self, main, startup):
        if self._lr_var is not None:
            return self._lr_var
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return self._lr_var
        name = unique_name.generate("learning_rate")
        block = main.global_block()
        var = block.create_var(name=name, shape=[1], dtype="float32",
                               persistable=True, stop_gradient=True)
        svar = startup.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        ConstantInitializer(float(self._learning_rate))(
            svar, startup.global_block())
        self._lr_var = var
        return var

    def _lr_for_param(self, main, param):
        if param.optimize_attr.get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError(
                "per-parameter learning rates are not ported yet: " + _TODO)
        return self._lr_var

    def _add_accumulator(self, name, param, main, startup, fill_value=0.0,
                         shape=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        shape = list(shape if shape is not None else param.shape)
        vname = unique_name.generate("%s_%s_acc" % (param.name, name))
        var = main.global_block().create_var(
            name=vname, shape=shape, dtype=param.dtype, persistable=True,
            stop_gradient=True)
        svar = startup.global_block().create_var(
            name=vname, shape=shape, dtype=param.dtype, persistable=True)
        ConstantInitializer(fill_value)(svar, startup.global_block())
        self._accumulators[key] = var
        return var

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward of ``loss`` and the update ops to its
        program (the accumulators' and the learning rate's initializers
        to ``startup_program``, default the default startup program).
        Returns ``(update ops, [(parameter, gradient variable)])``."""
        main = loss.block.program
        startup = startup_program or default_startup_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        for param, _ in params_grads:
            if getattr(param, "regularizer", None) is not None or \
                    getattr(param, "gradient_clip", None) is not None:
                raise NotImplementedError(
                    "regularizers and gradient clipping are not ported "
                    "yet: " + _TODO)
        self._create_lr_var(main, startup)
        ops = []
        for param, grad in params_grads:
            if grad is not None:
                ops.append(self._append_optimize_op(main, startup, param,
                                                    grad))
        return ops, params_grads

    def _append_optimize_op(self, main, startup, param, grad):
        raise NotImplementedError


class SGD(_Optimizer):
    """``param <- param - lr * grad``. ``SGD(params, learning_rate)`` or
    ``SGD(learning_rate=0.001)``."""

    def __init__(self, *args, **kwargs):
        params, (lr, _, _) = _forms(
            args, kwargs, ("learning_rate", "regularization", "global_step"),
            (0.001, None, None))
        super().__init__(params, lr)

    def _update(self, name, param, grad):
        optimizer_ops.sgd(param, grad, self.learning_rate)

    def _append_optimize_op(self, main, startup, param, grad):
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "sgd",
            inputs=dict(Grad=[grad.name], Param=[param.name],
                        LearningRate=[lr.name]),
            outputs={"ParamOut": [param.name]}, infer_shape=False)


class Momentum(_Optimizer):
    """Heavy-ball momentum, or Nesterov's with ``use_nesterov``; the
    velocities start at 0. ``Momentum(params, learning_rate, momentum,
    use_nesterov)`` or ``Momentum(learning_rate, momentum,
    use_nesterov)``."""

    def __init__(self, *args, **kwargs):
        params, (lr, momentum, use_nesterov, _, _) = _forms(
            args, kwargs, ("learning_rate", "momentum", "use_nesterov",
                           "regularization", "global_step"),
            (None, 0.9, False, None, None))
        super().__init__(params, lr)
        self.momentum = momentum
        self.use_nesterov = use_nesterov
        self.velocities = {name: torch.zeros_like(p)
                           for name, p in (self.params or {}).items()}

    def _append_optimize_op(self, main, startup, param, grad):
        vel = self._add_accumulator("velocity", param, main, startup)
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "momentum",
            inputs=dict(Grad=[grad.name], Param=[param.name],
                        Velocity=[vel.name], LearningRate=[lr.name]),
            outputs={"ParamOut": [param.name], "VelocityOut": [vel.name]},
            attrs={"mu": self.momentum, "use_nesterov": self.use_nesterov},
            infer_shape=False)

    def accumulators(self):
        return {n + "_velocity_acc_0": v for n, v in self.velocities.items()}

    def _update(self, name, param, grad):
        optimizer_ops.momentum(param, grad, self.velocities[name],
                               self.learning_rate, self.momentum,
                               self.use_nesterov)


class Adam(_Optimizer):
    """Adam with bias correction through per-parameter beta powers ([1]
    tensors starting at beta1 and beta2, reference ``Adam``); the moments
    start at 0. ``Adam(params, learning_rate, beta1, beta2, epsilon)`` or
    ``Adam(learning_rate, beta1, beta2, epsilon)``."""

    def __init__(self, *args, **kwargs):
        params, (lr, beta1, beta2, epsilon, _, _) = _forms(
            args, kwargs, ("learning_rate", "beta1", "beta2", "epsilon",
                           "regularization", "global_step"),
            (0.001, 0.9, 0.999, 1e-8, None, None))
        super().__init__(params, lr)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.slots = {}
        for name, p in (self.params or {}).items():
            pow1 = torch.full((1,), beta1, dtype=p.dtype, device=p.device)
            pow2 = torch.full((1,), beta2, dtype=p.dtype, device=p.device)
            self.slots[name] = (torch.zeros_like(p), torch.zeros_like(p),
                                pow1, pow2)

    def accumulators(self):
        out = {}
        for name, slots in self.slots.items():
            for kind, t in zip(("moment1", "moment2", "beta1_pow",
                                "beta2_pow"), slots):
                out["%s_%s_acc_0" % (name, kind)] = t
        return out

    def _update(self, name, param, grad):
        optimizer_ops.adam(param, grad, *self.slots[name],
                           self.learning_rate, self.beta1, self.beta2,
                           self.epsilon)

    def _append_optimize_op(self, main, startup, param, grad):
        m1 = self._add_accumulator("moment1", param, main, startup)
        m2 = self._add_accumulator("moment2", param, main, startup)
        b1p = self._add_accumulator("beta1_pow", param, main, startup,
                                    fill_value=self.beta1, shape=[1])
        b2p = self._add_accumulator("beta2_pow", param, main, startup,
                                    fill_value=self.beta2, shape=[1])
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "adam",
            inputs=dict(Grad=[grad.name], Param=[param.name],
                        Moment1=[m1.name], Moment2=[m2.name],
                        Beta1Pow=[b1p.name], Beta2Pow=[b2p.name],
                        LearningRate=[lr.name]),
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon}, infer_shape=False)
