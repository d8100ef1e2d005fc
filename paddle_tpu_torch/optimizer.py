"""Optimizers (reference ``paddle_tpu/optimizer.py``): ``SGD``,
``Momentum``, ``Adagrad``, ``Adam``, ``Adamax``, ``DecayedAdagrad``,
``AdaDelta``, ``RMSProp``, ``Ftrl`` and ``ModelAverage``.

``SGD``, ``Momentum`` and ``Adam`` come in two forms served by one class
per name. The ``nn.Module`` form takes ``{reference name: parameter}``
first (for a ResNet, ``model.reference_parameters()``) and keeps its
accumulators under the reference's scope names: the velocity of
parameter ``p`` is ``p_velocity_acc_0`` and the learning rate
``learning_rate_0``, so a reference scope's optimizer state loads by name
(``io.params_from_jax``); Adam's are ``p_moment1_acc_0``,
``p_moment2_acc_0``, ``p_beta1_pow_acc_0`` and ``p_beta2_pow_acc_0``.
An optimizer of this form trains its parameters: it turns their
``requires_grad`` on. :meth:`step` applies the update ops of
``ops/optimizer_ops.py`` in place to every parameter that has a
gradient.

The program form, the only one of the other update rules, takes the
learning rate first, as the reference's does (``Momentum(0.1, 0.9)``),
and :meth:`minimize` appends to the loss's program, as the reference's
does: the backward (``core/backward.py``), the gradient clips
(``clip.py``), the regularization (``regularizer.py``: a parameter's
own, else the optimizer's ``regularization``), one update op per
parameter (a parameter's ``learning_rate`` multiple through a ``scale``
op of the learning rate), and an ``increment`` of ``global_step`` when
one is given; the accumulators and the learning rate are persistable
variables initialized by the startup program, under the same names.
SGD, Momentum, Adagrad and Adam also take the sparse gradients of an
``is_sparse`` embedding (rows and their values), as the reference's
do."""

import contextlib

import torch

from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.backward import append_backward
from .core.framework import (Variable, default_main_program,
                             default_startup_program)
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .ops import optimizer_ops
from .regularizer import append_regularization_ops

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
           "AdaDelta", "RMSProp", "Ftrl", "SGDOptimizer",
           "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
           "AdamaxOptimizer", "DecayedAdagradOptimizer",
           "AdaDeltaOptimizer", "RMSPropOptimizer", "FtrlOptimizer",
           "ModelAverage"]

LR_NAME = "learning_rate_0"


def _forms(args, kwargs, names, defaults, module_form=True):
    """(params, {name: value}) of a constructor call: the nn.Module form
    passes the parameters first, the program form starts at the learning
    rate (a number or a Variable). ``regularization`` and
    ``global_step`` (keywords) belong to the program form."""
    args, kwargs = list(args), dict(kwargs)
    params = kwargs.pop("params", None)
    if args and params is None and \
            not isinstance(args[0], (int, float, Variable)):
        params = args.pop(0)
    if params is not None and not module_form:
        raise TypeError("this optimizer has the program form only: give "
                        "it the learning rate and call minimize")
    names = tuple(names) + ("regularization", "global_step")
    defaults = tuple(defaults) + (None, None)
    if len(args) > len(names) - 2:
        raise TypeError("too many arguments: %r" % (args,))
    values = dict(zip(names, defaults))
    values.update(zip(names, args))
    for k, v in kwargs.items():
        if k not in names:
            raise TypeError("unexpected argument %r" % k)
        values[k] = v
    if params is not None and (values["regularization"] is not None or
                               values["global_step"] is not None):
        raise TypeError("regularization and global_step are appended by "
                        "minimize: the program form")
    return params, values


class _Optimizer:
    def __init__(self, params, learning_rate, regularization=None,
                 global_step=None):
        if learning_rate is None:
            raise TypeError("learning_rate is required")
        self.regularization = regularization
        self._global_step = global_step
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
        """The learning rate variable of ``param``: the optimizer's, or
        for a parameter with its own ``learning_rate`` multiple, a
        ``scale`` of it."""
        mult = param.optimize_attr.get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        block = main.global_block()
        out = block.create_var(
            name=unique_name.generate("%s.lr" % param.name), shape=[1],
            dtype="float32", stop_gradient=True)
        block.append_op("scale", inputs={"X": [self._lr_var.name]},
                        outputs={"Out": [out.name]},
                        attrs={"scale": float(mult)})
        return out

    def _add_accumulator(self, name, param, main, startup, fill_value=0.0,
                         shape=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        shape = list(shape if shape is not None else param.shape)
        vname = unique_name.generate("%s_%s_acc" % (param.name, name))
        # a distributed table's row-shaped slots (Adam's moments) are
        # registered beside it: a strategy row-shards them by the same
        # rule and a checkpoint reshard permutes them with it; [1] slots
        # (the beta powers) stay replicated
        tables = getattr(main, "_dist_embeddings", None)
        if tables is not None and param.name in tables and \
                tables[param.name].get("slot_of") is None and \
                shape and shape[0] == tables[param.name]["padded"]:
            info = tables[param.name]
            tables[vname] = {"vocab": info["vocab"],
                             "padded": info["padded"],
                             "dim": info["dim"], "slot_of": param.name}
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
        """Append the backward of ``loss``, the gradient clips, the
        regularization, the update ops and the ``global_step`` increment
        to its program (the accumulators' and the learning rate's
        initializers to ``startup_program``, default the default startup
        program). Returns ``(update ops, [(parameter, gradient
        variable)])``."""
        main = loss.block.program
        startup = startup_program or default_startup_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_lr_var(main, startup)
        ops = []
        for param, grad in params_grads:
            if grad is not None:
                self._check_sparse(grad)
                ops.append(self._append_optimize_op(main, startup, param,
                                                    grad))
        if self._global_step is not None:
            loss.block.append_op(
                "increment", inputs={"X": [self._global_step.name]},
                outputs={"Out": [self._global_step.name]},
                attrs={"step": 1.0}, infer_shape=False)
        return ops, params_grads

    def _append_optimize_op(self, main, startup, param, grad):
        raise NotImplementedError

    @staticmethod
    def _grad_inputs(grad):
        """The update op's gradient slots: a sparse (SelectedRows)
        gradient adds its Rows."""
        ins = {"Grad": [grad.name]}
        rows = getattr(grad, "selected_rows", None)
        if rows is not None:
            ins["Rows"] = [rows.name]
        return ins

    _SPARSE_CAPABLE = False

    def _check_sparse(self, grad):
        if getattr(grad, "selected_rows", None) is not None and \
                not self._SPARSE_CAPABLE:
            raise NotImplementedError(
                "%s has no sparse (SelectedRows) update rule — use "
                "SGD/Momentum/Adagrad/Adam for is_sparse embeddings"
                % type(self).__name__)


class SGD(_Optimizer):
    """``param <- param - lr * grad``. ``SGD(params, learning_rate)`` or
    ``SGD(learning_rate=0.001)``."""

    _SPARSE_CAPABLE = True

    def __init__(self, *args, **kwargs):
        params, v = _forms(args, kwargs, ("learning_rate",), (0.001,))
        super().__init__(params, v["learning_rate"], v["regularization"],
                         v["global_step"])

    def _update(self, name, param, grad):
        optimizer_ops.sgd(param, grad, self.learning_rate)

    def _append_optimize_op(self, main, startup, param, grad):
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "sgd",
            inputs=dict(self._grad_inputs(grad), Param=[param.name],
                        LearningRate=[lr.name]),
            outputs={"ParamOut": [param.name]}, infer_shape=False)


class Momentum(_Optimizer):
    """Heavy-ball momentum, or Nesterov's with ``use_nesterov``; the
    velocities start at 0. ``Momentum(params, learning_rate, momentum,
    use_nesterov)`` or ``Momentum(learning_rate, momentum,
    use_nesterov)``."""

    _SPARSE_CAPABLE = True

    def __init__(self, *args, **kwargs):
        params, v = _forms(args, kwargs, ("learning_rate", "momentum",
                                          "use_nesterov"), (None, 0.9, False))
        super().__init__(params, v["learning_rate"], v["regularization"],
                         v["global_step"])
        self.momentum = v["momentum"]
        self.use_nesterov = v["use_nesterov"]
        self.velocities = {name: torch.zeros_like(p)
                           for name, p in (self.params or {}).items()}

    def _append_optimize_op(self, main, startup, param, grad):
        vel = self._add_accumulator("velocity", param, main, startup)
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "momentum",
            inputs=dict(self._grad_inputs(grad), Param=[param.name],
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

    _SPARSE_CAPABLE = True

    def __init__(self, *args, **kwargs):
        params, v = _forms(args, kwargs, ("learning_rate", "beta1", "beta2",
                                          "epsilon"),
                           (0.001, 0.9, 0.999, 1e-8))
        super().__init__(params, v["learning_rate"], v["regularization"],
                         v["global_step"])
        beta1, beta2 = v["beta1"], v["beta2"]
        self.beta1, self.beta2, self.epsilon = beta1, beta2, v["epsilon"]
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
            inputs=dict(self._grad_inputs(grad), Param=[param.name],
                        Moment1=[m1.name], Moment2=[m2.name],
                        Beta1Pow=[b1p.name], Beta2Pow=[b2p.name],
                        LearningRate=[lr.name]),
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon}, infer_shape=False)


class _ProgramOptimizer(_Optimizer):
    """An update rule of the program form only (``minimize``)."""

    _NAMES = ("learning_rate",)
    _DEFAULTS = (None,)

    def __init__(self, *args, **kwargs):
        _, v = _forms(args, kwargs, self._NAMES, self._DEFAULTS,
                      module_form=False)
        super().__init__(None, v["learning_rate"], v["regularization"],
                         v["global_step"])
        for name in self._NAMES[1:]:
            setattr(self, "_" + name, v[name])


class Adagrad(_ProgramOptimizer):
    """``Adagrad(learning_rate, epsilon=1e-6)``."""

    _SPARSE_CAPABLE = True

    _NAMES = ("learning_rate", "epsilon")
    _DEFAULTS = (None, 1e-6)

    def _append_optimize_op(self, main, startup, param, grad):
        moment = self._add_accumulator("moment", param, main, startup)
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "adagrad",
            inputs=dict(self._grad_inputs(grad), Param=[param.name],
                        Moment=[moment.name], LearningRate=[lr.name]),
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name]},
            attrs={"epsilon": self._epsilon}, infer_shape=False)


class Adamax(_ProgramOptimizer):
    """``Adamax(learning_rate=0.001, beta1=0.9, beta2=0.999,
    epsilon=1e-8)``."""

    _NAMES = ("learning_rate", "beta1", "beta2", "epsilon")
    _DEFAULTS = (0.001, 0.9, 0.999, 1e-8)

    def _append_optimize_op(self, main, startup, param, grad):
        m = self._add_accumulator("moment", param, main, startup)
        inf = self._add_accumulator("inf_norm", param, main, startup)
        b1p = self._add_accumulator("beta1_pow", param, main, startup,
                                    fill_value=self._beta1, shape=[1])
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "adamax",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment": [m.name], "InfNorm": [inf.name],
                    "Beta1Pow": [b1p.name], "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name], "Beta1PowOut": [b1p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)


class DecayedAdagrad(_ProgramOptimizer):
    """``DecayedAdagrad(learning_rate, decay=0.95, epsilon=1e-6)``."""

    _NAMES = ("learning_rate", "decay", "epsilon")
    _DEFAULTS = (None, 0.95, 1e-6)

    def _append_optimize_op(self, main, startup, param, grad):
        moment = self._add_accumulator("moment", param, main, startup)
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "decayed_adagrad",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment": [moment.name], "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdaDelta(_ProgramOptimizer):
    """``AdaDelta(learning_rate=1.0, rho=0.95, epsilon=1e-6)``; the rule
    takes no learning rate."""

    _NAMES = ("learning_rate", "rho", "epsilon")
    _DEFAULTS = (1.0, 0.95, 1e-6)

    def _append_optimize_op(self, main, startup, param, grad):
        g2 = self._add_accumulator("avg_squared_grad", param, main, startup)
        u2 = self._add_accumulator("avg_squared_update", param, main,
                                   startup)
        return main.global_block().append_op(
            "adadelta",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "AvgSquaredGrad": [g2.name],
                    "AvgSquaredUpdate": [u2.name]},
            outputs={"ParamOut": [param.name], "AvgSquaredGradOut":
                     [g2.name], "AvgSquaredUpdateOut": [u2.name]},
            attrs={"rho": self._rho, "epsilon": self._epsilon},
            infer_shape=False)


class RMSProp(_ProgramOptimizer):
    """``RMSProp(learning_rate, decay=0.9, momentum=0.0,
    epsilon=1e-10)``."""

    _NAMES = ("learning_rate", "decay", "momentum", "epsilon")
    _DEFAULTS = (None, 0.9, 0.0, 1e-10)

    def _append_optimize_op(self, main, startup, param, grad):
        ms = self._add_accumulator("mean_square", param, main, startup)
        mom = self._add_accumulator("moment", param, main, startup)
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "rmsprop",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "MeanSquare": [ms.name], "Moment": [mom.name],
                    "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name], "MeanSquareOut": [ms.name],
                     "MomentOut": [mom.name]},
            attrs={"decay": self._decay, "momentum": self._momentum,
                   "epsilon": self._epsilon}, infer_shape=False)


class Ftrl(_ProgramOptimizer):
    """``Ftrl(learning_rate, l1=0.0, l2=0.0, lr_power=-0.5)``."""

    _NAMES = ("learning_rate", "l1", "l2", "lr_power")
    _DEFAULTS = (None, 0.0, 0.0, -0.5)

    def _append_optimize_op(self, main, startup, param, grad):
        sq = self._add_accumulator("squared", param, main, startup)
        lin = self._add_accumulator("linear", param, main, startup)
        lr = self._lr_for_param(main, param)
        return main.global_block().append_op(
            "ftrl",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name],
                    "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power}, infer_shape=False)


# the base class under the reference's name (``paddle_tpu/optimizer.py``)
Optimizer = _Optimizer

# fluid-style aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdaDeltaOptimizer = AdaDelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl


class ModelAverage:
    """Parameter averaging for evaluation (reference ``ModelAverage``):
    ops appended to the main program count the steps and sum each
    parameter (in float32) after its update; :meth:`apply` swaps the
    averages into the scope around an evaluation, :meth:`restore` (or
    leaving ``apply``'s context) swaps the trained values back. The
    window runs from construction or the last :meth:`reset_window`."""

    def __init__(self, main_program=None, startup_program=None,
                 parameter_list=None):
        main = main_program or default_main_program()
        startup = startup_program or default_startup_program()
        block = main.global_block()
        sblock = startup.global_block()
        params = block.all_parameters()
        if parameter_list is not None:
            wanted = {p if isinstance(p, str) else p.name
                      for p in parameter_list}
            params = [p for p in params if p.name in wanted]
        self._param_names = [p.name for p in params]
        self._sums = {}
        cname = unique_name.generate("model_average_count")
        block.create_var(name=cname, shape=[1], dtype="float32",
                         persistable=True, stop_gradient=True)
        svar = sblock.create_var(name=cname, shape=[1], dtype="float32",
                                 persistable=True)
        ConstantInitializer(0.0)(svar, sblock)
        block.append_op("increment", inputs={"X": [cname]},
                        outputs={"Out": [cname]}, attrs={"step": 1.0},
                        infer_shape=False)
        self._count_name = cname
        for p in params:
            sname = unique_name.generate("%s_avg_sum" % p.name)
            block.create_var(name=sname, shape=list(p.shape),
                             dtype="float32", persistable=True,
                             stop_gradient=True)
            sv = sblock.create_var(name=sname, shape=list(p.shape),
                                   dtype="float32", persistable=True)
            ConstantInitializer(0.0)(sv, sblock)
            block.append_op("elementwise_add",
                            inputs={"X": [sname], "Y": [p.name]},
                            outputs={"Out": [sname]}, infer_shape=False)
            self._sums[p.name] = sname
        self._backup = None

    def apply(self, scope=None):
        """A context in which the scope holds the averaged parameters."""
        @contextlib.contextmanager
        def _ctx():
            self._swap_in(scope)
            try:
                yield
            finally:
                self.restore(scope)
        return _ctx()

    def _swap_in(self, scope=None):
        scope = scope or global_scope()
        count_t = scope.find_var(self._count_name)
        if float(count_t.reshape(-1)[0]) <= 0:
            raise RuntimeError("ModelAverage.apply before any step ran")
        count = count_t.reshape(())
        self._backup = {}
        for pname in self._param_names:
            param = scope.find_var(pname)
            self._backup[pname] = param
            # the parameter's own dtype, so the step's feed signature
            # stays as it was
            scope.set_var(pname, (scope.find_var(self._sums[pname]) /
                                  count).to(param.dtype))

    def restore(self, scope=None):
        scope = scope or global_scope()
        if self._backup is None:
            return
        for pname, val in self._backup.items():
            scope.set_var(pname, val)
        self._backup = None

    def reset_window(self, scope=None):
        """Restart the accumulation (the window's boundary)."""
        scope = scope or global_scope()
        count = scope.find_var(self._count_name)
        scope.set_var(self._count_name, torch.zeros_like(count))
        for pname in self._param_names:
            scope.set_var(self._sums[pname], torch.zeros_like(
                scope.find_var(self._sums[pname])))
