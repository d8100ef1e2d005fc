"""Learning-rate schedules (reference ``paddle_tpu/lr_scheduler.py``):
host-side objects that compute the learning rate of each step and write
it into the optimizer's persistable learning-rate variable in the scope,
as a one-element float32 tensor on the device the variable already lives
on (the executor's), so the next ``Executor.run`` reads it there."""

import bisect

import numpy as np
import torch

from .core.scope import global_scope

__all__ = ["LRScheduler", "ExponentialDecay", "InverseTimeDecay",
           "PolynomialDecay", "PiecewiseDecay", "LinearWarmup",
           "NaturalExpDecay"]


class LRScheduler:
    def __init__(self, optimizer, base_lr=None):
        self.optimizer = optimizer
        self.base_lr = base_lr if base_lr is not None else \
            optimizer._learning_rate
        self.step_num = 0

    def get_lr(self, step):
        raise NotImplementedError

    def step(self, scope=None):
        """Advance one step and write the new lr into the scope; returns
        it."""
        self.step_num += 1
        lr = float(self.get_lr(self.step_num))
        scope = scope or global_scope()
        var = self.optimizer._lr_var
        if var is None:
            raise RuntimeError("optimizer.minimize must run before "
                               "scheduler.step")
        old = scope.find_var(var.name)
        device = old.device if isinstance(old, torch.Tensor) else "cpu"
        scope.set_var(var.name, torch.full((1,), lr, dtype=torch.float32,
                                           device=device))
        return lr


class ExponentialDecay(LRScheduler):
    def __init__(self, optimizer, decay_steps, decay_rate,
                 staircase=False, **kw):
        super().__init__(optimizer, **kw)
        self.decay_steps, self.decay_rate = decay_steps, decay_rate
        self.staircase = staircase

    def _exponent(self, step):
        e = step / self.decay_steps
        return np.floor(e) if self.staircase else e

    def get_lr(self, step):
        return self.base_lr * (self.decay_rate ** self._exponent(step))


class NaturalExpDecay(ExponentialDecay):
    def get_lr(self, step):
        return self.base_lr * np.exp(-self.decay_rate * self._exponent(step))


class InverseTimeDecay(ExponentialDecay):
    def get_lr(self, step):
        return self.base_lr / (1.0 + self.decay_rate * self._exponent(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, optimizer, decay_steps, end_lr=1e-4, power=1.0,
                 cycle=False, **kw):
        super().__init__(optimizer, **kw)
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle

    def get_lr(self, step):
        if self.cycle:
            div = max(1.0, np.ceil(step / self.decay_steps))
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1.0 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class PiecewiseDecay(LRScheduler):
    def __init__(self, optimizer, boundaries, values):
        super().__init__(optimizer)
        assert len(values) == len(boundaries) + 1
        self.boundaries, self.values = list(boundaries), list(values)

    def get_lr(self, step):
        return self.values[bisect.bisect_right(self.boundaries, step)]


class LinearWarmup(LRScheduler):
    """Warm up linearly, then hand off to an inner schedule (or stay at
    the base rate)."""

    def __init__(self, optimizer, warmup_steps, start_lr=0.0, inner=None,
                 **kw):
        super().__init__(optimizer, **kw)
        self.warmup_steps, self.start_lr = warmup_steps, start_lr
        self.inner = inner

    def get_lr(self, step):
        if step < self.warmup_steps:
            frac = step / self.warmup_steps
            return self.start_lr + (self.base_lr - self.start_lr) * frac
        if self.inner is not None:
            return self.inner.get_lr(step - self.warmup_steps)
        return self.base_lr
