"""Scope: runtime storage for persistable variables (reference
``paddle_tpu/core/scope.py``).

A Scope holds only *persistable* state (parameters, optimizer
accumulators, running statistics, the RNG key) as torch tensors on the
executor's device. Temporaries live in the executor's per-run
environment and are freed after their last reader (``executor.py``).
"""

import contextlib

__all__ = ["Scope", "global_scope", "scope_guard"]


class Scope:
    def __init__(self):
        self._vars = {}

    def find_var(self, name):
        return self._vars.get(name)

    def has_var(self, name):
        return name in self._vars

    def set_var(self, name, value):
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def var_names(self):
        return list(self._vars)

    def items(self):
        return self._vars.items()

    def clear(self):
        self._vars.clear()


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev
