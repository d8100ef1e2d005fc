"""Unique name generation for variables and ops (reference
``paddle_tpu/core/unique_name.py``, copied: a program built by the port's
front end must name its variables as the reference's does, in the same
order, or the two serialize differently).
"""

import contextlib
import threading


class _Generator:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}

    def __call__(self, prefix):
        with self._lock:
            idx = self._counters.get(prefix, 0)
            self._counters[prefix] = idx + 1
        return "%s_%d" % (prefix, idx)

    def reset(self):
        with self._lock:
            self._counters.clear()


_generator = _Generator()


def generate(prefix):
    """Return a process-unique name with ``prefix``."""
    return _generator(prefix)


def reset():
    """Reset all counters (test isolation only)."""
    _generator.reset()



@contextlib.contextmanager
def guard():
    """Snapshot/restore counters so a program rebuilt inside the guard gets
    the same generated names — required for checkpoint name stability when
    building a model more than once per process (fluid unique_name.guard
    parity)."""
    with _generator._lock:
        saved = dict(_generator._counters)
        _generator._counters.clear()
    try:
        yield
    finally:
        with _generator._lock:
            _generator._counters.clear()
            _generator._counters.update(saved)
