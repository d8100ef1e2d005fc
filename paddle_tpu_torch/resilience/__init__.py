"""Fault tolerance of the port (reference ``paddle_tpu/resilience``).

* ``faults`` — the deterministic fault-injection registry the chaos
  tests drive (``arm`` / ``disarm`` / ``fire_point``), with the
  reference's site names.
* ``supervisor`` — :class:`ResilientTrainer`: the non-finite-step
  policies (skip with a budget, rollback with an lr backoff, safe
  through the executor's ``nonfinite_guard``), the retrying reader,
  SIGTERM/SIGINT preemption that checkpoints with resume metadata, and
  the hung-step watchdog.

Only ``faults`` is imported eagerly: ``supervisor`` pulls in the trainer
stack, and ``io`` imports this package for its chaos hook, so the
supervisor's names load on first use (module ``__getattr__``).
"""

from . import faults  # noqa: F401  (light: config and logging only)

_SUPERVISOR_EXPORTS = ("ResilientTrainer", "RecoveryPolicy",
                       "resilient_reader", "StepWatchdog",
                       "preemption_guard")

__all__ = ["faults"] + list(_SUPERVISOR_EXPORTS)


def __getattr__(name):
    if name in _SUPERVISOR_EXPORTS:
        from . import supervisor
        return getattr(supervisor, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
