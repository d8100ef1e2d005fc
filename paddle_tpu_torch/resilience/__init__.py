"""Fault tolerance of the port (reference ``paddle_tpu/resilience``).

* ``faults`` — the deterministic fault-injection registry the chaos
  tests drive (``arm`` / ``disarm`` / ``fire_point``), with the
  reference's site names.

The reference's training supervisor (``supervisor``: ResilientTrainer,
RecoveryPolicy, resilient_reader, StepWatchdog, preemption_guard) is not
ported yet (ROADMAP Queue A, "Resilience, deploy, observability"):
asking for one of its names raises NotImplementedError.
"""

from . import faults  # noqa: F401

_SUPERVISOR_EXPORTS = ("ResilientTrainer", "RecoveryPolicy",
                       "resilient_reader", "StepWatchdog",
                       "preemption_guard")

__all__ = ["faults"]


def __getattr__(name):
    if name in _SUPERVISOR_EXPORTS:
        raise NotImplementedError(
            "resilience.%s: the training supervisor is not ported yet "
            "(ROADMAP Queue A, \"Resilience, deploy, observability\")"
            % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
