"""Distributed runtime (reference ``paddle_tpu/distributed``): the
multi-process bring-up (``launch.py``) over ``torch.distributed``. The
data-plane collectives are in ``paddle_tpu_torch.parallel``.

The elastic control plane (``elastic.py``, ``master.py``) is not ported
yet: its names raise with the ROADMAP item that brings them."""

from .launch import (init_multihost, shutdown_multihost,  # noqa: F401
                     multihost_active)

__all__ = ["init_multihost", "shutdown_multihost", "multihost_active"]

_ELASTIC = 'ROADMAP Queue A, "Distribution and the input pipeline"'
_PENDING = ("MasterServer", "MasterClient", "ElasticDataDispatcher",
            "GenerationMismatch", "ElasticTrainerLoop", "ElasticWorld",
            "MembershipHeartbeat", "ElasticRestartLimit",
            "collective_abort", "elastic", "master")


def __getattr__(name):
    if name in _PENDING:
        raise NotImplementedError(
            "paddle_tpu_torch.distributed.%s (the elastic control plane) "
            "is not ported yet: %s" % (name, _ELASTIC))
    raise AttributeError(name)
