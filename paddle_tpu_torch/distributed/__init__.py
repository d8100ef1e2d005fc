"""Distributed runtime (reference ``paddle_tpu/distributed``).

* multi-process bring-up: ``launch.py`` over ``torch.distributed``
  (the data-plane collectives are in ``paddle_tpu_torch.parallel``);
* control plane: the reference's daemon ``native/task_master.cc``, built
  at first use, with the client in ``master.py`` (task leases, timeout
  requeue, failure budget, snapshot recovery, cluster membership);
* elastic membership: ``elastic.py``, heartbeat-tracked cluster
  generations, the abort of a wedged process group, and the
  ElasticTrainerLoop that resumes training at the surviving world size
  after a peer's death.
"""

from .master import (MasterServer, MasterClient,  # noqa: F401
                     ElasticDataDispatcher, GenerationMismatch)
from .launch import (init_multihost, shutdown_multihost,  # noqa: F401
                     multihost_active, abort_multihost)
from .elastic import (ElasticTrainerLoop, ElasticWorld,  # noqa: F401
                      MembershipHeartbeat, ElasticRestartLimit,
                      collective_abort)

__all__ = ["MasterServer", "MasterClient", "ElasticDataDispatcher",
           "GenerationMismatch", "init_multihost", "shutdown_multihost",
           "multihost_active", "abort_multihost", "ElasticTrainerLoop",
           "ElasticWorld", "MembershipHeartbeat", "ElasticRestartLimit",
           "collective_abort"]
