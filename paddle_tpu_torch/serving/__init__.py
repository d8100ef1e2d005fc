"""Serving tier of the port (reference ``paddle_tpu/serving``).

* :mod:`engine` — :class:`ServingEngine`: loads an exported or merged
  model once, pads requests to fixed batch buckets, warms every bucket,
  and dispatches round-robin across replicas — skipping replicas whose
  circuit breaker is open, failing requests over to the next healthy
  replica — with deadlines and hot weight swaps.
* :mod:`batcher` — :class:`MicroBatcher`: thread-safe
  ``submit(feed) -> Future`` micro-batching with a max-latency deadline,
  bounded-queue backpressure, per-request deadlines, EWMA-based shedding
  and a graceful ``drain()``.
* :mod:`resilience` — errors, :class:`ReplicaBreaker`, the probe and the
  bounded workers.
* :mod:`deploy` — the swap error and the ``paddle_deploy_*`` counters.
* :mod:`quant` — int8 weights: live arming and artifact export/load.
* :mod:`generation` — KV-cached generation, dense or paged:
  :class:`GenerationSession` and :class:`GenerationScheduler`.
* :mod:`paged_cache` — :class:`BlockPool` and :class:`PrefixIndex`.
"""

from . import deploy  # noqa: F401
from . import quant  # noqa: F401
from . import resilience  # noqa: F401
from .resilience import (ServingDeadlineError,  # noqa: F401
                         ServingTimeoutError, ServingUnavailableError,
                         ReplicaBreaker)
from .deploy import SwapRejectedError  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .batcher import (MicroBatcher, ServingOverloadError,  # noqa: F401
                      TenantQuotaError)
from .generation import (GenerationScheduler,  # noqa: F401
                         GenerationSession, GenerationSpec)
from .paged_cache import BlockPool, PoolExhausted, PrefixIndex  # noqa: F401

__all__ = ["ServingEngine", "MicroBatcher", "ServingOverloadError",
           "TenantQuotaError", "ServingDeadlineError",
           "ServingTimeoutError", "ServingUnavailableError",
           "SwapRejectedError", "ReplicaBreaker", "GenerationSession",
           "GenerationScheduler", "GenerationSpec", "BlockPool",
           "PrefixIndex", "PoolExhausted", "deploy", "generation",
           "paged_cache", "quant", "resilience"]
