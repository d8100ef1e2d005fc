"""Serving tier of the port: KV-cached generation, dense or paged."""

from .generation import (GenerationScheduler, GenerationSession,
                         GenerationSpec, ServingDeadlineError,
                         ServingOverloadError, ServingUnavailableError)
from .paged_cache import BlockPool, PoolExhausted, PrefixIndex

__all__ = ["GenerationSpec", "GenerationSession", "GenerationScheduler",
           "ServingOverloadError", "ServingDeadlineError",
           "ServingUnavailableError", "BlockPool", "PrefixIndex",
           "PoolExhausted"]
