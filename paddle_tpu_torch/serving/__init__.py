"""Serving tier of the port: KV-cached generation."""

from .generation import (GenerationScheduler, GenerationSession,
                         GenerationSpec, ServingDeadlineError,
                         ServingOverloadError, ServingUnavailableError)

__all__ = ["GenerationSpec", "GenerationSession", "GenerationScheduler",
           "ServingOverloadError", "ServingDeadlineError",
           "ServingUnavailableError"]
