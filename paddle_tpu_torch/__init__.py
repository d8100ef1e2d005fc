"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu, for an
NVIDIA H100.

It serves the transformer LM through the reference's entry points: the
session builder ``models.transformer.transformer_lm_session``,
``serving.GenerationSession`` and ``serving.GenerationScheduler``. Its
attention runs in hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use. Entry points run on CUDA unless the caller
passes ``device="cpu"``. It imports nothing of ``paddle_tpu`` or JAX.
"""

from . import config
from .place import resolve_device

__all__ = ["config", "resolve_device"]
