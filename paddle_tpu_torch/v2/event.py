"""v2 training events (reference ``python/paddle/v2/event.py``) — the
fluid-side Trainer already emits this exact protocol; re-exported under
the v2 names.

The port's copy of ``paddle_tpu/v2/event.py``: it imports nothing of
that package.
"""

from ..trainer import (BeginIteration, EndIteration, BeginPass,  # noqa
                       EndPass)

__all__ = ["BeginIteration", "EndIteration", "BeginPass", "EndPass"]
