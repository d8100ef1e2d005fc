"""Layers of the port.

The program front end, a flat namespace like the reference's
``paddle_tpu.layers`` (``io``, ``nn``, ``tensor``, ``ops``, ``sequence``,
``control_flow``, ``detection``, ``beam_search``, ``legacy``): each
function appends ops to the current program.
Beside it, ``attention`` holds the LM's layers (program forms and
``nn.Module``s) and ``conv`` the ResNet's ``nn.Module`` layers.
"""

from .io import *        # noqa: F401,F403
from .nn import *        # noqa: F401,F403
from .tensor import *    # noqa: F401,F403
from .ops import *       # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .beam_search import *  # noqa: F401,F403
from .legacy import *    # noqa: F401,F403

from . import (io, nn, tensor, ops, sequence, control_flow,  # noqa: F401
               detection, beam_search, legacy)

__all__ = (io.__all__ + nn.__all__ + tensor.__all__ + ops.__all__ +
           sequence.__all__ + control_flow.__all__ + detection.__all__ +
           beam_search.__all__ + legacy.__all__)
