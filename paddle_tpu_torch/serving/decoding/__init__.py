"""Decode-policy subsystem of the port (reference
``paddle_tpu/serving/decoding``): counter-keyed sampling, speculative
decoding (draft + one-pass verify) and constrained output (per-state
logit masks), resolved once at session construction. The all-defaults
flags resolve to ``None``: no policy object, and greedy sessions exactly
as before.

Nothing under ``serving/`` draws from torch's own generators: every key
derives from ``ops.random_ops.decoding_key(seed, position)``, which is
what makes sampled generations replay token for token.
"""

from .policy import DecodePolicy, mint_seed
from .constrain import (TokenConstraint, DFAConstraint,
                        ConstraintDeadEnd)

__all__ = ["DecodePolicy", "mint_seed", "TokenConstraint",
           "DFAConstraint", "ConstraintDeadEnd"]
