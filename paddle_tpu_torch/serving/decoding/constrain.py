"""Constrained decoding: host-compiled token-mask tables (the port's
copy of ``paddle_tpu/serving/decoding/constrain.py``: the same classes,
tables and ``digest()`` bytes).

The device never sees a grammar — it sees one additive [vocab] float32
row per step: 0.0 for legal tokens, -inf for banned ones, added to the
logits before argmax/sampling (``logits + mask``, the standard
structured-output trick). The HOST owns the automaton: it compiles the
mask table once at construction, picks the row for each slot's current
state at step-preparation time, and advances the state as each emitted
token comes back. That split keeps the device program static (one
extra [slots, vocab] feed) while grammars stay arbitrary Python.

Dead ends are a CLIENT error, never a hang: a state whose row bans
every token cannot make progress, so the scheduler resolves the
request with :class:`ConstraintDeadEnd` (a ValueError — the fleet tier
maps it to ``kind="client"``: no breaker charge, no replay, no
failover hop).
"""

import hashlib
import json

import numpy as np

__all__ = ["TokenConstraint", "DFAConstraint", "ConstraintDeadEnd",
           "NEG_INF"]

# Matches ops/decoding_ops.NEG_INF: finite, so masked logits stay
# NaN-free through softmax/temperature math in float32.
NEG_INF = -1e30


class ConstraintDeadEnd(ValueError):
    """The constraint automaton reached a state with no legal token.

    A ValueError on purpose: the serving tiers already classify
    ValueError as a CLIENT failure (bad request shape), which is
    exactly the right treatment — the grammar, not the server, ran
    out of road. Carries ``state`` and ``position`` for diagnosis."""

    def __init__(self, state, position):
        super(ConstraintDeadEnd, self).__init__(
            "constraint dead end: state %r at position %d has no "
            "legal token" % (state, position))
        self.state = state
        self.position = position


class TokenConstraint:
    """Interface a decode constraint implements.

    ``start``            -- initial automaton state (int)
    ``mask_table(V)``    -- np.float32 [num_states, V]: 0 legal /
                            NEG_INF banned
    ``advance(s, tok)``  -- next state after emitting ``tok`` in ``s``
    ``dead(s)``          -- True when no token is legal in ``s``
    ``digest()``         -- stable content hash (policy fingerprint)
    """

    start = 0

    def mask_table(self, vocab_size):
        raise NotImplementedError

    def advance(self, state, token):
        raise NotImplementedError

    def dead(self, state):
        raise NotImplementedError

    def digest(self):
        raise NotImplementedError

    def advance_many(self, state, tokens):
        """Fold a generated-token journal through the automaton — how
        a replay (session re-admit or fleet re-drive) reconstructs the
        live state from the journal alone."""
        for t in tokens:
            state = self.advance(state, int(t))
        return state


class DFAConstraint(TokenConstraint):
    """Explicit-transition DFA: ``transitions[state][token] ->
    next_state``. Tokens absent from a state's row are banned there;
    a state with an empty (or missing) row is a dead end. EOS is not
    special — a grammar that allows stopping in a state lists the EOS
    token in that state's row (conventionally self-looping).

    This is the compiled form a JSON-schema / grammar frontend lowers
    to; tests and workloads can also write small ones by hand.
    """

    def __init__(self, transitions, start=0):
        self.start = int(start)
        self.transitions = {
            int(s): {int(t): int(n) for t, n in row.items()}
            for s, row in transitions.items()}
        states = set(self.transitions)
        for row in self.transitions.values():
            states.update(row.values())
        states.add(self.start)
        # dense state ids so mask_table rows index directly
        self._states = sorted(states)
        self._index = {s: i for i, s in enumerate(self._states)}
        self._tables = {}  # vocab_size -> np [S, V] float32

    @property
    def num_states(self):
        return len(self._states)

    def state_index(self, state):
        return self._index[state]

    def mask_table(self, vocab_size):
        table = self._tables.get(vocab_size)
        if table is None:
            table = np.full((len(self._states), vocab_size), NEG_INF,
                            dtype=np.float32)
            for s, row in self.transitions.items():
                for tok in row:
                    if tok >= vocab_size:
                        raise ValueError(
                            "constraint token %d >= vocab %d"
                            % (tok, vocab_size))
                    table[self._index[s], tok] = 0.0
            self._tables[vocab_size] = table
        return table

    def advance(self, state, token):
        row = self.transitions.get(state, {})
        if token not in row:
            raise ValueError("token %d is not legal in constraint "
                             "state %r" % (token, state))
        return row[token]

    def dead(self, state):
        return not self.transitions.get(state)

    def digest(self):
        blob = json.dumps(
            {"start": self.start,
             "t": {str(s): sorted(row.items())
                   for s, row in self.transitions.items()}},
            sort_keys=True, separators=(",", ":"))
        return hashlib.blake2b(blob.encode(),
                               digest_size=6).hexdigest()
