"""DecodePolicy: the construction-time description of "next token"
(the port's copy of ``paddle_tpu/serving/decoding/policy.py``, reading
the port's ``config``; its fingerprints are string-equal to the
reference's for the same knobs).

A policy is immutable and fully describable by its
:meth:`~DecodePolicy.fingerprint` — the fleet tier journals that
fingerprint with every token stream, because a replay journal is only
re-drivable on a peer that will make the SAME next-token decisions
(the weights-version rule extended to decode semantics).
"""

import hashlib
import json
import random

from ... import config as _config

__all__ = ["DecodePolicy", "mint_seed", "GREEDY_FINGERPRINT"]

# What a scheduler with no policy object reports: the implicit
# argmax-everywhere policy of a session built without one.
GREEDY_FINGERPRINT = "greedy"


def mint_seed():
    """A fresh per-request RNG seed, minted ONCE at admission (router
    or scheduler front door) and carried in the replay journal / fleet
    envelope from then on. Plain stdlib randomness — the seed is
    identity, not entropy-critical, and serving code never draws from
    torch's generators. 31 bits on purpose: the value survives an int32
    device feed unchanged, so every fleet member (either package)
    derives keys from the numerically identical seed."""
    return random.getrandbits(31)


class DecodePolicy:
    """Immutable decode-policy description, resolved at construction.

    kind          -- "greedy" or "sample"
    temperature / top_k / top_p
                  -- sampling knobs (kind == "sample"); temperature
                     must be > 0, top_k == 0 and top_p == 1.0 disable
                     their filters
    speculate_k   -- > 0 enables speculative decoding with k draft
                     tokens per round (paged sessions only)
    draft         -- dict of transformer_lm_session overrides for the
                     draft model, or None for the default 1-layer
                     truncated self-draft (same scope, shared weights)
    constraint    -- a TokenConstraint whose per-state mask rows are
                     added to the logits on device, or None
    """

    __slots__ = ("kind", "temperature", "top_k", "top_p",
                 "speculate_k", "draft", "constraint")

    def __init__(self, kind="greedy", temperature=1.0, top_k=0,
                 top_p=1.0, speculate_k=0, draft=None, constraint=None):
        if kind not in ("greedy", "sample"):
            raise ValueError("decode_policy must be 'greedy' or "
                             "'sample', got %r" % (kind,))
        if kind == "sample" and not temperature > 0.0:
            raise ValueError("decode_temperature must be > 0 (use "
                             "kind='greedy' for argmax), got %r"
                             % (temperature,))
        if top_k < 0 or not 0.0 < top_p <= 1.0:
            raise ValueError("need top_k >= 0 and 0 < top_p <= 1.0")
        if speculate_k < 0:
            raise ValueError("decode_speculate_k must be >= 0")
        if constraint is not None and speculate_k:
            # the verify window would need per-position constraint
            # states that only exist after the previous position's
            # token is known — a host round-trip per window row.
            # Rejected at construction rather than silently slow.
            raise ValueError("constrained decoding does not compose "
                             "with speculative decoding")
        if draft is not None and not speculate_k:
            raise ValueError("decode_draft_model without "
                             "decode_speculate_k > 0")
        self.kind = kind
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.speculate_k = int(speculate_k)
        self.draft = dict(draft) if draft else None
        self.constraint = constraint

    # -- flag resolution (the ONLY place decode_* flags are read) ----

    @classmethod
    def from_flags(cls):
        """Resolve the decode_* flags into a policy — or ``None`` when
        every flag sits at its default, so the all-defaults session
        constructs nothing and stays byte-identical greedy. Called
        exactly once, from ``transformer_lm_session``."""
        kind = _config.get_flag("decode_policy")
        spec_k = int(_config.get_flag("decode_speculate_k") or 0)
        constraint = _config.get_flag("decode_constraint")
        if kind == "greedy" and not spec_k and constraint is None:
            return None
        return cls(kind=kind,
                   temperature=_config.get_flag("decode_temperature"),
                   top_k=_config.get_flag("decode_top_k"),
                   top_p=_config.get_flag("decode_top_p"),
                   speculate_k=spec_k,
                   draft=_config.get_flag("decode_draft_model"),
                   constraint=constraint)

    # -- properties ---------------------------------------------------

    @property
    def sampled(self):
        return self.kind == "sample"

    def fingerprint(self):
        """Stable short digest of every decision-relevant field. Two
        schedulers with equal fingerprints make identical next-token
        choices given identical weights — the precondition for
        resuming a replay journal across fleet members."""
        # speculate_k and the draft spec do NOT affect emitted tokens
        # (verify re-decides every position with the TARGET's logits
        # under the target's keys), so they are excluded: members with
        # different drafts — or none — may legally share journals. A
        # speculative-greedy policy IS the implicit greedy policy.
        if self.kind == "greedy" and self.constraint is None:
            return GREEDY_FINGERPRINT
        doc = {"kind": self.kind}
        if self.sampled:
            doc.update(temperature=self.temperature, top_k=self.top_k,
                       top_p=self.top_p)
        if self.constraint is not None:
            doc["constraint"] = self.constraint.digest()
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return "%s:%s" % (self.kind,
                          hashlib.blake2b(blob.encode(),
                                          digest_size=6).hexdigest())

    def __repr__(self):
        return "DecodePolicy(%s)" % self.fingerprint()
