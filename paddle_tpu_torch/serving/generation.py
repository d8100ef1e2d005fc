"""Autoregressive generation serving: KV-cache sessions and a
continuous-batching scheduler (reference
``paddle_tpu/serving/generation.py``, core only).

* :class:`GenerationSession` owns one decode batch: ``spec.slots``
  sequences over a model whose per-layer K/V caches stay on the device
  between steps. ``admit()`` prefills a prompt into one free slot and
  returns its first token; ``step()`` decodes one token for every
  active slot, each at its own depth, so sequences admitted at different
  times decode together. The caches are dense ([slots, cache_len,
  d_model] per layer) or, with ``spec.paged``, block pools addressed
  through per-sequence block tables (``serving/paged_cache.py``), with
  copy-on-write sharing of cached prompt prefixes when
  ``spec.prefix_cache`` is on.
* The next token is the spec's decode policy (``serving/decoding``):
  greedy, or sampled under the key ``decoding_key(seed, position)`` of
  the request's seed and the token's sequence index (so a stream
  replays token for token from its seed and journal), optionally
  through a constraint's mask rows; with ``speculate_k`` > 0 (paged) a
  step is a speculative round: a dense greedy draft session, kept slot
  for slot in step with this one, proposes k tokens, one verify forward
  of the target re-decides every window position with the target's own
  policy and keys, and each slot emits the accepted prefix plus the
  target's token after it, the tokens plain steps would have emitted.
* :class:`GenerationScheduler` is the front door: ``submit(prompt) ->
  Future``. A bounded queue (``ServingOverloadError`` when ``submit``
  times out on it), one dispatcher thread that admits waiting requests
  into free slots and steps every session with active slots, and
  slot-level retirement on EOS, token budget, cache capacity (the
  position table, or a paged pool with no block left) or deadline:
  co-resident sequences never stall for an admit or a retire.
  ``drain()`` serves everything accepted, then stops; ``close()`` is the
  bounded fast exit.

Not ported yet: breakers, token replay (so pool starvation finishes a
sequence at its current length, the reference's behaviour with
``generation_replay_attempts`` 0), preemption, session rebuild and step
timeouts; shedding on projected queue wait; ``swap_weights``; tracing
and metrics. Of the decode policies, what waits for those: the fault
sites ``decode_draft_mismatch`` and ``decode_constraint_dead_end``
(fault injection), the speculative counters
``paddle_generation_speculative_{drafted,accepted}_total`` (kept here as
the integers ``spec_drafted`` / ``spec_accepted``) and the
``generationVerify`` span; the scheduler's refusal of step timeouts on
speculative sessions comes with the step timeouts.

Threads: the dispatcher thread is the only caller of its sessions, and
so the only thread that launches their device work or touches a block
pool. Tokens are the only thing read back to the host, once per prefill
and once per step.
"""

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from .. import config as _config
from ..amp import flag_dtype
from ..models.transformer import kv_dtype, policy_epilogue
from ..ops.decoding_ops import decode_verify
from ..ops.random_ops import decoding_key
from . import quant as _quant
from .decoding import ConstraintDeadEnd, mint_seed
from .decoding.policy import GREEDY_FINGERPRINT
from .paged_cache import BlockPool, PoolExhausted, PrefixIndex

__all__ = ["GenerationSpec", "GenerationSession", "GenerationScheduler",
           "ServingOverloadError", "ServingDeadlineError",
           "ServingUnavailableError"]


# a step's phase 1 for its phase 2: the active slots and the starved
# ones, then either the plain step's feeds (tokens, positions, table rows,
# the policy's keys and mask) or, when ``speculative``, each speculating
# slot's (length, table row) in ``windows``
_Prepared = collections.namedtuple(
    "_Prepared", "speculative act starved tokens pos table feed windows")


class ServingOverloadError(RuntimeError):
    """Admission refused: the bounded queue stayed full past the submit
    timeout."""


class ServingDeadlineError(RuntimeError):
    """The request's absolute deadline passed before it was served."""


class ServingUnavailableError(RuntimeError):
    """No session can ever take the request."""


def _resolve(future, result=None, exception=None):
    """Set a Future's outcome; a client's cancel() racing it must not
    kill the dispatcher thread."""
    try:
        if future.cancelled():
            return
        if exception is not None:
            future.set_exception(exception)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


class GenerationSpec:
    """The contract between a model's session builder (e.g.
    ``models.transformer.transformer_lm_session``) and the session:
    shapes, token ids, the device, the cache layout and its dtype name
    (``dtype``, "float32" or "bfloat16"), and
    ``build_model(params)``, which returns a module with
    ``allocate_cache``, ``prefill`` and ``decode`` (dense) and
    ``allocate_pools``, ``prefill_paged``, ``decode(..., table)`` and
    ``copy_block`` (paged), and ``verify_paged`` (speculative). The
    paged fields default to the dense layout; the decode-policy fields
    (``vocab_size``, ``policy``: a ``DecodePolicy`` or None for greedy,
    ``draft_spec``: the speculative draft's spec) to greedy."""

    __slots__ = ("slots", "cache_len", "max_len", "prompt_buckets",
                 "eos_id", "device", "build_model", "dtype", "paged",
                 "block_size", "num_blocks", "max_blocks", "prefix_cache",
                 "vocab_size", "policy", "draft_spec")
    _DEFAULTS = {"dtype": "float32", "paged": False, "block_size": 0,
                 "num_blocks": 0, "max_blocks": 0, "prefix_cache": False,
                 "vocab_size": 0, "policy": None, "draft_spec": None}

    def __init__(self, **kwargs):
        for name, value in self._DEFAULTS.items():
            kwargs.setdefault(name, value)
        for name in self.__slots__:
            setattr(self, name, kwargs.pop(name))
        if kwargs:
            raise TypeError("unknown GenerationSpec fields: %s"
                            % sorted(kwargs))


class GenerationSession:
    """One decode batch of ``spec.slots`` cache slots over the model
    built from ``params`` ({reference parameter name: tensor}). Methods
    are single-threaded by contract: the scheduler's dispatcher thread
    is the only caller in a serving deployment.

    ``arm_quant`` (default: the ``serving_quant_compute`` flag, read
    here only) quantizes the model's mul weights to int8 in place
    (``serving/quant.py``); their products then run through kernel B3.
    ``_quant_armed`` lists the armed reference names; no float32 copy
    of an armed weight is kept.

    A speculative spec gets ``self.draft``, a dense greedy session over
    ``spec.draft_spec`` that mirrors this one slot for slot. Without
    ``draft_params`` it shares this model's tensors by reference name
    (the self-draft: embedding, positions, its layers, the norm of its
    name and the head), and this session's arming arms the draft's
    products in the same call; with ``draft_params`` (a draft of other
    widths) it holds its own weights and arms itself. ``share`` takes
    ``params`` by reference (another model's ``reference_state()``),
    the self-draft's way."""

    def __init__(self, spec, params, arm_quant=None, draft_params=None,
                 share=False):
        # the amp flag is read at each build and each run, as the
        # reference's executor reads it; generation under amp is not
        # ported (the model's prefill and decode refuse it too)
        if flag_dtype() is not None:
            raise NotImplementedError(
                "KV-cached generation under amp is not ported: turn the "
                "amp flag off to build a session")
        self.spec = spec
        self.device = spec.device
        self.model = spec.build_model(params, share=True) if share \
            else spec.build_model(params)
        if arm_quant is None:
            arm_quant = bool(_config.get_flag("serving_quant_compute"))
        policy = spec.policy
        self.policy = policy
        self.sampled = policy is not None and policy.sampled
        self.constrained = policy is not None and \
            policy.constraint is not None
        self.speculative = policy is not None and policy.speculate_k > 0
        self.draft = None
        shared = ()
        if draft_params is not None and not self.speculative:
            raise ValueError("draft_params without a speculative policy")
        if self.speculative:
            if draft_params is None:
                self.draft = GenerationSession(
                    spec.draft_spec, self.model.reference_state(),
                    arm_quant=False, share=True)
                shared = (self.draft.model,)
            else:
                self.draft = GenerationSession(spec.draft_spec, draft_params,
                                               arm_quant=arm_quant)
        self._quant_armed = []
        if arm_quant:
            self._quant_armed = _quant.arm_quant_compute(self.model, shared)
        n = spec.slots
        self.lengths = np.zeros(n, np.int64)     # cached rows per slot
        self.last_token = np.zeros(n, np.int64)  # next token to decode
        self.active = np.zeros(n, bool)
        # the deepest position any sequence may WRITE: bounded by the
        # cache and by the learned position table
        self.max_pos = min(spec.cache_len, spec.max_len)
        self.prefills = 0   # admissions run
        self.steps = 0      # decode steps run
        self.paged = bool(spec.paged)
        self.pool = None
        self.prefix = None
        kv = kv_dtype(spec.dtype)
        if self.paged:
            self.model.allocate_pools(spec.num_blocks, spec.block_size, kv)
            self.pool = BlockPool(spec.num_blocks, spec.block_size)
            if spec.prefix_cache:
                self.prefix = PrefixIndex(self.pool)
            # host block table per slot: the physical block ids backing
            # logical rows [0, lengths[slot])
            self.tables = [[] for _ in range(n)]
            # slots whose next write found no block this step: left out
            # of the step's result, finished at their current length
            self._starved = set()
            # (bucket, hist, window) per admission: hist is the shared
            # prefix that was NOT prefilled; bounded in _admit_paged
            self.prefill_log = []
        else:
            self.model.allocate_cache(spec.slots, spec.cache_len, kv)
        # per-slot request seed and constraint-automaton state, set at
        # admission and recomputable from the journal (the replay
        # contract); the mask table on the device with a zero row last,
        # the row of slots that have no state
        self.seeds = np.zeros(n, np.int64)
        self.cstate = [None] * n
        self._mask_rows = None
        if self.constrained:
            table = policy.constraint.mask_table(spec.vocab_size)
            self._mask_rows = torch.from_numpy(np.concatenate(
                [table, np.zeros((1, table.shape[1]), np.float32)])).to(
                    self.device)
        # speculative rounds (``steps`` counts the plain decode steps
        # only), verify forwards, drafted and accepted tokens (the
        # reference's paddle_generation_speculative_* counts)
        self.spec_rounds = 0
        self.verifies = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    # -- slot bookkeeping ------------------------------------------------
    def free_slots(self):
        return [int(i) for i in np.flatnonzero(~self.active)]

    def active_slots(self):
        return [int(i) for i in np.flatnonzero(self.active)]

    def capacity_left(self, slot):
        """Decode steps ``slot`` can still take before its cache or the
        position table runs out."""
        return int(self.max_pos - self.lengths[slot])

    def prompt_bucket(self, n):
        for p in self.spec.prompt_buckets:
            if n <= p:
                return p
        return None

    # -- paged-pool surface (trivial on the dense layout) ----------------
    def admit_ok(self, n_tokens):
        """Can an ``n_tokens``-history admission get storage now? Dense:
        always (the slot is the storage). Paged: enough free or
        evictable blocks for the whole history, plus one copy-on-write
        block when the prefix cache is on, capped at the pool size. The
        count does not depend on sharing: m matched blocks save m fresh
        ones but pin m entries that were evictable."""
        if not self.paged:
            return True
        need = -(-min(int(n_tokens), self.max_pos)
                 // self.spec.block_size)
        avail = self.pool.free_count()
        if self.prefix is not None:
            need = min(need + 1, self.pool.num_blocks)
            if avail < need:
                avail += self.prefix.evictable_count()
        return avail >= need

    def storable(self, n_tokens):
        """Could this session's storage ever hold an ``n_tokens``
        history? Dense: yes (``max_pos`` bounds it elsewhere); paged: the
        pool must have that many blocks in all."""
        if not self.paged:
            return True
        return -(-int(n_tokens) // self.spec.block_size) <= \
            self.pool.num_blocks

    def window_fits(self, history):
        """For a history that fits no prompt bucket whole: with the
        prefix cache on, does the window left after its cached prefix
        fit one? No side effects (``PrefixIndex.peek``); False on dense
        and prefix-off sessions."""
        if not self.paged or self.prefix is None:
            return False
        history = np.asarray(history, np.int64).reshape(-1)
        n = history.size
        if n < 1 or n > self.max_pos:
            return False
        matched = self.prefix.peek(history[:n - 1])
        return self.prompt_bucket(n - matched) is not None

    def pool_stats(self):
        """{blocks_in_use, num_blocks, block_size, bytes_per_block} of
        the paged layout (None on dense): a block's K and V rows in every
        layer, at the pools' element size. The sink block the pools
        carry is not counted."""
        if not self.paged:
            return None
        pool = self.model.caches[0][0]
        return {"blocks_in_use": self.pool.used_count(),
                "num_blocks": self.pool.num_blocks,
                "block_size": self.spec.block_size,
                "bytes_per_block": self.spec.block_size * pool.shape[2]
                * pool.element_size() * 2 * self.model.num_layers}

    def prefix_stats(self):
        """Prefix-cache counters (zeros when the cache is off)."""
        if self.prefix is None:
            return {"hits": 0, "misses": 0, "shared_tokens": 0,
                    "entries": 0, "cows": 0, "evictions": 0}
        return self.prefix.stats()

    def check_pool_invariant(self):
        """Assert the block-pool books balance against every live table
        and index pin. No-op on dense."""
        if self.paged:
            self.pool.check_invariant(self.tables, self.prefix)

    def _alloc_block(self):
        """One fresh block, evicting cold prefix entries (LRU, pin-only)
        under pressure before giving up."""
        while True:
            try:
                return self.pool.alloc()
            except PoolExhausted:
                if self.prefix is None or not self.prefix.evict_one():
                    raise

    def _release_table(self, slot):
        for block in self.tables[slot]:
            self.pool.decref(block)
        self.tables[slot] = []

    def _ensure_writable(self, table, idx):
        """Copy-on-write: if ``table[idx]`` is shared, copy it into a
        fresh block on the device (every layer's K and V pool) and swap
        that into the table. Raises PoolExhausted when no block is
        allocatable."""
        old = table[idx]
        if self.pool.refcount(old) <= 1:
            return
        new = self._alloc_block()
        try:
            self.model.copy_block(old, new)
        except BaseException:
            self.pool.decref(new)
            raise
        self.pool.decref(old)
        table[idx] = new
        # blocks are shared only through the prefix index, so it exists
        self.prefix.cows += 1

    def close(self):
        """Free the caches; the session must not be used after. Paged:
        every block reference (slot tables and prefix pins) returns to
        the pool first, and the books are checked to balance at zero. The
        draft closes with it."""
        if self.draft is not None:
            self.draft.close()
            self.draft = None
        if self.paged:
            for slot in range(self.spec.slots):
                self._release_table(slot)
            if self.prefix is not None:
                self.prefix.clear()
            self.check_pool_invariant()
            assert self.pool.used_count() == 0, \
                "closed session leaked %d blocks" % self.pool.used_count()
            self.paged = False
        self.model.release_cache()
        self.active[:] = False

    # -- decode-policy plumbing ------------------------------------------
    def _prefill_token(self, logits, n, seed, cstate):
        """The admission's first token under the policy, and the
        constraint state after it. ``n`` is the TOTAL history length, the
        sequence index of the token emitted (the counter of its key), so
        a replay prefilling prompt + journal draws with the key the
        original decode used at that position. Raises ValueError (from
        the constraint) when the token is illegal: a dead start state."""
        keys = mask = None
        if self.sampled:
            keys = decoding_key(torch.tensor([seed]), torch.tensor([n]))
        state = None
        if self.constrained:
            c = self.policy.constraint
            state = c.start if cstate is None else cstate
            mask = self._mask_rows[c.state_index(state)].reshape(1, -1)
        first = int(policy_epilogue(logits, self.policy, keys, mask)[0])
        if self.constrained:
            state = self.policy.constraint.advance(state, first)
        return first, state

    def _policy_admitted(self, slot, seed, state):
        self.seeds[slot] = int(seed)
        self.cstate[slot] = state

    def _draft_admit(self, prompt, slot, first):
        """Mirror an admission into the draft session (the same slot, by
        lockstep), then pin its pending token to the TARGET's emission:
        the draft guesses continuations of the target's trajectory, never
        its own."""
        if self.draft is None:
            return
        try:
            dslot, _ = self.draft.admit(prompt)
        except BaseException:
            self.retire(slot)
            raise
        if dslot != slot:
            self.retire(slot)
            raise RuntimeError(
                "draft session desynchronized: target slot %d, draft slot "
                "%d" % (slot, dslot))
        self.draft.last_token[slot] = int(first)

    def _decode_feed(self):
        """The decode step's policy inputs on the device: when sampling,
        each slot's key words ``decoding_key(seed, step)`` (step = length +
        1: a slot at length L emits the token at sequence index L + 1),
        derived on the host from the host's seeds and lengths, so only
        the [slots, 2] words cross; the [slots, V] mask rows of each
        active slot's constraint state (zeros elsewhere)."""
        dev = self.device
        keys = mask = None
        if self.sampled:
            keys = decoding_key(torch.from_numpy(self.seeds.copy()),
                                torch.from_numpy(self.lengths + 1)).to(dev)
        if self.constrained:
            c = self.policy.constraint
            zero = self._mask_rows.shape[0] - 1
            idx = np.full(self.spec.slots, zero, np.int64)
            for s in np.flatnonzero(self.active):
                state = self.cstate[int(s)]
                if state is not None:
                    idx[s] = c.state_index(state)
            mask = self._mask_rows[torch.from_numpy(idx).to(dev)]
        return keys, mask

    # -- execution -------------------------------------------------------
    def admit(self, prompt, seed=0, cstate=None):
        """Prefill ``prompt`` (1-D int ids) into a free slot and return
        ``(slot, first token)`` under the decode policy: ``seed`` keys a
        sampled draw, ``cstate`` is the constraint state to resume from
        (None: the start state). Raises RuntimeError when no slot is free
        and ValueError when the prompt fits no bucket.

        Paged: storage comes from the block pool through a fresh table;
        with the prefix cache on, the longest cached prefix is shared
        (its blocks referenced, not recomputed) and only the rest is
        prefilled, the match capped at len - 1 because the logits need
        the last prompt token's forward pass."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = prompt.size
        if n < 1:
            raise ValueError("empty prompt")
        if self.paged:
            return self._admit_paged(prompt, seed, cstate)
        bucket = self.prompt_bucket(n)
        if bucket is None:
            raise ValueError(
                "prompt length %d exceeds the largest prompt bucket %d"
                % (n, self.spec.prompt_buckets[-1]))
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free cache slot (%d active)"
                               % self.spec.slots)
        slot = free[0]
        padded = np.full((1, bucket), self.spec.eos_id, np.int64)
        padded[0, :n] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        logits = self.model.prefill(tokens, n, slot)
        first, state = self._prefill_token(logits, n, seed, cstate)
        self.prefills += 1
        self.lengths[slot] = n
        self.last_token[slot] = first
        self.active[slot] = True
        self._policy_admitted(slot, seed, state)
        self._draft_admit(prompt, slot, first)
        return slot, first

    def _admit_paged(self, prompt, seed=0, cstate=None):
        """Match the cached prefix, reference its blocks, allocate the
        rest, prefill only the unshared window, then register the
        prompt's blocks. Every reference taken here is returned if
        anything fails."""
        n = prompt.size
        bs = self.spec.block_size
        if n > self.max_pos:
            raise ValueError("prompt length %d exceeds the cache capacity "
                             "%d" % (n, self.max_pos))
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free cache slot (%d active)"
                               % self.spec.slots)
        slot = free[0]
        matched, shared = 0, []
        if self.prefix is not None:
            matched, shared = self.prefix.match(prompt[:n - 1])
        suffix = prompt[matched:]
        bucket = self.prompt_bucket(suffix.size)
        if bucket is None:
            raise ValueError(
                "prompt length %d (unshared suffix %d) exceeds the "
                "largest prompt bucket %d"
                % (n, suffix.size, self.spec.prompt_buckets[-1]))
        table = list(shared)
        for block in shared:
            self.pool.incref(block)
        w = suffix.size
        try:
            if matched % bs:
                # the shared prefix ends mid-block: the window writes
                # into that block, so diverge onto a copy first
                self._ensure_writable(table, len(table) - 1)
            while len(table) * bs < n:
                table.append(self._alloc_block())
            padded = np.full((1, bucket), self.spec.eos_id, np.int64)
            padded[0, :w] = suffix
            pix = np.clip(matched + np.arange(bucket), 0,
                          self.spec.max_len - 1)
            tab = np.full(self.spec.max_blocks, self.pool.num_blocks,
                          np.int32)
            tab[:len(table)] = table
            dev = self.device
            logits = self.model.prefill_paged(
                torch.from_numpy(padded).to(dev), w, matched,
                torch.from_numpy(pix).to(dev), torch.from_numpy(tab).to(dev))
            # the emitted token's index is the TOTAL length n (= matched +
            # w), prefix sharing included
            first, state = self._prefill_token(logits, n, seed, cstate)
        except BaseException:
            for block in table:
                self.pool.decref(block)
            raise
        if self.prefix is not None:
            self.prefix.register(prompt, table)
        self.tables[slot] = table
        self.prefills += 1
        self.lengths[slot] = n
        self.last_token[slot] = first
        self.active[slot] = True
        self._policy_admitted(slot, seed, state)
        self._starved.discard(slot)
        self.prefill_log.append((bucket, matched, w))
        if len(self.prefill_log) > 4096:
            del self.prefill_log[:2048]
        self._draft_admit(prompt, slot, first)
        return slot, first

    def step(self):
        """One decode step for EVERY active slot: each slot's pending
        token is embedded at its own position, its K/V row written in
        place, and its query attended against the slot's live cache
        rows. Returns {slot: next_token} for active slots (free slots
        compute masked garbage that the next prefill overwrites). Raises
        RuntimeError when an active slot is out of capacity.

        Paged: a slot whose next row needs a block the pool cannot give
        (even after evicting cold prefix entries) is left out of the
        result; it neither advances nor writes, and the caller finishes
        it at its current length.

        Speculative: a round emits a LIST per slot, the accepted drafts
        and the target's token after them (1 to k + 1 tokens); slots
        within k + 1 rows of their capacity make every slot take plain
        single-token steps until they retire."""
        prepared = self.step_prepare()
        if prepared is None:
            return {}
        return self.step_run(prepared)

    def step_prepare(self):
        """Phase 1 of a step, host only: the active-slot snapshot, the
        capacity check, every block-pool change (growth, copy-on-write)
        and the feeds. None when nothing is active."""
        act = np.flatnonzero(self.active)
        if act.size == 0:
            return None
        over = [int(s) for s in act if self.lengths[s] >= self.max_pos]
        if over:
            raise RuntimeError(
                "slots %s are at cache capacity %d — retire before "
                "stepping" % (over, self.max_pos))
        if self.speculative:
            w = self.policy.speculate_k + 1
            if all(self.capacity_left(int(s)) >= w for s in act):
                windows = self._prepare_spec(act)
                return _Prepared(True, act, frozenset(self._starved), None,
                                 None, None, None, windows)
            # near capacity: a window write would overrun the cache, so
            # plain single-token rounds finish these slots (speculation
            # resumes once they retire)
        table, starved = None, frozenset()
        if self.paged:
            table = self._prepare_paged(act)
            starved = frozenset(self._starved)
        return _Prepared(False, act, starved,
                         self.last_token.reshape(-1, 1).copy(),
                         self.lengths.astype(np.int32), table,
                         self._decode_feed(), None)

    def _prepare_paged(self, act):
        """Grow or copy-on-write each active slot's write block and
        build the [slots, max_blocks] table feed. Inactive and starved
        slots get all-dead rows (entries = num_blocks), so their device
        writes drop."""
        bs = self.spec.block_size
        self._starved.clear()   # a retire may have freed blocks since
        for s in act:
            s = int(s)
            pos = int(self.lengths[s])
            tbl = self.tables[s]
            try:
                if pos // bs == len(tbl):
                    tbl.append(self._alloc_block())
                else:
                    self._ensure_writable(tbl, pos // bs)
            except PoolExhausted:
                self._starved.add(s)
        tab = np.full((self.spec.slots, self.spec.max_blocks),
                      self.pool.num_blocks, np.int32)
        for s in act:
            s = int(s)
            if s not in self._starved:
                tab[s, :len(self.tables[s])] = self.tables[s]
        return tab

    def _prepare_spec(self, act):
        """Speculative phase 1: extend each active slot's block table to
        cover the verify window's rows [L, L + W), copying on write the
        shared blocks the window writes into. A slot the pool cannot
        cover sits the round out (starved), its growth of this round
        handed back. Returns {slot: (L, table row)} of the slots that
        speculate."""
        bs = self.spec.block_size
        w = self.policy.speculate_k + 1
        self._starved.clear()
        info = {}
        for s in act:
            s = int(s)
            length = int(self.lengths[s])
            tbl = self.tables[s]
            held = len(tbl)
            need = (length + w - 1) // bs + 1
            try:
                for bi in range(length // bs, min(held, need)):
                    self._ensure_writable(tbl, bi)
                while len(tbl) < need:
                    tbl.append(self._alloc_block())
            except PoolExhausted:
                self.pool.truncate_table(tbl, held)
                self._starved.add(s)
                continue
            tab = np.full(self.spec.max_blocks, self.pool.num_blocks,
                          np.int32)
            tab[:len(tbl)] = tbl
            info[s] = (length, tab)
        return info

    def step_run(self, prepared):
        """Phase 2: the device step and the result's application."""
        if prepared.speculative:
            return self._step_run_spec(prepared)
        act, starved, table = prepared.act, prepared.starved, prepared.table
        tokens, pos = prepared.tokens, prepared.pos
        keys, mask = prepared.feed
        dev = self.device
        logits = self.model.decode(
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            None if table is None else torch.from_numpy(table).to(dev))
        nxt = policy_epilogue(logits, self.policy, keys, mask).cpu().numpy()
        self.steps += 1
        result = {}
        for s in act:
            s = int(s)
            if s in starved:
                continue
            self.lengths[s] += 1
            self.last_token[s] = int(nxt[s])
            result[s] = int(nxt[s])
            if self.constrained:
                self.cstate[s] = self.policy.constraint.advance(
                    self.cstate[s], int(nxt[s]))
        if self.draft is not None and result:
            self._draft_mirror_plain(result)
        return result

    def _draft_mirror_plain(self, result):
        """A plain round of a speculative session (the near-capacity
        fallback): the draft appends the pending token's K/V row too, so
        it steps once, its own token dropped, and its pending token is
        pinned to the target's."""
        self.draft.step()
        for s in self.draft.active_slots():
            if s in result:
                self.draft.last_token[s] = result[s]
            else:
                # the target starved this slot while the draft advanced:
                # mirror the target's unchanged state back
                self.draft.lengths[s] = int(self.lengths[s])
                self.draft.last_token[s] = int(self.last_token[s])

    def _step_run_spec(self, prepared):
        """Speculative phase 2: k + 1 batched greedy draft steps, then one
        verify forward per speculating slot re-deciding the window with
        the TARGET's policy and keys, the emission of the accepted prefix
        and the target's next token, and the rollback of the window rows
        past it (blocks returned to the pool; the draft's length cut).
        Returns {slot: [token, ...]}."""
        info = prepared.windows
        starved = prepared.starved
        k = self.policy.speculate_k
        w = k + 1
        bs = self.spec.block_size
        dev = self.device
        pol = self.policy
        # starved slots sit the round out on the target, but the batched
        # draft advances them anyway: put them back after
        restore = {s: (int(self.draft.lengths[s]),
                       int(self.draft.last_token[s])) for s in starved}
        # k proposals a slot, and one more step so the draft's cache holds
        # a row for every window position a full accept confirms
        drafts = {s: [] for s in info}
        for i in range(w):
            out = self.draft.step()
            if i < k:
                for s in drafts:
                    drafts[s].append(out[s])
        result = {}
        for s, (length, tab) in sorted(info.items()):
            window = np.empty((1, w), np.int64)
            window[0, 0] = self.last_token[s]
            window[0, 1:] = drafts[s]
            pix = np.clip(length + np.arange(w), 0, self.spec.max_len - 1)
            win = torch.from_numpy(window).to(dev)
            logits = self.model.verify_paged(
                win, length, torch.from_numpy(pix).to(dev),
                torch.from_numpy(tab).to(dev))
            toks, accept = decode_verify(
                logits, win[0], self.seeds[s], length, kind=pol.kind,
                temperature=pol.temperature, top_k=pol.top_k,
                top_p=pol.top_p)
            self.verifies += 1
            self.spec_drafted += k
            self.spec_accepted += accept
            emitted = [int(t) for t in toks[:accept + 1].cpu()]
            new_len = length + accept + 1
            self.lengths[s] = new_len
            self.last_token[s] = emitted[-1]
            # window rows past the confirmed prefix: blocks beyond the new
            # length go back to the pool (prepare diverged every shared
            # block the window wrote); rows left in a kept block lie past
            # the length and are overwritten by later writes
            self.pool.truncate_table(self.tables[s],
                                     (new_len - 1) // bs + 1)
            # the draft's rows sit at fixed positions: rollback is a
            # length cut
            self.draft.lengths[s] = new_len
            self.draft.last_token[s] = emitted[-1]
            result[s] = emitted
        for s, (dl, dt) in restore.items():
            self.draft.lengths[s] = dl
            self.draft.last_token[s] = dt
        self.spec_rounds += 1
        return result

    def retire(self, slot):
        """Free a slot mid-flight. Dense: its cache rows stay as they
        are, the next prefill into the slot overwrites them and the
        per-slot length keeps them unattended meanwhile. Paged: every
        block reference of its table returns to the pool (a block the
        prefix index pins survives as cached prompt state)."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self.last_token[slot] = 0
        self.seeds[slot] = 0
        self.cstate[slot] = None
        if self.draft is not None:
            self.draft.retire(slot)
        if self.paged:
            self._release_table(slot)
            self._starved.discard(slot)

    def generate(self, prompt, max_new_tokens=None, eos_id=None, seed=0):
        """Synchronous single-sequence convenience: the policy's
        continuation of ``prompt`` (greedy by default, ``seed`` keying a
        sampled one), stopping at ``eos_id``, ``max_new_tokens`` or an
        exhausted paged pool, as a list of ids (EOS excluded)."""
        eos = self.spec.eos_id if eos_id is None else eos_id
        slot, first = self.admit(prompt, seed=seed)
        # prefill produced one token; each step writes one more K/V
        # row, so capacity + 1 tokens fit the slot
        cap = self.capacity_left(slot)
        limit = cap + 1 if max_new_tokens is None \
            else min(int(max_new_tokens), cap + 1)
        tokens = [first]
        try:
            while tokens[-1] != eos and len(tokens) < limit:
                nxt = self.step()
                if slot not in nxt:
                    break   # paged pool exhausted: finish at length
                got = nxt[slot]
                # a speculative round emits a list: the tokens past EOS or
                # the budget are dropped (the round could not know the
                # sequence would end inside its window)
                for t in (got if isinstance(got, list) else [got]):
                    tokens.append(t)
                    if t == eos or len(tokens) >= limit:
                        break
        finally:
            self.retire(slot)
        if tokens[-1] == eos:
            tokens = tokens[:-1]
        return tokens


_STOP = object()


class _GenRequest:
    __slots__ = ("prompt", "max_new", "explicit_budget", "eos_id",
                 "future", "deadline", "tokens", "slot", "session_index",
                 "seed")

    def __init__(self, prompt, max_new, explicit_budget, eos_id, deadline,
                 seed=0):
        self.prompt = prompt
        # the request's decode seed, minted once at the front door: with
        # the prompt + tokens journal it makes a sampled stream as
        # replayable as a greedy one
        self.seed = seed
        self.max_new = max_new
        # True when the caller asked for max_new tokens: placement must
        # find a session able to serve them all
        self.explicit_budget = explicit_budget
        self.eos_id = eos_id  # None until placement picks a session
        self.future = Future()
        self.deadline = deadline  # absolute time.monotonic() or None
        self.tokens = []
        self.slot = None
        self.session_index = None

    def history(self):
        """The journal: the prompt and every token generated so far."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int64)])


class GenerationScheduler:
    """Continuous-batching front door over one or more
    :class:`GenerationSession` replicas.

    ``submit(prompt) -> Future`` resolves to the generated ids as an
    int64 array (the sessions' decode policy, EOS excluded). The
    dispatcher
    thread admits queued requests into free cache slots (prefill) and
    runs one decode step for every session with active slots, over and
    over; sequences retire slot by slot.

    ``deadline_ms`` (default: the ``serving_deadline_ms`` flag; 0 =
    none) bounds a whole generation: a request whose deadline passes in
    the queue or mid-generation resolves with
    :class:`ServingDeadlineError`. A session whose step or admission
    raises fails the requests it holds with that exception.

    Every session must have the same decode-policy fingerprint (a
    journal resumes bit for bit only where the next-token decisions are
    the same); ``policy_fingerprint()`` reports it. A constrained request
    whose automaton reaches a state with no legal token resolves with
    :class:`~.decoding.ConstraintDeadEnd` (a ValueError: the client's).
    """

    def __init__(self, sessions, max_queue=256, deadline_ms=None,
                 autostart=True):
        if isinstance(sessions, GenerationSession):
            sessions = [sessions]
        if not sessions:
            raise ValueError("need at least one GenerationSession")
        self.sessions = list(sessions)
        fps = {(s.policy.fingerprint() if s.policy is not None
                else GREEDY_FINGERPRINT) for s in self.sessions}
        if len(fps) > 1:
            raise ValueError(
                "sessions disagree on decode policy (%s): a replay journal "
                "is only re-drivable across sessions that make identical "
                "next-token decisions" % sorted(fps))
        self._policy_fp = fps.pop()
        self._sampled = any(s.sampled for s in self.sessions)
        self._q = queue.Queue(maxsize=max_queue)
        # dispatcher-local, order-preserving: requests parked while no
        # slot is free (consumed before the queue)
        self._pending = collections.deque()
        self._active = {}   # (session_index, slot) -> _GenRequest
        self._closed = False
        self._thread = None
        if deadline_ms is None:
            deadline_ms = _config.get_flag("serving_deadline_ms")
        self.default_deadline_ms = deadline_ms
        if autostart:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._closed:
            raise RuntimeError("scheduler is closed")
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="generation-scheduler",
                                            daemon=True)
            self._thread.start()
        return self

    def policy_fingerprint(self):
        """The decode-policy fingerprint every session here shares
        (``"greedy"`` with no policy)."""
        return self._policy_fp

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, timeout=None, seed=None):
        """Enqueue one prompt; returns a Future of its generated ids.

        ``max_new_tokens`` is capped by the slot capacity left after the
        prompt. ``deadline_ms`` (default: the scheduler's) bounds the
        WHOLE generation. ``timeout``: seconds to wait on a full queue
        before :class:`ServingOverloadError`. ``seed`` keys a sampled
        policy's draws; None mints one (``mint_seed``) when the sessions
        sample, 0 otherwise."""
        if self._closed:
            raise RuntimeError("scheduler is closed")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        # a session fits when a prompt bucket does, or (paged, prefix
        # cache on) when a cached prefix may shrink the prefill window
        # into one: placement decides that on the dispatcher thread,
        # which owns the prefix index
        fitting = [s for s in self.sessions
                   if s.prompt_bucket(prompt.size) is not None
                   or (s.prefix is not None and prompt.size <= s.max_pos)]
        if not fitting:
            raise ValueError(
                "prompt length %d exceeds every session's largest prompt "
                "bucket (max %d)" % (prompt.size, max(
                    s.spec.prompt_buckets[-1] for s in self.sessions)))
        cap = max(s.max_pos for s in fitting) - prompt.size + 1
        if cap < 1:
            raise ValueError("prompt length %d leaves no decode capacity "
                             "in any session's cache" % prompt.size)
        explicit = max_new_tokens is not None
        max_new = cap if not explicit else min(int(max_new_tokens), cap)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = None
        if deadline_ms:
            if float(deadline_ms) < 0:
                raise ServingDeadlineError(
                    "deadline budget %.1f ms already spent"
                    % float(deadline_ms))
            deadline = time.monotonic() + float(deadline_ms) / 1e3
        if seed is None:
            seed = mint_seed() if self._sampled else 0
        item = _GenRequest(prompt, max_new, explicit, eos_id, deadline,
                           seed=int(seed))
        try:
            self._q.put(item, block=True, timeout=timeout)
        except queue.Full:
            raise ServingOverloadError(
                "generation queue full (%d pending)"
                % self._q.qsize()) from None
        if self._closed and self._thread is None:
            # raced a close()/drain() past its leftover sweep
            _resolve(item.future,
                     exception=RuntimeError("scheduler closed"))
            raise RuntimeError("scheduler is closed")
        return item.future

    # -- dispatcher ------------------------------------------------------
    def _next_item(self, block):
        if self._pending:
            return self._pending.popleft()
        try:
            if block:
                return self._q.get(timeout=0.05)
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def _fits(self, sess, item):
        """Can ``sess`` serve this request in full: cache capacity and
        pool storage for an explicit token budget, and a prompt bucket
        for the whole prompt or, with a paged prefix cache, for the
        window left once the cached prefix is subtracted
        (``window_fits``, no side effects)?"""
        n = item.prompt.size
        need = item.max_new if item.explicit_budget else 1
        if sess.max_pos - n + 1 < need or not sess.storable(n + need - 1):
            return False
        return sess.prompt_bucket(n) is not None or \
            sess.window_fits(item.prompt)

    def _place(self, item):
        """Admit ``item``, park it, or resolve it. Returns False when it
        was parked (no free slot, or a paged pool short of blocks, now:
        stop pulling from the queue)."""
        if item.deadline is not None and time.monotonic() >= item.deadline:
            _resolve(item.future, exception=ServingDeadlineError(
                "deadline expired in queue"))
            return True
        fitting = [i for i, s in enumerate(self.sessions)
                   if self._fits(s, item)]
        if not fitting:
            _resolve(item.future, exception=ServingUnavailableError(
                "no generation session can serve this request"))
            return True
        free = [i for i in fitting if self.sessions[i].free_slots()
                and self.sessions[i].admit_ok(item.prompt.size)]
        if not free:
            self._pending.appendleft(item)
            return False
        self._admit_item(item, free[0])
        return True

    def _admit_item(self, item, si):
        sess = self.sessions[si]
        try:
            cstate = None
            if sess.constrained:
                # the automaton state is journal-derived, as the cache is
                c = sess.policy.constraint
                cstate = c.advance_many(c.start, item.tokens)
            slot, first = sess.admit(item.history(), seed=item.seed,
                                     cstate=cstate)
        except Exception as exc:  # noqa: BLE001 — the request's outcome
            _resolve(item.future, exception=exc)
            return
        if item.eos_id is None:
            item.eos_id = sess.spec.eos_id
        item.slot = slot
        item.session_index = si
        item.tokens.append(first)
        self._active[(si, slot)] = item
        # EOS or the budget can end it at its first token; a constrained
        # request may already stand in a dead state
        if not self._finish_if_done(item):
            self._check_dead_end(sess, item)

    def _check_dead_end(self, sess, item):
        """A constrained request whose last token advanced its automaton
        into a state that bans every next token resolves with
        ConstraintDeadEnd, a client error, and leaves its slot: never a
        hang. Returns True when it left."""
        if not sess.constrained:
            return False
        key = (item.session_index, item.slot)
        if key not in self._active:
            return False
        state = sess.cstate[item.slot]
        if not sess.policy.constraint.dead(state):
            return False
        sess.retire(item.slot)
        del self._active[key]
        _resolve(item.future, exception=ConstraintDeadEnd(
            state, len(item.tokens)))
        return True

    def _finish_if_done(self, item):
        """Retire and resolve on EOS, budget, capacity or deadline."""
        sess = self.sessions[item.session_index]
        reason = None
        if item.tokens[-1] == item.eos_id:
            item.tokens.pop()
            reason = "eos"
        elif len(item.tokens) >= item.max_new:
            reason = "max_tokens"
        elif sess.capacity_left(item.slot) <= 0:
            reason = "capacity"
        elif item.deadline is not None and \
                time.monotonic() >= item.deadline:
            reason = "deadline"
        if reason is None:
            return False
        sess.retire(item.slot)
        del self._active[(item.session_index, item.slot)]
        if reason == "deadline":
            _resolve(item.future, exception=ServingDeadlineError(
                "deadline expired mid-generation after %d tokens"
                % len(item.tokens)))
        else:
            _resolve(item.future,
                     result=np.asarray(item.tokens, np.int64))
        return True

    def _step_all(self):
        for si, sess in enumerate(self.sessions):
            mine = [(slot, it) for (s_i, slot), it
                    in list(self._active.items()) if s_i == si]
            if not mine:
                continue
            try:
                toks = sess.step()
            except Exception as exc:  # noqa: BLE001 — fail its requests
                for slot, it in mine:
                    sess.retire(slot)
                    del self._active[(si, slot)]
                    _resolve(it.future, exception=exc)
                continue
            for slot, it in mine:
                if slot not in toks:
                    # a paged pool had no block for this sequence's next
                    # row: it finishes at its current length (reason
                    # "capacity"; there is no replay to resume it)
                    sess.retire(slot)
                    del self._active[(si, slot)]
                    _resolve(it.future,
                             result=np.asarray(it.tokens, np.int64))
                    continue
                got = toks[slot]
                # a speculative round emits a list: the accepted drafts
                # and the target's next token; plain rounds one int
                for tok in (got if isinstance(got, list) else [got]):
                    it.tokens.append(tok)
                    if self._finish_if_done(it) or \
                            self._check_dead_end(sess, it):
                        # EOS, budget or dead end inside the window: the
                        # rest of the list is dropped, the slot retired
                        break

    def _fill_slots(self):
        """Admit waiting requests into free slots without blocking.
        Returns True when the stop marker was consumed."""
        while True:
            item = self._next_item(block=False)
            if item is None:
                return False
            if item is _STOP:
                return True
            if not self._place(item):
                return False

    def _serve_out(self):
        """After the stop marker: finish every active slot and serve
        everything still waiting, co-batched like live traffic."""
        while True:
            if self._active:
                self._fill_slots()
                self._step_all()
                continue
            item = self._next_item(block=False)
            if item is None:
                return
            if item is not _STOP and not self._place(item):
                # no free slot with nothing in flight here (slots held
                # outside this scheduler): nothing will free one
                self._fail_parked("scheduler stopped before the request "
                                  "could be placed")

    def _loop(self):
        try:
            while True:
                if self._active:
                    got_stop = self._fill_slots()
                    self._step_all()
                    if got_stop:
                        self._serve_out()
                        return
                    continue
                item = self._next_item(block=True)
                if item is None:
                    if self._closed:
                        return
                    continue
                if item is _STOP:
                    self._serve_out()
                    return
                if not self._place(item):
                    # parked with nothing active: every fitting slot is
                    # held outside this scheduler; back off
                    time.sleep(0.02)
        except BaseException as exc:
            # the dispatcher is dying: nothing would resolve these
            for it in list(self._active.values()) + list(self._pending):
                _resolve(it.future, exception=exc)
            self._active.clear()
            self._pending.clear()
            raise

    # -- shutdown --------------------------------------------------------
    def _stop_dispatcher(self, timeout):
        self._closed = True
        if self._thread is not None:
            try:
                self._q.put_nowait(_STOP)
            except queue.Full:
                pass
            self._thread.join(timeout)
            if self._thread.is_alive():
                # still serving past the bounded wait: it owns the
                # queues and exits on its own once everything is served
                return []
            self._thread = None
        leftovers = [it for it in self._pending if it is not _STOP]
        self._pending.clear()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        return leftovers

    def drain(self, timeout=None):
        """Stop admission, generate every accepted request to
        completion, then stop. Every accepted Future resolves."""
        leftovers = self._stop_dispatcher(timeout)
        if self._thread is not None:
            return
        # no dispatcher ran: serve the remainder on this thread
        self._pending.extend(leftovers)
        while self._pending or self._active:
            while self._pending:
                if not self._place(self._pending.popleft()):
                    break
            if self._active:
                self._step_all()
            elif self._pending:
                self._fail_parked("drain: no session could take the "
                                  "request")

    def _fail_parked(self, why):
        parked = self._pending.popleft()
        _resolve(parked.future, exception=ServingUnavailableError(why))

    def close(self, timeout=5.0):
        """Fast exit: a live dispatcher serves out what it owns (active
        slots and accepted submits) before exiting; with no dispatcher
        running, queued requests fail."""
        for item in self._stop_dispatcher(timeout):
            _resolve(item.future, exception=RuntimeError("scheduler closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
