"""Autoregressive generation serving: KV-cache sessions and a
continuous-batching scheduler with the reference's recovery vocabulary
(reference ``paddle_tpu/serving/generation.py``).

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
  times out on it, or when the queue-wait EWMA says a deadline budget
  is already hopeless), one dispatcher thread that admits waiting
  requests into free slots and steps every session with active slots,
  and slot-level retirement on EOS, token budget, cache capacity or
  deadline. ``drain()`` serves everything accepted, then stops;
  ``close()`` is the bounded fast exit; ``swap_weights()`` installs new
  parameter values between decode steps.

Stateful failure recovery. A session's KV cache is derived state: each
request's host-side prompt + tokens list is a complete, deterministic
replay journal, and with its seed (and the constraint state folded
through it) it re-derives a sampled or constrained stream too.

* **Breakers** (``breaker_failures`` / ``serving_breaker_failures``): a
  :class:`~.resilience.ReplicaBreaker` per session quarantines a failing
  session out of admission; a cooldown-gated trial admission re-admits
  it.
* **Token replay** (``replay_attempts`` / ``generation_replay_attempts``):
  when a session's step or admission fails, its requests re-queue
  head-of-line carrying their journal and re-prefill ``prompt + tokens``
  into a healthy session (a larger prompt bucket when the history
  outgrew the first). Replays are bounded per request, the deadline is
  unchanged across them, and a poison request charges at most one
  breaker. With replay armed, a paged sequence the pool starves is
  preempted and replayed instead of finishing early.
* **Session rebuild** (``rebuild_limit`` / ``generation_rebuild_limit``):
  a quarantined session whose trials keep failing, or that wedged, is
  rebuilt on a background thread: ``spec.rebuild()``, a new session
  over the same weights by reference (``share=True``: no copy, no
  re-arming), every prompt bucket and the decode step warmed, then
  swapped into placement on the dispatcher thread.
* **Step timeouts** (``step_timeout_ms`` /
  ``generation_step_timeout_ms``): each session's step runs on that
  session's one long-lived worker thread, bounded by the timeout; a hang
  is a failure (the requests replay elsewhere, the breaker opens at
  once) and the wedged session sits out until its worker returns.
  Refused on speculative sessions, whose round mutates the block pool
  in its phase 2.

In the port a rebuild recovers what the reference's rebuild recovers
while the device is still usable: a failed or hung Python-level step.
A real CUDA fault (an illegal address) poisons the process's CUDA
context, and no in-process rebuild recovers from that.

With the replay, rebuild and timeout flags at their defaults the
dispatcher loop reads no flag (they are read at construction), starts
no worker thread, and a failure resolves its requests exceptionally.

Metrics (always on, the reference's names): ``paddle_generation_
requests_total``, ``_tokens_total``, ``_prefills_total{bucket}``,
``_decode_steps_total``, ``_retired_total{reason}``,
``_slot_occupancy{scheduler}``, ``_ttft_seconds``,
``_inter_token_seconds``, ``_request_seconds``; recovery:
``_failover_total``, ``_replayed_tokens_total``,
``_session_rebuilds_total``, ``_step_timeouts_total``,
``_failover_recovery_seconds``; speculation: ``_speculative_drafted_total``,
``_speculative_accepted_total``. Spans ``generationPrefill``,
``generationStep`` and ``generationVerify``. Fault sites
``generation_step_fail``, ``generation_admit_fail`` and
``generation_session_wedge`` (by session), ``decode_draft_mismatch`` and
``decode_constraint_dead_end`` (by slot).

Threads: the dispatcher thread is the only caller of its sessions' host
bookkeeping and the only thread that touches a block pool; a timed step
runs only its device call and per-slot scalar updates on the session's
worker (``step_prepare`` / ``step_run``). A rebuild's warm-up launches
kernels from its own thread, on the new session only. Tokens are the
only thing read back to the host, once per prefill and once per step.
"""

import collections
import itertools
import queue
import threading
import time
import weakref
from collections.abc import Mapping
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import torch

from .. import config as _config
from .. import io as _io
from ..amp import flag_dtype
from ..core.executor import Executor
from ..core.scope import global_scope
from ..models.transformer import (kv_dtype, lm_mul_weight_names,
                                  policy_epilogue)
from ..observability import flight as _flight
from ..observability import health as _health
from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..observability import tracing as _tracing
from ..ops import quant_ops as _quant_ops
from ..ops.decoding_ops import decode_verify
from ..ops.random_ops import decoding_key
from ..resilience import faults as _faults
from ..utils import log as _log
from . import quant as _quant
from . import resilience as _sres
from .batcher import _WAIT_ALPHA, ServingOverloadError, _resolve
from .decoding import ConstraintDeadEnd, mint_seed
from .decoding.policy import GREEDY_FINGERPRINT
from .paged_cache import (BLOCK_COWS, SPEC_ROLLBACKS, BlockPool,
                          PoolExhausted, PrefixIndex)
from .resilience import (ReplicaBreaker, ServingDeadlineError,
                         ServingUnavailableError)

__all__ = ["GenerationSpec", "GenerationSession", "GenerationScheduler",
           "ServingOverloadError", "ServingDeadlineError",
           "ServingUnavailableError"]

_REQUESTS = _metrics.REGISTRY.counter(
    "paddle_generation_requests_total",
    "Generation requests admitted into a cache slot")
_TOKENS = _metrics.REGISTRY.counter(
    "paddle_generation_tokens_total",
    "Tokens decoded across all sequences (prefill's first token "
    "included)")
_PREFILLS = _metrics.REGISTRY.counter(
    "paddle_generation_prefills_total",
    "Prompt prefills executed, per prompt bucket",
    labelnames=("bucket",))
_STEPS = _metrics.REGISTRY.counter(
    "paddle_generation_decode_steps_total",
    "Decode steps executed (one per session step, all slots at once)")
_RETIRED = _metrics.REGISTRY.counter(
    "paddle_generation_retired_total",
    "Sequences retired from their slot", labelnames=("reason",))
_OCCUPANCY = _metrics.REGISTRY.gauge(
    "paddle_generation_slot_occupancy",
    "Active sequences / total cache slots across one scheduler's "
    "sessions (labelled per scheduler — two engines side by side "
    "must not overwrite each other)", labelnames=("scheduler",))
_TTFT_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_generation_ttft_seconds",
    "Submit -> first token latency (queue wait + prefill)")
_INTER_TOKEN_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_generation_inter_token_seconds",
    "Per-sequence latency between consecutive tokens")
_REQUEST_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_generation_request_seconds",
    "Submit -> Future resolution for completed generations")
_FAILOVERS = _metrics.REGISTRY.counter(
    "paddle_generation_failover_total",
    "Requests re-queued for token-replay after their session failed "
    "(each re-admits into a healthy session, output unchanged)")
_REPLAYED_TOKENS = _metrics.REGISTRY.counter(
    "paddle_generation_replayed_tokens_total",
    "Already-generated tokens re-prefilled by replay re-admissions")
_REBUILDS = _metrics.REGISTRY.counter(
    "paddle_generation_session_rebuilds_total",
    "Quarantined sessions torn down and reconstructed (fresh cache "
    "namespace, warmed) back into placement")
_STEP_TIMEOUTS = _metrics.REGISTRY.counter(
    "paddle_generation_step_timeouts_total",
    "Decode steps that exceeded generation_step_timeout_ms (session "
    "quarantined with its worker thread leaked-and-capped)")
_RECOVERY_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_generation_failover_recovery_seconds",
    "Session failure -> the replayed request decoding again on a "
    "healthy session (re-queue wait + replay prefill)")
_SPEC_DRAFTED = _metrics.REGISTRY.counter(
    "paddle_generation_speculative_drafted_total",
    "Draft tokens proposed by speculative-decoding rounds")
_SPEC_ACCEPTED = _metrics.REGISTRY.counter(
    "paddle_generation_speculative_accepted_total",
    "Draft tokens accepted by the target's verify pass (the ratio to "
    "_drafted_total is the speculative accept rate)")

# a step's phase 1 for its phase 2: the active slots and the starved
# ones, then either the plain step's feeds (tokens, positions, table rows,
# the policy's keys and mask) or, when ``speculative``, each speculating
# slot's (length, table row) in ``windows``
_Prepared = collections.namedtuple(
    "_Prepared", "speculative act starved tokens pos table feed windows")


class GenerationSpec:
    """The contract between a model's session builder (e.g.
    ``models.transformer.transformer_lm_session``) and the session:
    shapes, token ids, the device, the cache layout and its dtype name
    (``dtype``, "float32" or "bfloat16"), and one field set per route.

    * The program route (the reference's fields): ``prefill_programs``
      ({prompt bucket: Program}), ``decode_program``, ``copy_program``
      (paged) and ``verify_program`` (speculative), each with its feed
      names (``prefill_feeds``, ``decode_feeds``, ``copy_feeds``,
      ``verify_feeds``) and fetch names (``prefill_fetch``,
      ``decode_fetch``, ``verify_fetch``).
    * The ``nn.Module`` route: ``build_model(params)``, which returns a
      module with ``allocate_cache``, ``prefill`` and ``decode`` (dense)
      and ``allocate_pools``, ``prefill_paged``, ``decode(..., table)``
      and ``copy_block`` (paged), and ``verify_paged`` (speculative).

    The paged fields default to the dense layout; the decode-policy
    fields (``vocab_size``, ``policy``: a ``DecodePolicy`` or None for
    greedy, ``draft_spec``: the speculative draft's spec) to greedy.

    ``cache_vars`` names the session's cache variables as the reference
    declares them, ((name, shape, dtype name), ...) under one namespace
    per spec: a program session materializes them in its scope (a paged
    pool with one sink block past its declared shape), and
    ``swap_weights`` refuses those names. ``rebuild`` (optional) is a
    zero-arg factory of an equivalent spec under a new namespace, what a
    session rebuild constructs the replacement from; ``bos_id`` is the
    token its warm-up prompts are made of."""

    __slots__ = ("slots", "cache_len", "max_len", "prompt_buckets",
                 "bos_id", "eos_id", "device", "build_model", "dtype",
                 "paged", "block_size", "num_blocks", "max_blocks",
                 "prefix_cache", "vocab_size", "policy", "draft_spec",
                 "cache_vars", "rebuild", "prefill_programs",
                 "prefill_feeds", "prefill_fetch", "decode_program",
                 "decode_feeds", "decode_fetch", "copy_program",
                 "copy_feeds", "verify_program", "verify_feeds",
                 "verify_fetch")
    _DEFAULTS = {"bos_id": 0, "device": None, "build_model": None,
                 "dtype": "float32", "paged": False, "block_size": 0,
                 "num_blocks": 0, "max_blocks": 0, "prefix_cache": False,
                 "vocab_size": 0, "policy": None, "draft_spec": None,
                 "cache_vars": (), "rebuild": None,
                 "prefill_programs": None, "prefill_feeds": None,
                 "prefill_fetch": None, "decode_program": None,
                 "decode_feeds": None, "decode_fetch": None,
                 "copy_program": None, "copy_feeds": None,
                 "verify_program": None, "verify_feeds": None,
                 "verify_fetch": None}

    def __init__(self, **kwargs):
        for name, value in self._DEFAULTS.items():
            kwargs.setdefault(name, value)
        for name in self.__slots__:
            setattr(self, name, kwargs.pop(name))
        if kwargs:
            raise TypeError("unknown GenerationSpec fields: %s"
                            % sorted(kwargs))


# scope -> the cache-variable names a live program session drives on it:
# two sessions writing one cache would corrupt each other's rows, so a
# second claim of a name is refused (the reference's rule)
_CACHE_CLAIMS = weakref.WeakKeyDictionary()


class GenerationSession:
    """One decode batch of ``spec.slots`` cache slots. Methods are
    single-threaded by contract: the scheduler's dispatcher thread is the
    only caller in a serving deployment.

    Two routes, by the second argument, over the same host side (slots,
    block pool, prefix index, decode policies, the draft):

    * A ``Scope``, or None for ``core.global_scope()`` (the reference's
      signature ``(spec, scope=None, place=None, draft_scope=None,
      arm_quant=None)``): the spec's programs, run by a
      ``core.Executor`` on ``place`` (default: the spec's device) over
      the scope's parameters. The session materializes ``cache_vars`` in
      the scope as device zeros, which the cache ops write in place, and
      refuses a cache name another live session on the scope claims;
      ``close()`` releases them. ``compile_stats()`` is the executor's.
    * A mapping ``{reference parameter name: tensor}``: the ``nn.Module``
      route, over the model ``spec.build_model`` builds from it (copied,
      or with ``share`` taken by reference: another model's
      ``reference_state()``, the self-draft's way and a rebuild's).

    ``arm_quant`` (default: the ``serving_quant_compute`` flag, read
    here only) quantizes the mul weights to int8 in place
    (``serving/quant.py``): the scope's, with the programs tagged, or
    the model's; their products then run through kernel B3.
    ``_quant_armed`` lists the armed reference names; no float32 copy
    of an armed weight is kept.

    A speculative spec gets ``self.draft``, a dense greedy session over
    ``spec.draft_spec`` that mirrors this one slot for slot. On the
    program route it runs over this scope (the self-draft shares its
    parameters by name, and its programs are armed in this session's
    arming call) unless ``draft_scope`` gives it its own. On the module
    route, without ``draft_params`` it shares this model's tensors by
    reference name and is armed in the same call; with ``draft_params``
    (a draft of other widths) it holds its own weights and arms itself."""

    def __init__(self, spec, scope=None, place=None, draft_scope=None,
                 arm_quant=None, draft_params=None, share=False):
        # the amp flag is read at each build and each run, as the
        # reference's executor reads it; generation under amp is not
        # ported (the model's prefill and decode refuse it too)
        if flag_dtype() is not None:
            raise NotImplementedError(
                "KV-cached generation under amp is not ported: turn the "
                "amp flag off to build a session")
        self.spec = spec
        if arm_quant is None:
            arm_quant = bool(_config.get_flag("serving_quant_compute"))
        policy = spec.policy
        self.policy = policy
        self.sampled = policy is not None and policy.sampled
        self.constrained = policy is not None and \
            policy.constraint is not None
        self.speculative = policy is not None and policy.speculate_k > 0
        self.draft = None
        self.exe = self.scope = self.model = None
        self._quant_armed = []
        n = spec.slots
        self.paged = bool(spec.paged)
        if isinstance(scope, Mapping):
            if place is not None or draft_scope is not None:
                raise TypeError("place and draft_scope take the program "
                                "route: pass a Scope, not parameters")
            self._init_module(scope, arm_quant, draft_params, share)
        else:
            if draft_params is not None or share:
                raise TypeError("draft_params and share take the "
                                "nn.Module route: pass parameters, not a "
                                "Scope")
            self._init_programs(scope, place, draft_scope, arm_quant)
        self.lengths = np.zeros(n, np.int64)     # cached rows per slot
        self.last_token = np.zeros(n, np.int64)  # next token to decode
        self.active = np.zeros(n, bool)
        # the deepest position any sequence may WRITE: bounded by the
        # cache and by the learned position table
        self.max_pos = min(spec.cache_len, spec.max_len)
        self.prefills = 0   # admissions run
        self.steps = 0      # decode steps run
        self.pool = None
        self.prefix = None
        if self.paged:
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
        # per-slot request seed and constraint-automaton state, set at
        # admission and recomputable from the journal (the replay
        # contract). The constraint's mask table: on the module route on
        # the device with a zero row last, the row of slots that have no
        # state; on the program route on the host, fed as the reference
        # feeds it
        self.seeds = np.zeros(n, np.int64)
        self.cstate = [None] * n
        self._mask_rows = self._mask_table = None
        if self.constrained:
            table = policy.constraint.mask_table(spec.vocab_size)
            if self.exe is not None:
                self._mask_table = table
            else:
                self._mask_rows = torch.from_numpy(np.concatenate(
                    [table, np.zeros((1, table.shape[1]), np.float32)])).to(
                        self.device)
        # speculative rounds (``steps`` counts the plain decode steps
        # only), verify forwards, and this session's drafted and
        # accepted tokens (its share of the registry's
        # paddle_generation_speculative_* counters)
        self.spec_rounds = 0
        self.verifies = 0
        self._drafted = 0
        self._accepted = 0
        # program shapes run so far: paddle_quant_compute_ops_total
        # counts an armed product once per shape (ops/quant_ops.py)
        self._quant_traced = set()
        if self.speculative and self.exe is not None:
            # built last: the draft mirrors this session's slots
            self.draft = GenerationSession(
                spec.draft_spec,
                scope=self.scope if draft_scope is None else draft_scope,
                place=self.place,
                arm_quant=False if draft_scope is None else None)

    def _init_module(self, params, arm_quant, draft_params, share):
        """The ``nn.Module`` route: the model, its draft, its arming and
        its caches."""
        spec = self.spec
        self.device = spec.device
        self.model = spec.build_model(params, share=True) if share \
            else spec.build_model(params)
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
                                               arm_quant=arm_quant,
                                               share=share)
        # a draft of its own weights (not the target's tensors): what a
        # rebuild hands over by reference too
        self._own_draft = draft_params is not None
        if arm_quant:
            self._quant_armed = _quant.arm_quant_compute(self.model, shared)
        kv = kv_dtype(spec.dtype)
        if self.paged:
            self.model.allocate_pools(spec.num_blocks, spec.block_size, kv)
        else:
            self.model.allocate_cache(spec.slots, spec.cache_len, kv)

    def _init_programs(self, scope, place, draft_scope, arm_quant):
        """The program route: the executor, the arming of the spec's
        programs (a shared-scope draft's in the same call, the
        reference's one-scope rule), the cache claim and the caches."""
        spec = self.spec
        self.scope = scope if scope is not None else global_scope()
        self.place = place if place is not None else spec.device
        self.exe = Executor(place=self.place)
        self.device = self.exe.device
        self._own_draft = False
        if arm_quant:
            progs = list(spec.prefill_programs.values())
            progs += [spec.decode_program, spec.verify_program]
            if spec.draft_spec is not None and draft_scope is None:
                progs += list(spec.draft_spec.prefill_programs.values())
                progs.append(spec.draft_spec.decode_program)
            self._quant_armed = _quant.arm_quant_compute(progs, self.scope)
        names = {name for name, _, _ in spec.cache_vars}
        claimed = _CACHE_CLAIMS.setdefault(self.scope, set())
        overlap = sorted(claimed & names)
        if overlap:
            raise ValueError(
                "cache variables %s on this scope are already driven by "
                "another GenerationSession: build a fresh spec "
                "(transformer_lm_session names each spec's caches anew), "
                "or close() the old session" % overlap)
        claimed |= names
        self._claimed = names
        for name, shape, dtype in spec.cache_vars:
            if not self.scope.has_var(name):
                if self.paged:
                    shape = (shape[0] + 1,) + tuple(shape[1:])   # the sink
                self.scope.set_var(name, torch.zeros(
                    shape, dtype=kv_dtype(dtype), device=self.device))

    @property
    def spec_drafted(self):
        """Draft tokens this session's rounds proposed."""
        return self._drafted

    @property
    def spec_accepted(self):
        """Draft tokens this session's verify forwards accepted."""
        return self._accepted

    @staticmethod
    def _device_call(key, t0):
        """The reference executor's ``deviceCall`` event: a device call
        made while a request's trace context is active on this thread
        lands on that request's trace (one thread-local read when
        tracing is off)."""
        ctx = _rtrace.current()
        if ctx is not None:
            _rtrace.event(ctx, "deviceCall", key=key,
                          dur_ms=(time.perf_counter() - t0) * 1e3)

    def _trace_quant(self, shape):
        """The first run of a program ``shape`` counts each of the
        model's int8 products once in ``paddle_quant_compute_ops_total``
        (the reference counts them once per compiled program; on the
        program route the executor counts them)."""
        if self.model is None or shape in self._quant_traced:
            return
        self._quant_traced.add(shape)
        n = sum(1 for name in lm_mul_weight_names(self.model.num_layers)
                if self.model.mul_weight(name)[0].dtype == torch.int8)
        if n:
            path = "dense" if torch.device(self.device).type == "cpu" \
                else "pallas"
            _quant_ops.QUANT_COMPUTE_OPS.labels(op="mul", path=path).inc(n)

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

    def compile_stats(self):
        """The program route's executor counts (``entries``, ``compiles``:
        one plan per program, fetch list and int8 tag, the reference's
        one compile per program shape); None on the module route."""
        return None if self.exe is None else self.exe.compile_stats()

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
        _, shape, dtype = self.spec.cache_vars[0]
        itemsize = torch.empty((), dtype=kv_dtype(dtype)).element_size()
        return {"blocks_in_use": self.pool.used_count(),
                "num_blocks": self.pool.num_blocks,
                "block_size": self.spec.block_size,
                "bytes_per_block": self.spec.block_size * shape[2]
                * itemsize * len(self.spec.cache_vars)}

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
        t0 = time.perf_counter()
        try:
            self._copy_block(old, new)
            self._device_call("copy", t0)
        except BaseException:
            self.pool.decref(new)
            raise
        self.pool.decref(old)
        table[idx] = new
        # blocks are shared only through the prefix index, so it exists
        self.prefix.cows += 1
        BLOCK_COWS.inc()
        # lands on the admitting request's trace (an admission's
        # copy-on-write runs under its activated context); a step's
        # have no single owner and reach only the flight ring
        _rtrace.global_event("blockCOW", src=int(old), dst=int(new))

    def _copy_block(self, src, dst):
        """Block ``src`` -> ``dst`` in every layer's K and V pool, on the
        device: the block-copy program, or the model's ``copy_block``."""
        if self.exe is None:
            self.model.copy_block(src, dst)
            return
        f_src, f_dst = self.spec.copy_feeds
        self.exe.run(self.spec.copy_program,
                     feed={f_src: np.asarray([src], np.int32),
                           f_dst: np.asarray([dst], np.int32)},
                     fetch_list=[], scope=self.scope)

    def close(self):
        """Free the caches; the session must not be used after. Paged:
        every block reference (slot tables and prefix pins) returns to
        the pool first, and the books are checked to balance at zero. The
        draft closes with it. A program session releases its cache claim,
        erases its caches from the scope, so a later session may take
        the names, and drops its executor's captured steps, which hold
        them. Idempotent."""
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
            self.pool.close()
            self.paged = False
        if self.model is not None:
            self.model.release_cache()
        else:
            claimed = _CACHE_CLAIMS.get(self.scope)
            if claimed is not None:
                claimed -= self._claimed
            for name in self._claimed:
                self.scope.erase(name)
            self._claimed = set()
            # the captured steps hold the caches the scope let go
            self.exe.release_graphs()
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

    def _run_prefill(self, bucket, feed, n, seed, cstate):
        """The program route's admission: the policy feeds added to
        ``feed`` (the reference's: ``n`` is the total history length,
        the emitted token's sequence index), the bucket's prefill
        program run, and ``(first token, constraint state after it)``."""
        state = None
        if self.sampled:
            feed["gen.pseed"] = np.asarray([seed], np.int64)
            feed["gen.pstep"] = np.asarray([n], np.int32)
        if self.constrained:
            c = self.policy.constraint
            state = c.start if cstate is None else cstate
            feed["gen.pmask"] = self._mask_table[
                c.state_index(state)].reshape(1, -1)
        outs = self.exe.run(self.spec.prefill_programs[bucket], feed=feed,
                            fetch_list=[self.spec.prefill_fetch],
                            scope=self.scope)
        first = int(np.asarray(outs[0]).reshape(-1)[0])
        if self.constrained:
            state = self.policy.constraint.advance(state, first)
        return first, state

    def _program_decode_feed(self, tokens, pos, table):
        """The program route's decode feeds, the reference's: tokens,
        positions and (paged) the table rows, then when sampling each
        slot's seed and step (length + 1), and when constrained the
        [slots, V] mask rows of each active slot's state (zeros
        elsewhere)."""
        names = self.spec.decode_feeds
        feed = {names[0]: tokens, names[1]: pos}
        if table is not None:
            feed[names[2]] = table
        if self.sampled:
            feed["gen.dseed"] = self.seeds.copy()
            feed["gen.dstep"] = (self.lengths + 1).astype(np.int32)
        if self.constrained:
            c = self.policy.constraint
            mask = np.zeros((self.spec.slots, self.spec.vocab_size),
                            np.float32)
            for s in np.flatnonzero(self.active):
                state = self.cstate[int(s)]
                if state is not None:
                    mask[int(s)] = self._mask_table[c.state_index(state)]
            feed["gen.dmask"] = mask
        return feed

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
    def admit(self, prompt, seed=0, cstate=None, decoded=0):
        """Prefill ``prompt`` (1-D int ids) into a free slot and return
        ``(slot, first token)`` under the decode policy: ``seed`` keys a
        sampled draw, ``cstate`` is the constraint state to resume from
        (None: the start state). Raises RuntimeError when no slot is free
        and ValueError when the prompt fits no bucket.

        ``decoded``: a replay journal's last ``decoded`` tokens were
        generated, not prompted. Paged, their rows are re-run through the
        decode step's arithmetic (``verify_paged``: each row a query of
        kernel B5 at its own length, every int8 product exact per row),
        not the prefill's, so the K/V rows and the owed token are the
        fault-free run's: bit for bit with int8 weights, where a prefill
        attention's other rounding moves an activation across an int8
        step. The prompt's rows are prefilled as an admission prefills
        them. Dense sessions and program sessions re-prefill the whole
        journal, as the reference does.

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
            return self._admit_paged(prompt, seed, cstate, int(decoded))
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
        self._trace_quant(("prefill", bucket))
        t0 = time.perf_counter()
        with _tracing.span("generationPrefill", bucket=bucket):
            if self.exe is None:
                logits = self.model.prefill(
                    torch.from_numpy(padded).to(self.device), n, slot)
                first, state = self._prefill_token(logits, n, seed, cstate)
            else:
                f_tok, f_len, f_pos, f_slot = self.spec.prefill_feeds[:4]
                first, state = self._run_prefill(
                    bucket, {f_tok: padded,
                             f_len: np.asarray([n], np.int32),
                             f_pos: np.asarray([n - 1], np.int32),
                             f_slot: np.asarray([slot], np.int32)},
                    n, seed, cstate)
            self._device_call("prefill/%d" % bucket, t0)
        self.prefills += 1
        self.lengths[slot] = n
        self.last_token[slot] = first
        self.active[slot] = True
        self._policy_admitted(slot, seed, state)
        self._draft_admit(prompt, slot, first)
        _PREFILLS.labels(bucket=bucket).inc()
        return slot, first

    def _admit_paged(self, prompt, seed=0, cstate=None, decoded=0):
        """Match the cached prefix, reference its blocks, allocate the
        rest, prefill only the unshared window (a replay's generated rows
        through ``verify_paged``), then register the prompt's blocks.
        Every reference taken here is returned if anything fails."""
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
            tab = np.full(self.spec.max_blocks, self.pool.num_blocks,
                          np.int32)
            tab[:len(table)] = table
            self._trace_quant(("prefill", bucket))
            t0 = time.perf_counter()
            with _tracing.span("generationPrefill", bucket=bucket,
                               hist=matched):
                if self.exe is None:
                    logits = self._module_prefill_paged(
                        prompt, matched, decoded, tab)
                    # the emitted token's index is the TOTAL length n (=
                    # matched + w), prefix sharing included
                    first, state = self._prefill_token(logits, n, seed,
                                                       cstate)
                else:
                    padded = np.full((1, bucket), self.spec.eos_id,
                                     np.int64)
                    padded[0, :w] = suffix
                    pix = np.clip(matched + np.arange(bucket), 0,
                                  self.spec.max_len - 1).astype(np.int32)
                    f_tok, f_len, f_pos, f_hist, f_pix, f_tab = \
                        self.spec.prefill_feeds[:6]
                    first, state = self._run_prefill(
                        bucket, {f_tok: padded,
                                 f_len: np.asarray([w], np.int32),
                                 f_pos: np.asarray([w - 1], np.int32),
                                 f_hist: np.asarray([matched], np.int32),
                                 f_pix: pix, f_tab: tab}, n, seed, cstate)
                self._device_call("prefill/%d" % bucket, t0)
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
        _PREFILLS.labels(bucket=bucket).inc()
        return slot, first

    def _module_prefill_paged(self, prompt, matched, decoded, tab):
        """The module route's paged admission forward over the window
        past ``matched`` cached rows, through the table row ``tab``: the
        prompt rows [matched, split) prefilled, a replay's generated rows
        [split, n) through the decode step's arithmetic; the last row's
        logits."""
        n = prompt.size
        dev = self.device
        tab = torch.from_numpy(tab).to(dev)
        split = max(matched, n - decoded) if decoded else n
        pre = split - matched
        if pre:
            pb = self.prompt_bucket(pre)
            padded = np.full((1, pb), self.spec.eos_id, np.int64)
            padded[0, :pre] = prompt[matched:split]
            pix = np.clip(matched + np.arange(pb), 0, self.spec.max_len - 1)
            logits = self.model.prefill_paged(
                torch.from_numpy(padded).to(dev), pre, matched,
                torch.from_numpy(pix).to(dev), tab)
        if split < n:
            pix = np.clip(split + np.arange(n - split), 0,
                          self.spec.max_len - 1)
            logits = self.model.verify_paged(
                torch.from_numpy(prompt[split:].reshape(1, -1)).to(dev),
                split, torch.from_numpy(pix).to(dev), tab, last=True)
        return logits

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
        and the feeds. None when nothing is active.

        The split is a thread-safety contract: the scheduler's
        step-timeout path runs phase 2 on a worker it may leave behind
        past the timeout, so the allocator's books are only ever
        touched here, on the dispatcher thread, and a wedged worker can
        never race ``retire()`` or ``close()`` on them. A copy-on-write's
        block copy runs here too (the table swap is valid only once the
        copy succeeded), unbounded like an admission."""
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
        tokens = self.last_token.reshape(-1, 1).copy()
        pos = self.lengths.astype(np.int32)
        feed = self._decode_feed() if self.exe is None \
            else self._program_decode_feed(tokens, pos, table)
        return _Prepared(False, act, starved, tokens, pos, table, feed, None)

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
        """Phase 2: the device step and the result's application. Touches
        no allocator state, so the scheduler may run it on a worker
        thread; the feeds and the starved set were taken in phase 1. (The
        speculative round is the exception: its rollback returns blocks
        here, which is why the scheduler refuses step timeouts on
        speculative sessions.)"""
        if prepared.speculative:
            return self._step_run_spec(prepared)
        act, starved, table = prepared.act, prepared.starved, prepared.table
        tokens, pos = prepared.tokens, prepared.pos
        dev = self.device
        self._trace_quant(("decode",))
        t0 = time.perf_counter()
        with _tracing.span("generationStep", active=int(act.size)):
            if self.exe is None:
                keys, mask = prepared.feed
                logits = self.model.decode(
                    torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(pos).to(dev),
                    None if table is None
                    else torch.from_numpy(table).to(dev))
                nxt = policy_epilogue(logits, self.policy, keys,
                                      mask).cpu().numpy()
            else:
                nxt = np.asarray(self.exe.run(
                    self.spec.decode_program, feed=prepared.feed,
                    fetch_list=[self.spec.decode_fetch],
                    scope=self.scope)[0]).reshape(-1)
            self._device_call("decode", t0)
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
            self._trace_quant(("verify", w))
            t0 = time.perf_counter()
            with _tracing.span("generationVerify", window=w):
                if self.exe is None:
                    win = torch.from_numpy(window).to(dev)
                    logits = self.model.verify_paged(
                        win, length, torch.from_numpy(pix).to(dev),
                        torch.from_numpy(tab).to(dev))
                    toks, accept = decode_verify(
                        logits, win[0], self.seeds[s], length,
                        kind=pol.kind, temperature=pol.temperature,
                        top_k=pol.top_k, top_p=pol.top_p)
                    toks = toks.cpu()
                else:
                    names = self.spec.verify_feeds
                    toks, accept = self.exe.run(
                        self.spec.verify_program,
                        feed=dict(zip(names, (
                            window, np.asarray([w], np.int32),
                            np.asarray([length], np.int32),
                            pix.astype(np.int32), tab,
                            np.asarray([self.seeds[s]], np.int64)))),
                        fetch_list=list(self.spec.verify_fetch),
                        scope=self.scope)
                    toks = np.asarray(toks).reshape(-1)
                    accept = int(np.asarray(accept).reshape(-1)[0])
                self._device_call("verify/%d" % w, t0)
            if _faults.should_fire("decode_draft_mismatch",
                                   index=s) is not None:
                accept = 0   # chaos hook: force a full-reject round
            self.verifies += 1
            self._drafted += k
            self._accepted += accept
            _SPEC_DRAFTED.inc(k)
            _SPEC_ACCEPTED.inc(accept)
            emitted = [int(t) for t in toks[:accept + 1]]
            new_len = length + accept + 1
            self.lengths[s] = new_len
            self.last_token[s] = emitted[-1]
            # window rows past the confirmed prefix: blocks beyond the new
            # length go back to the pool (prepare diverged every shared
            # block the window wrote); rows left in a kept block lie past
            # the length and are overwritten by later writes
            freed = self.pool.truncate_table(self.tables[s],
                                             (new_len - 1) // bs + 1)
            if freed:
                SPEC_ROLLBACKS.inc(freed)
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


def _host_weights(sessions, names):
    """{name: a CPU copy of its live tensor} for the ``names`` the first
    session holds: its scope's on the program route, its model's
    reference state on the module route (every session of a scheduler
    holds the same values)."""
    s = sessions[0]
    if s.scope is not None:
        state = {n: s.scope.find_var(n) for n in names}
    else:
        state = s.model.reference_state()
    out = {}
    for name in names:
        v = state.get(name)
        if v is None:
            continue
        out[name] = (v.detach().to("cpu", copy=True)
                     if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v, copy=True)))
    return out


def _install_weights(sessions, params):
    """Swap ``params`` ({reference name: array or tensor}) into every
    session (their drafts included): the models of module sessions, the
    scopes of program sessions. Every holder is validated before any
    changes (a scope's ``@RNG_STATE@`` is dropped): a cache variable's
    name, an unknown name, a shape or dtype unlike the live tensor's, an
    int8 weight without its scales or scales without their weight reject
    the push. The paged sessions' prefix indexes are emptied after.

    The design is rebinding, not an in-place ``copy_``: each live tensor
    a pushed name replaces gets one new tensor (a copy of the pushed
    value on its device, in its dtype), and every model holding the old
    one, by identity, is rebound to it (``TransformerLM.bind_params``);
    a scope gets the new tensor under the name (``Scope.set_var``), the
    reference's pointer install. So a self-draft and a second session
    sharing the weights follow, the sharing survives (one new tensor, not
    one a holder), and sessions outside this scheduler that share the old
    tensors keep them. An in-place copy would change those too, and would
    race a step left behind past its timeout, which reads the weights on
    another thread; a rebind never writes a tensor such a step reads (it
    may read some layers' old and some new weights, but its session is
    quarantined and its output thrown away)."""
    # a whole reference scope pushes as it is: its @RNG_STATE@ is
    # dropped, as params_from_jax drops it
    pushed = {name: (val if isinstance(val, torch.Tensor)
                     else torch.as_tensor(np.asarray(val)))
              for name, val in params.items() if name != _io.RNG_STATE}
    cache_names = {name for s in sessions
                   for sess in (s, s.draft) if sess is not None
                   for name, _, _ in sess.spec.cache_vars}
    scopes = []
    for s in sessions:
        for sess in (s, s.draft):
            if sess is not None and sess.scope is not None and \
                    all(sess.scope is not o for o in scopes):
                scopes.append(sess.scope)
    states = [s.model.reference_state() for s in sessions
              if s.model is not None]
    states += [{n: torch.as_tensor(np.asarray(v)) if not
                isinstance(v, torch.Tensor) else v
                for n, v in scope.items()} for scope in scopes]
    suffix = _quant_ops.SCALE_SUFFIX
    for state in states:
        for name, val in pushed.items():
            if name in cache_names:
                raise ValueError("refusing to overwrite cache variable %r"
                                 % name)
            cur = state.get(name)
            if cur is None:
                raise ValueError("swap names unknown variable %r" % name)
            if tuple(val.shape) != tuple(cur.shape) or \
                    val.dtype != cur.dtype:
                raise ValueError(
                    "signature mismatch on %r: push %s/%s vs live %s/%s"
                    % (name, tuple(val.shape), val.dtype,
                       tuple(cur.shape), cur.dtype))
            if name.endswith(suffix):
                if name[:-len(suffix)] not in pushed:
                    raise ValueError("scales %r pushed without their int8 "
                                     "weight" % name)
            elif name + suffix in state and name + suffix not in pushed:
                raise ValueError("int8 weight %r pushed without its scales "
                                 "%r" % (name, name + suffix))
    fresh = {}
    for state in states:
        for name, val in pushed.items():
            cur = state[name]
            if id(cur) not in fresh:
                new = val.to(device=cur.device, dtype=cur.dtype, copy=True)
                if isinstance(cur, torch.nn.Parameter):
                    new = torch.nn.Parameter(new, requires_grad=False)
                fresh[id(cur)] = new
    models = []
    for s in sessions:
        for m in (s.model, None if s.draft is None else s.draft.model):
            if m is not None and all(m is not o for o in models):
                models.append(m)
    for m in models:
        state = m.reference_state()
        if any(id(t) in fresh for t in state.values()):
            m.bind_params({n: fresh.get(id(t), t) for n, t in state.items()},
                          m.device)
    for scope, state in zip(scopes, states[len(states) - len(scopes):]):
        for name in pushed:
            scope.set_var(name, fresh[id(state[name])])
    # cached prompt blocks hold K/V rows the old weights computed: a later
    # admission must not share them (the reference keeps its prefix index
    # across a swap; the port drops every index pin, and a block a live
    # sequence still holds stays that sequence's)
    for s in sessions:
        if s.prefix is not None:
            s.prefix.clear()


_STOP = object()

# trial re-admission failures after quarantine before a session is torn
# down and rebuilt (when rebuild is armed): the first failed trial may be
# the tail of a transient; the second says the session itself is broken
_REBUILD_AFTER_TRIALS = 2

# distinguishes per-session breaker gauge labels across schedulers
_SCHED_SEQ = itertools.count()


def _scheduler_health(ref):
    """The health callable of one scheduler (``observability.health``):
    healthy while any session can take traffic (closed or half-open
    breaker) or a rebuild is on its way back; None once the scheduler is
    garbage collected."""
    def snapshot():
        sched = ref()
        if sched is None:
            return None
        states = sched.session_health()
        # _rebuilding belongs to the dispatcher thread and has no lock;
        # a concurrent mutation can kill the iteration: retry
        for _ in range(4):
            try:
                rebuilding = sorted(sched._rebuilding)
                break
            except RuntimeError:
                continue
        else:
            rebuilding = []
        return {"healthy": not sched._closed and
                (any(s != "open" for s in states) or bool(rebuilding)),
                "closed": sched._closed,
                "sessions": states,
                "rebuilding": rebuilding,
                "active": len(sched._active)}
    return snapshot


class _GenRequest:
    __slots__ = ("prompt", "max_new", "explicit_budget", "eos_id",
                 "future", "deadline", "t_submit", "tokens", "slot",
                 "session_index", "t_last", "t_queued", "replays",
                 "charged", "failed_on", "last_exc", "ctx",
                 "on_token", "seed", "tenant")

    def __init__(self, prompt, max_new, explicit_budget, eos_id,
                 deadline, on_token=None, seed=0, tenant=None):
        self.prompt = prompt
        # the request's decode seed, minted once at the front door and
        # re-fed on every replay admission: with the prompt + tokens
        # journal it makes a sampled stream as replayable as a greedy one
        self.seed = seed
        # tenant id (None when single-tenant): shed and trace attribution
        # only, the admission math is tenant-blind
        self.tenant = tenant
        self.max_new = max_new
        # True when the caller asked for max_new tokens: placement must
        # find a session able to serve them all
        self.explicit_budget = explicit_budget
        self.eos_id = eos_id  # None until placement picks a session
        self.future = Future()
        self.deadline = deadline  # absolute time.monotonic() or None
        self.t_submit = time.perf_counter()
        # last enqueue time: t_submit at first, reset on a replay
        # re-queue so the admission-wait EWMA keeps measuring queue wait
        # (the deadline keeps using t_submit: replay spends the caller's
        # budget)
        self.t_queued = self.t_submit
        self.tokens = []
        self.slot = None
        self.session_index = None
        self.t_last = None
        self.replays = 0      # replay re-admissions consumed
        # True once this request's own failure charged a breaker: a
        # poison request failing over across sessions charges at most
        # one
        self.charged = False
        # sessions this request already failed on: replay placement
        # prefers anything else first
        self.failed_on = set()
        # the failure that parked this request for replay: it surfaces
        # if the replay turns out impossible
        self.last_exc = None
        # request-scoped TraceContext (None = tracing off or unsampled),
        # on the same object as the journal: a failover hop keeps its
        # trace id
        self.ctx = None
        # optional per-token observer, called on the dispatcher thread
        # with each newly generated token (an EOS the resolution then
        # strips included; never again for journal tokens a replay
        # re-prefills). Must not block; its exception is logged, never
        # raised into the dispatcher
        self.on_token = on_token

    def notify_token(self, token):
        if self.on_token is not None:
            try:
                self.on_token(token)
            except Exception:  # noqa: BLE001 — the dispatcher must live
                _log.logger().warning(
                    "generation on_token observer failed", exc_info=True)

    def history(self):
        """The replay journal: the prompt and every token generated so
        far. Prefilling it reconstructs the decode state, and the next
        token is the one the failed step owed."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int64)])


class GenerationScheduler:
    """Continuous-batching front door over one or more
    :class:`GenerationSession` replicas.

    ``submit(prompt) -> Future`` resolves to the generated ids as an
    int64 array (the sessions' decode policy, EOS excluded). The
    dispatcher thread admits queued requests into free cache slots
    (prefill) and runs one decode step for every session with active
    slots, over and over; sequences retire slot by slot.

    Admission: a bounded queue (``submit`` blocks, or raises
    :class:`ServingOverloadError` after ``timeout``), queue-wait EWMA
    shedding when a deadline budget is already hopeless, and expired
    deadlines resolved with :class:`ServingDeadlineError` before a
    device is touched; a deadline that expires mid-generation retires
    the slot.

    ``breaker_failures`` (default: the ``serving_breaker_failures``
    flag; 0 = off) gives each session a :class:`ReplicaBreaker`.
    ``replay_attempts`` (default: ``generation_replay_attempts``) re-runs
    a failed session's requests from their journals on a healthy one;
    with replay off they resolve with the failure. ``step_timeout_ms``
    (``generation_step_timeout_ms``) bounds each session's step, and
    ``rebuild_limit`` (``generation_rebuild_limit``) lets a broken
    session be rebuilt in the background (see the module docstring).
    Every flag is read here, at construction, and nowhere else.

    Every session must have the same decode-policy fingerprint (a
    journal resumes bit for bit only where the next-token decisions are
    the same); ``policy_fingerprint()`` reports it. A constrained request
    whose automaton reaches a state with no legal token resolves with
    :class:`~.decoding.ConstraintDeadEnd` (a ValueError: the client's).

    ``drain()`` stops admission and serves everything accepted;
    ``close()`` is the bounded fast exit; ``swap_weights(params)``
    installs new values between decode steps.
    """

    def __init__(self, sessions, max_queue=256, deadline_ms=None,
                 breaker_failures=None, breaker_cooldown_ms=None,
                 replay_attempts=None, rebuild_limit=None,
                 step_timeout_ms=None, autostart=True):
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
        # slot is free and replays (consumed before the queue)
        self._pending = collections.deque()
        # True while some waiting item may carry a deadline: gates the
        # per-tick expiry sweep
        self._has_deadlines = False
        self._closed = False
        self._thread = None
        self._wait_ewma = 0.0
        self._active = {}   # (session_index, slot) -> _GenRequest
        self._sched_id = next(_SCHED_SEQ)
        if deadline_ms is None:
            deadline_ms = _config.get_flag("serving_deadline_ms")
        self.default_deadline_ms = deadline_ms
        if breaker_failures is None:
            breaker_failures = _config.get_flag("serving_breaker_failures")
        if breaker_cooldown_ms is None:
            breaker_cooldown_ms = _config.get_flag(
                "serving_breaker_cooldown_ms")
        if breaker_failures:
            # "g<N>:<session>": per-scheduler gauge labels on the one
            # registry
            self._breakers = [
                ReplicaBreaker(i, breaker_failures,
                               float(breaker_cooldown_ms) / 1e3,
                               label="g%d:%d" % (self._sched_id, i))
                for i in range(len(self.sessions))]
        else:
            self._breakers = None
        # recovery flags, read here only: the dispatcher loop never
        # consults config, and at the defaults none of the machinery
        # below runs
        if replay_attempts is None:
            replay_attempts = _config.get_flag("generation_replay_attempts")
        self.replay_attempts = int(replay_attempts or 0)
        if rebuild_limit is None:
            rebuild_limit = _config.get_flag("generation_rebuild_limit")
        self.rebuild_limit = int(rebuild_limit or 0)
        if step_timeout_ms is None:
            step_timeout_ms = _config.get_flag("generation_step_timeout_ms")
        self.step_timeout = (float(step_timeout_ms) / 1e3
                             if step_timeout_ms else None)
        if self.step_timeout is not None and \
                any(s.speculative for s in self.sessions):
            raise ValueError(
                "step_timeout_ms does not compose with speculative "
                "decoding: the speculative round mutates the block pool "
                "inside step_run, which must stay on the dispatcher "
                "thread; a leaked bounded worker could race "
                "retire()/close() on the allocator books")
        self._workers = {}       # si -> BoundedWorker (bounded steps)
        self._wedged = {}        # si -> done-Event of the wedged step
        self._rebuilding = set()  # session indices down for rebuild
        # True once nothing will absorb rebuilds any more (the
        # dispatcher exited, or a dispatcherless close()/drain()
        # finished): a draining scheduler is closed but still absorbing
        self._terminal = False
        self._rebuilt = queue.Queue()  # (si, session|None, err, secs)
        self._rebuilds = [0] * len(self.sessions)
        self._trial_failures = [0] * len(self.sessions)
        self._swap_lock = threading.Lock()
        self._pending_swap = None  # (params, Future)
        self._pending_snapshots = []  # [(names, Future)]
        self._weights_version = 0
        self._health_name = "generation%d" % self._sched_id
        _health.register_health(self._health_name,
                                _scheduler_health(weakref.ref(self)))
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

    @property
    def weights_version(self):
        return self._weights_version

    def session_health(self):
        if self._breakers is None:
            return ["closed"] * len(self.sessions)
        return [b.state for b in self._breakers]

    def policy_fingerprint(self):
        """The decode-policy fingerprint every session here shares
        (``"greedy"`` with no policy)."""
        return self._policy_fp

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, timeout=None, on_token=None, seed=None,
               tenant=None):
        """Enqueue one prompt; returns a Future of its generated ids.

        ``max_new_tokens`` is capped by the slot capacity left after the
        prompt. ``deadline_ms`` (default: the scheduler's) bounds the
        WHOLE generation; a budget the projected queue wait already
        exceeds is shed at once with :class:`ServingOverloadError`.
        ``timeout``: seconds to wait on a full queue before
        :class:`ServingOverloadError`. ``on_token``: an observer called
        with each newly generated token on the dispatcher thread.
        ``seed`` keys a sampled policy's draws; None mints one
        (``mint_seed``) when the sessions sample, 0 otherwise.
        ``tenant``: the submitting tenant's id, for shed and trace
        attribution."""
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
        if deadline_ms:   # 0 / None = no deadline
            budget = float(deadline_ms) / 1e3
            if budget < 0:
                _sres.DEADLINE_EXCEEDED.inc()
                raise ServingDeadlineError(
                    "deadline budget %.1f ms already spent"
                    % float(deadline_ms))
            projected = self._wait_ewma * (1.0 + self._q.qsize())
            if projected > budget:
                # the same geometric decay as the reference's batcher:
                # sheds must not latch the estimate high on an idle queue
                self._wait_ewma *= (1.0 - _WAIT_ALPHA)
                _sres.SHED.inc()
                if tenant is not None:
                    _sres.TENANT_SHED.labels(tenant=str(tenant)).inc()
                raise ServingOverloadError(
                    "shed: projected admission wait %.1f ms exceeds the "
                    "%.1f ms deadline budget"
                    % (projected * 1e3, budget * 1e3))
            deadline = time.monotonic() + budget
        if seed is None:
            seed = mint_seed() if self._sampled else 0
        item = _GenRequest(prompt, max_new, explicit, eos_id, deadline,
                           on_token=on_token, seed=int(seed),
                           tenant=None if tenant is None else str(tenant))
        # minted at the front door (one attribute read when off) and
        # carried on the item through every queue, session and replay
        mint_kw = {}
        if item.tenant is not None:
            mint_kw["tenant"] = item.tenant
        item.ctx = _rtrace.mint("generation.submit",
                                prompt_len=int(prompt.size),
                                max_new=int(max_new), **mint_kw)
        try:
            self._q.put(item, block=True, timeout=timeout)
        except queue.Full:
            _sres.SHED.inc()
            # never entered the system: it must not churn real traces
            # out of the bounded store
            _rtrace.discard(item.ctx)
            if item.tenant is not None:
                _sres.TENANT_SHED.labels(tenant=item.tenant).inc()
            raise ServingOverloadError(
                "generation queue full (%d pending)"
                % self._q.qsize()) from None
        if deadline is not None:
            # after the put: the sweep recomputes the flag from the
            # queue's content, so a deadline item is never stranded
            # behind a cleared flag
            self._has_deadlines = True
        if self._closed and self._thread is None:
            # raced a close()/drain() past its leftover sweep
            _rtrace.discard(item.ctx)
            _resolve(item.future,
                     exception=RuntimeError("scheduler closed"))
            raise RuntimeError("scheduler is closed")
        return item.future

    # -- dispatcher ------------------------------------------------------
    def _next_item(self, block):
        """The next request to place: the parked buffer first (it
        preserves order), then the queue. None when nothing waits."""
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
        pool storage for the token budget still owed, and a prompt
        bucket for the whole journal (a replay's, prompt plus tokens, may
        need a larger bucket than the first admission) or, with a paged
        prefix cache, for the window left once the cached prefix is
        subtracted (``window_fits``, no side effects)?"""
        n = item.prompt.size + len(item.tokens)
        need = max(1, item.max_new - len(item.tokens)) \
            if item.explicit_budget else 1
        if sess.max_pos - n + 1 < need or \
                not sess.storable(n + need - 1):
            return False
        return sess.prompt_bucket(n) is not None or \
            sess.window_fits(item.history())

    def _is_wedged(self, si):
        """True while session ``si``'s timed-out step is still running:
        it must not be stepped or admitted into. Once the step returns
        the marker clears; the breaker (opened by the hang) still gates
        re-admission through a cooldown trial."""
        ev = self._wedged.get(si)
        if ev is None:
            return False
        if ev.is_set():
            self._wedged.pop(si, None)
            return False
        return True

    def _eligible_session(self, item, claim=False):
        """Index of a session that can take this request now (a free
        slot, a fitting bucket and capacity, storage, and a closed
        breaker, or a cooldown-elapsed trial when nothing fitting is
        closed), or None. Wedged and rebuilding sessions never are. The
        half-open transition fires only with ``claim`` (a request is
        about to be admitted: the trial)."""
        candidates = [i for i, s in enumerate(self.sessions)
                      if i not in self._rebuilding
                      and not self._is_wedged(i)
                      and s.free_slots() and self._fits(s, item)
                      and s.admit_ok(item.prompt.size + len(item.tokens))]
        if item.failed_on:
            # a session this request already failed on is the last
            # resort, whatever its breaker says
            candidates.sort(key=lambda i: i in item.failed_on)
        if not candidates:
            return None
        if self._breakers is None:
            return candidates[0]
        closed = [i for i in candidates
                  if self._breakers[i].state == "closed"]
        if closed:
            return closed[0]
        now = time.monotonic()
        for i in candidates:
            breaker = self._breakers[i]
            if breaker.state == "half_open" or breaker.ready_to_probe(now):
                if claim:
                    breaker.to_half_open()
                return i
        return None

    def _recovery_pending(self, item):
        """True while a finite recovery will make a fitting session
        placeable for ``item``: a rebuild on its way, or replay armed and
        a fitting session's breaker riding a cooldown toward a trial.
        Shutdown serving waits these out instead of failing the
        request."""
        for i, s in enumerate(self.sessions):
            if not self._fits(s, item):
                continue
            if i in self._rebuilding:
                return True
            if self.replay_attempts and self._breakers is not None \
                    and not self._is_wedged(i) \
                    and self._breakers[i].state != "closed":
                return True
        return False

    def _dispatchable_later(self, item):
        """True when a session fitting this request is healthy (or
        trial-ready) but out of free slots, or is being rebuilt. With
        replay armed an open breaker whose cooldown still runs counts
        too (bounded by the request's deadline and replay budget); with
        replay off quarantine fails fast. A still-wedged session is not a
        reason to wait."""
        for i, s in enumerate(self.sessions):
            if not self._fits(s, item):
                continue
            if i in self._rebuilding:
                return True
            if self._is_wedged(i):
                continue
            breaker = self._breakers[i] if self._breakers else None
            if breaker is None or \
                    breaker.state in ("closed", "half_open") or \
                    breaker.ready_to_probe():
                return True
            if self.replay_attempts and breaker.state == "open":
                return True
        return False

    def _resolve_err(self, item, exc):
        """Exceptional resolution with its trace ending
        (``resolveError``)."""
        if item.ctx is not None:
            _rtrace.event(item.ctx, "resolveError",
                          error=repr(exc)[:200],
                          error_type=type(exc).__name__)
        _resolve(item.future, exception=exc)

    def _expire(self, item, where):
        _sres.DEADLINE_EXCEEDED.inc()
        if item.ctx is not None:
            _rtrace.event(item.ctx, "deadlineExpired", where=where,
                          replays=item.replays)
        _resolve(item.future, exception=ServingDeadlineError(
            "deadline expired after %.1f ms %s"
            % ((time.perf_counter() - item.t_submit) * 1e3, where)))

    def _expire_queued(self):
        """Resolve expired deadlines of requests still waiting, even
        while every slot is busy. Gated by ``_has_deadlines`` so a
        deadline-free workload never pays the queue rotation."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        remaining = False
        keep = collections.deque()
        while self._pending:
            item = self._pending.popleft()
            if item is not _STOP and item.deadline is not None \
                    and now >= item.deadline:
                self._expire(item, "in queue")
            else:
                if item is not _STOP and item.deadline is not None:
                    remaining = True
                keep.append(item)
        self._pending = keep
        for _ in range(self._q.qsize()):
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP and item.deadline is not None \
                    and now >= item.deadline:
                self._expire(item, "in queue")
            else:
                if item is not _STOP and item.deadline is not None:
                    remaining = True
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    # a racing submit took the freed capacity: the parked
                    # buffer keeps the item dispatchable
                    self._pending.append(item)
        # recomputed from content: a submit landing mid-sweep re-arms
        # the flag itself after its put
        self._has_deadlines = remaining

    def _place(self, item):
        """Admit ``item`` somewhere, park it, or resolve it. Returns
        False when it was parked (no capacity now: stop pulling from the
        queue)."""
        if item.deadline is not None and time.monotonic() >= item.deadline:
            self._expire(item, "in queue")
            return True
        si = self._eligible_session(item, claim=True)
        if si is None:
            if self._dispatchable_later(item):
                self._pending.appendleft(item)
                return False
            # nothing can ever take it: fail explicitly, with the session
            # failure that parked a replay when there was one
            self._resolve_err(item, item.last_exc
                              if item.last_exc is not None
                              else ServingUnavailableError(
                                  "no healthy generation session for "
                                  "this prompt"))
            return True
        self._admit_item(item, si)
        return True

    def _admit_item(self, item, si):
        wait = time.perf_counter() - item.t_queued
        self._wait_ewma += _WAIT_ALPHA * (wait - self._wait_ewma)
        _rtrace.QUEUE_WAIT_MS.observe(wait * 1e3)
        sess = self.sessions[si]
        replay = bool(item.tokens)
        if item.ctx is not None:
            _rtrace.event(item.ctx, "queueWait", dur_ms=wait * 1e3,
                          replay=replay)
        t_admit0 = time.perf_counter()
        try:
            # the activated context follows the admission into the fault
            # hook and the prefill
            with _rtrace.activate(item.ctx):
                _faults.fire_point("generation_admit_fail", index=si)
                cstate = None
                if sess.constrained:
                    # the automaton state is journal-derived, as the
                    # cache is
                    c = sess.policy.constraint
                    cstate = c.advance_many(c.start, item.tokens)
                slot, first = sess.admit(item.history(), seed=item.seed,
                                         cstate=cstate,
                                         decoded=len(item.tokens))
        except ValueError as exc:
            # a client-shaped prompt is the request's fault, not the
            # session's: no breaker charge
            self._resolve_err(item, exc)
            return
        except Exception as exc:  # noqa: BLE001 — the session's failure
            self._on_admit_failure(item, si, exc)
            return
        # breaker success is recorded by a surviving step, not here: a
        # step-broken session would otherwise launder itself closed
        # through every trial admission it then fails
        if item.eos_id is None:
            item.eos_id = sess.spec.eos_id
        now_pc = time.perf_counter()
        _rtrace.PREFILL_MS.observe((now_pc - t_admit0) * 1e3)
        if item.ctx is not None:
            # hist = the prefix-cache hit length (0 dense or on a miss)
            hist = sess.prefill_log[-1][1] \
                if sess.paged and sess.prefill_log else 0
            _rtrace.event(item.ctx,
                          "replayAdmit" if replay else "prefill",
                          dur_ms=(now_pc - t_admit0) * 1e3,
                          session=si, slot=slot,
                          journal_len=int(item.prompt.size)
                          + len(item.tokens), hist=int(hist))
        if replay:
            # the same request resumed: requests_total does not count it
            # again; the re-prefilled history is what the failover cost
            _REPLAYED_TOKENS.inc(len(item.tokens))
            _RECOVERY_SECONDS.observe(now_pc - item.t_queued)
            _rtrace.REPLAY_RECOVERY_MS.observe(
                (now_pc - item.t_queued) * 1e3)
        else:
            _REQUESTS.inc()
            _TTFT_SECONDS.observe(now_pc - item.t_submit)
        _TOKENS.inc()   # the prefill produced one new token either way
        item.t_last = now_pc
        item.slot = slot
        item.session_index = si
        item.tokens.append(first)
        item.notify_token(first)
        self._active[(si, slot)] = item
        self._update_occupancy()
        # EOS or the budget can end it at its first token; a constrained
        # request may already stand in a dead state
        if not self._finish_if_done(item):
            self._check_dead_end(sess, item)

    def _on_admit_failure(self, item, si, exc):
        """A session failed this request's (re-)admission: charge its
        breaker (at most once a request across its replays; a half-open
        trial's failure always records), then replay the request
        elsewhere or surface the failure when the budget is spent."""
        breaker = self._breakers[si] if self._breakers else None
        was_trial = False
        if breaker is not None:
            was_trial = breaker.state == "half_open"
            if was_trial or not item.charged:
                breaker.record_failure()
                item.charged = True
            if was_trial:
                self._trial_failures[si] += 1
        item.failed_on.add(si)
        if item.ctx is not None:
            _rtrace.event(item.ctx, "admitFailure", session=si,
                          trial=was_trial, error=repr(exc)[:200])
        _log.structured("generation_admit_failed", session=si,
                        error=repr(exc), replay=bool(item.tokens))
        self._maybe_rebuild(si)
        # no slot was held, so no retirement to count
        self._requeue_for_replay([item], exc)

    def _requeue_for_replay(self, items, exc):
        """Park failed requests head-of-line for replay re-admission;
        those whose replay budget is spent resolve with ``exc``. Returns
        the list re-queued."""
        requeued, spent = [], []
        for item in items:
            if self.replay_attempts and \
                    item.replays < self.replay_attempts:
                requeued.append(item)
            else:
                spent.append(item)
        # appendleft in reverse keeps the failed batch's own order at the
        # head of the parked buffer
        for item in reversed(requeued):
            item.replays += 1
            item.t_queued = time.perf_counter()
            item.last_exc = exc
            _FAILOVERS.inc()
            if item.ctx is not None:
                _rtrace.event(item.ctx, "failoverRequeue",
                              from_session=item.session_index,
                              replays=item.replays,
                              journal_len=int(item.prompt.size)
                              + len(item.tokens),
                              error=repr(exc)[:200])
            self._pending.appendleft(item)
        if any(item.deadline is not None for item in requeued):
            # the expiry sweep must keep covering parked replays
            self._has_deadlines = True
        for item in spent:
            self._resolve_err(item, exc)
        return requeued

    def _finish_if_done(self, item):
        """Retire and resolve on EOS, budget, capacity or deadline.
        Returns True when the request left its slot."""
        sess = self.sessions[item.session_index]
        reason = None
        if item.tokens and item.tokens[-1] == item.eos_id:
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
        _RETIRED.labels(reason=reason).inc()
        if reason == "deadline":
            _sres.DEADLINE_EXCEEDED.inc()
            if item.ctx is not None:
                _rtrace.event(item.ctx, "deadlineExpired",
                              where="mid-generation",
                              tokens=len(item.tokens))
            _resolve(item.future, exception=ServingDeadlineError(
                "deadline expired mid-generation after %d tokens"
                % len(item.tokens)))
        else:
            e2e = time.perf_counter() - item.t_submit
            _REQUEST_SECONDS.observe(e2e)
            _rtrace.E2E_MS.observe(e2e * 1e3)
            if item.ctx is not None:
                _rtrace.event(item.ctx, "resolve", reason=reason,
                              tokens=len(item.tokens), dur_ms=e2e * 1e3)
            _resolve(item.future, result=np.asarray(item.tokens, np.int64))
        self._update_occupancy()
        return True

    def _check_dead_end(self, sess, item):
        """A constrained request whose last token advanced its automaton
        into a state that bans every next token resolves with
        ConstraintDeadEnd, a client error: no breaker charge, no replay,
        never a hang. The ``decode_constraint_dead_end`` fault site
        forces the verdict. Returns True when it left its slot."""
        if not sess.constrained:
            return False
        key = (item.session_index, item.slot)
        if key not in self._active:
            return False
        state = sess.cstate[item.slot]
        fired = _faults.should_fire("decode_constraint_dead_end",
                                    index=item.slot)
        if fired is None and not sess.policy.constraint.dead(state):
            return False
        sess.retire(item.slot)
        del self._active[key]
        _RETIRED.labels(reason="dead_end").inc()
        self._resolve_err(item, ConstraintDeadEnd(state, len(item.tokens)))
        self._update_occupancy()
        return True

    def _step_session(self, si, sess, prepared):
        """One session's step phase 2 and its fault hooks, shared by the
        inline and the bounded path, so an injected fault (a wedge
        callback included) lands inside whatever bounds the step."""
        _faults.fire_point("generation_session_wedge", index=si)
        _faults.fire_point("generation_step_fail", index=si)
        return sess.step_run(prepared)

    def _step_timed(self, si, sess, prepared):
        """Phase 2 on session ``si``'s step worker, bounded by
        ``self.step_timeout``. A hang raises ServingTimeoutError and
        marks the session wedged: its worker stays busy with the stuck
        step, and the marker keeps the session out of placement and
        stepping until it returns, so no second thread ever stacks
        behind a dead device call. ``prepared`` came from phase 1 on the
        dispatcher thread, where every block-pool change happens: a step
        left behind past its timeout runs only the device call and the
        per-slot scalar updates of its own session."""
        worker = self._workers.get(si)
        if worker is None:
            worker = self._workers[si] = _sres.BoundedWorker(
                "generation-step-%d" % si)
        try:
            return worker.call(
                lambda: self._step_session(si, sess, prepared),
                self.step_timeout)
        except _sres.ServingTimeoutError as err:
            self._wedged[si] = err.pending
            _STEP_TIMEOUTS.inc()
            raise

    def _on_session_failure(self, si, sess, mine, exc, hang=False):
        """A session's step failed (or hung): free its slots, charge its
        breaker once for the event, and replay the affected requests on
        healthy sessions (default off: they resolve with the failure)."""
        breaker = self._breakers[si] if self._breakers else None
        if breaker is not None:
            # one charge per failure event, and at most one per request
            # across its replays; hangs and half-open trials always
            # record
            was_trial = breaker.state == "half_open"
            uncharged = [it for _, it in mine if not it.charged]
            if hang or was_trial or uncharged:
                breaker.record_failure(hang=hang)
                for it in uncharged:
                    it.charged = True
            if was_trial:
                self._trial_failures[si] += 1
        _log.structured("generation_step_failed", session=si,
                        error=repr(exc), hang=hang, requests=len(mine))
        for slot, it in mine:
            sess.retire(slot)
            self._active.pop((si, slot), None)
            it.failed_on.add(si)
            if it.ctx is not None:
                _rtrace.event(it.ctx, "sessionFailure", session=si,
                              slot=slot, hang=hang, error=repr(exc)[:200])
        items = [it for _, it in mine]
        requeued = set()
        if self.replay_attempts:
            requeued = set(map(id, self._requeue_for_replay(items, exc)))
        else:
            for it in items:
                self._resolve_err(it, exc)
        for it in items:
            _RETIRED.labels(reason="failover" if id(it) in requeued
                            else "error").inc()
        self._update_occupancy()
        # a wedged session can run no trial: with rebuild armed it goes
        # straight to reconstruction
        self._maybe_rebuild(si, force=hang)

    def _step_all(self):
        for si, sess in enumerate(self.sessions):
            if si in self._rebuilding:
                continue   # down for reconstruction; nothing is active
            mine = [(slot, it) for (s_i, slot), it
                    in list(self._active.items()) if s_i == si]
            if not mine:
                continue
            breaker = self._breakers[si] if self._breakers else None
            # the inline step runs under the first sampled request's
            # context; each sampled request gets its own decodeStep event
            step_ctx = next((it.ctx for _, it in mine
                             if it.ctx is not None), None)
            t_step0 = time.perf_counter()
            try:
                # phase 1 outside any request's context: its pool changes
                # are batch-level
                prepared = sess.step_prepare()
                if prepared is None:
                    toks = {}
                elif self.step_timeout is not None:
                    toks = self._step_timed(si, sess, prepared)
                else:
                    with _rtrace.activate(step_ctx):
                        toks = self._step_session(si, sess, prepared)
            except Exception as exc:  # noqa: BLE001 — the session's
                hang = isinstance(exc, _sres.ServingTimeoutError)
                self._on_session_failure(si, sess, mine, exc, hang=hang)
                continue
            if breaker is not None:
                breaker.record_success()
                self._trial_failures[si] = 0
            _STEPS.inc()
            now_pc = time.perf_counter()
            step_ms = (now_pc - t_step0) * 1e3
            _rtrace.DECODE_STEP_MS.observe(step_ms)
            advanced = 0
            for slot, it in mine:
                if slot not in toks:
                    # a paged pool had no block for this sequence's next
                    # row, even after eviction: it cannot grow here
                    sess.retire(slot)
                    del self._active[(si, slot)]
                    self._update_occupancy()
                    if self.replay_attempts and it.explicit_budget \
                            and len(it.tokens) < it.max_new and \
                            it.replays < self.replay_attempts:
                        # preemption, not truncation: the journal
                        # re-queues and resumes bit for bit once blocks
                        # free (admit_ok parks it meanwhile)
                        it.failed_on.add(si)
                        _RETIRED.labels(reason="preempted").inc()
                        if it.ctx is not None:
                            _rtrace.event(it.ctx, "preempted", session=si,
                                          slot=slot, tokens=len(it.tokens))
                        self._requeue_for_replay(
                            [it], PoolExhausted(
                                "session %d pool exhausted after %d "
                                "tokens" % (si, len(it.tokens))))
                        continue
                    # an implicit budget asked for "as much as fits":
                    # finishing at the current length is the contract
                    _RETIRED.labels(reason="capacity").inc()
                    _REQUEST_SECONDS.observe(now_pc - it.t_submit)
                    _rtrace.E2E_MS.observe((now_pc - it.t_submit) * 1e3)
                    if it.ctx is not None:
                        _rtrace.event(it.ctx, "resolve", reason="capacity",
                                      tokens=len(it.tokens))
                    _resolve(it.future,
                             result=np.asarray(it.tokens, np.int64))
                    continue
                got = toks[slot]
                # a speculative round emits a list: the accepted drafts
                # and the target's next token; plain rounds one int
                for tok in (got if isinstance(got, list) else [got]):
                    advanced += 1
                    it.tokens.append(tok)
                    it.notify_token(tok)
                    _INTER_TOKEN_SECONDS.observe(now_pc - it.t_last)
                    it.t_last = now_pc
                    if it.ctx is not None:
                        _rtrace.event(it.ctx, "decodeStep", dur_ms=step_ms,
                                      session=si, slot=slot,
                                      active=len(mine),
                                      token_index=len(it.tokens))
                    if self._finish_if_done(it) or \
                            self._check_dead_end(sess, it):
                        # EOS, budget or dead end inside the window: the
                        # rest of the list is dropped, the slot retired
                        break
            _TOKENS.inc(advanced)

    # -- session rebuild -------------------------------------------------
    def _maybe_rebuild(self, si, force=False):
        """Start a background rebuild of session ``si`` when it has
        proven broken: its trial re-admissions keep failing
        (``_REBUILD_AFTER_TRIALS``), or ``force`` (a wedge: trials are
        impossible). Bounded by ``rebuild_limit`` a session; needs
        ``spec.rebuild``."""
        if not self.rebuild_limit or si in self._rebuilding:
            return
        if self._rebuilds[si] >= self.rebuild_limit:
            return
        if not force and self._trial_failures[si] < _REBUILD_AFTER_TRIALS:
            return
        sess = self.sessions[si]
        if sess.spec.rebuild is None:
            return
        if any(s_i == si for (s_i, _) in self._active):
            return   # live requests still decode there; next event
        self._rebuilding.add(si)
        self._rebuilds[si] += 1
        _rtrace.global_event("sessionRebuildStart", session=si,
                             forced=bool(force),
                             rebuilds=self._rebuilds[si])
        _flight.RECORDER.trigger_async("session_rebuild", session=si,
                                       forced=bool(force))
        threading.Thread(
            target=self._rebuild_worker, args=(si, sess),
            name="generation-rebuild-%d" % si, daemon=True).start()

    # bound on one rebuild's construction and warm-up: a rebuild was
    # started because the session was broken, possibly on a dead
    # device, and an unbounded warm-up would pin _rebuilding forever
    REBUILD_TIMEOUT = 120.0

    @staticmethod
    def _build_replacement(old):
        """The replacement of session ``old``: a new spec (new cache
        namespaces) and a session over the same weights: a program
        session over the same scope (its cache zeros materialized under
        the new names), a module session by reference (``share=True``: no
        copy); an int8-armed session's int8 weights and scales as they
        are, with no second quantization; a speculative session's draft
        on the same tensors. Then every prompt bucket, the decode step
        and, paged, the block copy warmed with the prefix index detached
        (a later bucket's warm prompt would otherwise match an earlier
        one's prefix and run a smaller window)."""
        spec = old.spec.rebuild()
        if old.exe is not None:
            draft_scope = None
            if old.draft is not None and old.draft.scope is not old.scope:
                draft_scope = old.draft.scope
            new = GenerationSession(spec, scope=old.scope, place=old.place,
                                    draft_scope=draft_scope,
                                    arm_quant=bool(old._quant_armed))
        else:
            draft_params = old.draft.model.reference_state() \
                if old._own_draft else None
            new = GenerationSession(spec, old.model.reference_state(),
                                    arm_quant=bool(old._quant_armed),
                                    draft_params=draft_params, share=True)
        try:
            prefix, new.prefix = new.prefix, None
            try:
                for bucket in spec.prompt_buckets:
                    n = max(1, min(int(bucket), new.max_pos))
                    slot, _ = new.admit([spec.bos_id] * n)
                    new.retire(slot)
                slot, _ = new.admit([spec.bos_id])
                new.step()
                new.retire(slot)
                if new.paged:
                    # block 0 onto itself: an identity copy
                    new._copy_block(0, 0)
            finally:
                new.prefix = prefix
        except BaseException:
            try:
                new.close()
            except Exception:  # noqa: BLE001 — the build's error wins
                pass
            raise
        return new

    def _rebuild_worker(self, si, old_sess):
        """Background thread: build and warm the replacement, bounded by
        REBUILD_TIMEOUT (a dead device must fail the rebuild, not hang
        it). The hand-over happens on the dispatcher thread
        (``_absorb_rebuilds``)."""
        t0 = time.perf_counter()
        # abandon handshake: the builder commits its session and the
        # timed-out waiter abandons under one lock; whichever loses the
        # race releases the session
        state = {"abandoned": False, "new": None}
        state_lock = threading.Lock()

        def build():
            new = self._build_replacement(old_sess)
            with state_lock:
                if not state["abandoned"]:
                    state["new"] = new   # committed
                    return new
            try:
                new.close()
            except Exception:  # noqa: BLE001
                pass
            return None

        try:
            new = _sres.run_bounded(build, self.REBUILD_TIMEOUT,
                                    name="generation-rebuild-build-%d" % si)
        except Exception as exc:  # noqa: BLE001 — reported on the queue
            with state_lock:
                state["abandoned"] = True
                committed = state["new"]
                state["new"] = None
            if committed is not None:
                try:
                    committed.close()
                except Exception:  # noqa: BLE001
                    pass
            self._rebuilt.put((si, None, exc, time.perf_counter() - t0))
            return
        if new is None:   # abandoned race: already released
            self._rebuilt.put((si, None, RuntimeError("rebuild abandoned"),
                               time.perf_counter() - t0))
            return
        if self._terminal:
            # fully shut down mid-build: nobody will absorb it
            try:
                new.close()
            except Exception:  # noqa: BLE001
                pass
            self._rebuilding.discard(si)
            return
        self._rebuilt.put((si, new, None, time.perf_counter() - t0))
        if self._terminal:
            # shutdown raced the put past its final sweep
            self._drain_rebuilt()

    def _absorb_rebuilds(self):
        """Dispatcher-thread hand-over: swap finished rebuilds into the
        session list (the dispatcher is the only session caller, so the
        swap is race-free) and back into placement."""
        if not self._rebuilding:
            return
        while True:
            try:
                si, new, err, secs = self._rebuilt.get_nowait()
            except queue.Empty:
                return
            self._rebuilding.discard(si)
            if new is None:
                _log.structured("generation_rebuild_failed", session=si,
                                error=repr(err),
                                rebuilds=self._rebuilds[si])
                continue   # budget permitting, a later event retries
            old = self.sessions[si]
            try:
                # a wedged step finishing later writes only the old
                # session's caches, which nothing reads any more
                old.close()
            except Exception:  # noqa: BLE001
                pass
            self.sessions[si] = new
            worker = self._workers.pop(si, None)
            if worker is not None:
                worker.stop()
            self._wedged.pop(si, None)
            self._trial_failures[si] = 0
            if self._breakers is not None:
                self._breakers[si].record_success()
            _REBUILDS.inc()
            _rtrace.global_event("sessionRebuilt", session=si,
                                 seconds=round(secs, 3))
            _log.structured("generation_session_rebuilt", session=si,
                            seconds=round(secs, 3),
                            rebuilds=self._rebuilds[si])

    def _update_occupancy(self):
        total = sum(s.spec.slots for s in self.sessions)
        _OCCUPANCY.labels(scheduler="gen%d" % self._sched_id).set(
            len(self._active) / float(total))

    # -- weight swap -----------------------------------------------------
    def _apply_pending_swap(self):
        with self._swap_lock:
            snaps, self._pending_snapshots = self._pending_snapshots, []
            pending, self._pending_swap = self._pending_swap, None
        for names, future in snaps:
            try:
                _resolve(future, result=_host_weights(self.sessions, names))
            except Exception as exc:  # noqa: BLE001 — the caller's error
                _resolve(future, exception=exc)
        if pending is None:
            return
        params, future = pending
        try:
            _install_weights(self.sessions, params)
            self._weights_version += 1
            _log.structured("generation_weights_swapped",
                            version=self._weights_version,
                            params=len(params))
            _resolve(future, result=self._weights_version)
        except Exception as exc:  # noqa: BLE001 — the caller's error
            _resolve(future, exception=exc)

    def swap_weights(self, params, timeout=30.0):
        """Install new parameter values (``{reference name: array or
        tensor}``) in every session between decode steps: the dispatcher
        applies the swap before its next admission or step, so no
        forward pass mixes versions; sequences mid-generation continue on
        the new weights (their cached K/V rows keep the old weights'
        values). Unknown names, cache tensors, shape or dtype mismatches
        and an int8 weight without its scales (or scales without their
        weight) reject the push before any session changes. Returns the
        new weights version."""
        if self._closed:
            raise RuntimeError("scheduler is closed")
        future = Future()
        with self._swap_lock:
            if self._pending_swap is not None:
                raise RuntimeError("a weight swap is already pending")
            self._pending_swap = (dict(params), future)
        if self._thread is None:
            self._apply_pending_swap()
        try:
            return future.result(timeout=timeout)
        except FutureTimeoutError:
            with self._swap_lock:
                if self._pending_swap is not None and \
                        self._pending_swap[1] is future:
                    # still queued: cancel it, so a failed push never
                    # lands later and a retry is not blocked
                    self._pending_swap = None
                    raise RuntimeError(
                        "weight swap not applied within %.0fs: "
                        "cancelled" % timeout) from None
            # the dispatcher took it mid-wait: the install is bounded
            return future.result(timeout=5.0)

    def snapshot_weights(self, names, timeout=30.0):
        """Host copies of the live parameter values ``names`` ({reference
        name: CPU tensor}; a name the sessions do not hold is left out),
        read on the dispatcher thread between decode steps, where every
        launch of this scheduler runs: a fleet worker's rollback target
        of a weight push and the resident copy of a model it pages out of
        its scope. A later ``swap_weights`` installs new tensors and
        never writes these."""
        if self._closed:
            raise RuntimeError("scheduler is closed")
        future = Future()
        with self._swap_lock:
            self._pending_snapshots.append((list(names), future))
        if self._thread is None:
            self._apply_pending_swap()
        return future.result(timeout=timeout)

    # -- serving loop and shutdown ----------------------------------------
    def _serve_out(self):
        """After the stop marker, on the dispatcher thread: finish every
        active slot and place and serve everything still waiting,
        co-batched like live traffic."""
        while True:
            self._apply_pending_swap()
            self._absorb_rebuilds()
            if self._active:
                self._step_all()
                continue
            item = self._next_item(block=False)
            if item is None:
                return
            if item is _STOP:
                continue
            if not self._place(item) and not self._active:
                if self._recovery_pending(item):
                    # a rebuild hand-over or a cooldown trial makes room
                    # in finite time
                    time.sleep(0.02)
                    continue
                # unplaceable with nothing in flight (slots held outside
                # this scheduler): resolve rather than spin
                parked = self._pending.popleft()
                self._resolve_err(parked, parked.last_exc
                                  if parked.last_exc is not None
                                  else ServingUnavailableError(
                                      "scheduler stopped before the "
                                      "request could be placed"))

    def _dispatcher_exit(self):
        """Dispatcher epilogue: nothing absorbs rebuilds past this point,
        so mark terminal and release stragglers; stop the step workers;
        retire the health gauges and the health registration."""
        self._terminal = True
        self._drain_rebuilt()
        for worker in self._workers.values():
            worker.stop()
        self._workers = {}
        self._retire_breaker_gauges()
        _health.unregister_health(self._health_name)

    def _loop(self):
        try:
            self._loop_inner()
        except BaseException as exc:
            # the dispatcher is dying: nothing would resolve these
            for it in list(self._active.values()) + list(self._pending):
                if it is not _STOP:
                    _resolve(it.future, exception=exc)
            self._active.clear()
            self._pending.clear()
            raise
        finally:
            self._dispatcher_exit()

    def _loop_inner(self):
        while True:
            self._apply_pending_swap()
            self._absorb_rebuilds()
            if self._active:
                self._expire_queued()
                got_stop = self._fill_slots()
                self._step_all()
                if got_stop:
                    self._serve_out()
                    return
            else:
                # parked replays may wait out a rebuild with nothing
                # active: their deadlines keep firing
                self._expire_queued()
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
                    # held outside this scheduler or a rebuild is in
                    # flight; back off
                    time.sleep(0.02)

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
                return False   # head parked: no capacity this tick

    def _stop_dispatcher(self, timeout):
        self._closed = True
        if self._thread is not None:
            try:
                self._q.put_nowait(_STOP)
            except queue.Full:
                pass
            self._thread.join(timeout)
            if self._thread.is_alive():
                # still serving past the bounded wait: it owns the queues
                # and exits on its own once everything is served
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
            # the dispatcher still serves past the bounded join: it
            # resolves everything it holds on its own thread
            return
        # no dispatcher ran: serve the remainder here, co-batched
        self._pending.extend(leftovers)
        while self._pending or self._active:
            self._absorb_rebuilds()
            progressed = False
            while self._pending:
                if not self._place(self._pending.popleft()):
                    break   # head parked again: a step must free slots
                progressed = True
            if self._active:
                self._step_all()
            elif not progressed and self._pending:
                if self._recovery_pending(self._pending[0]):
                    time.sleep(0.02)
                    continue
                parked = self._pending.popleft()
                self._resolve_err(parked, parked.last_exc
                                  if parked.last_exc is not None
                                  else ServingUnavailableError(
                                      "drain: no session could take the "
                                      "request"))
        self._dispatcher_exit()

    def _drain_rebuilt(self):
        """Terminal sweep: completed rebuilds no dispatcher will absorb
        are released."""
        while True:
            try:
                si, new, _err, _secs = self._rebuilt.get_nowait()
            except queue.Empty:
                return
            self._rebuilding.discard(si)
            if new is not None:
                try:
                    new.close()
                except Exception:  # noqa: BLE001
                    pass

    def _retire_breaker_gauges(self):
        """Drop this scheduler's per-session health-gauge children, so
        redeploy cycles do not accumulate stale labels on the shared
        registry."""
        if self._breakers is None:
            return
        for breaker in self._breakers:
            breaker.retired = True
        _metrics.REGISTRY.remove_labeled(
            "replica", prefix="g%d:" % self._sched_id)

    def close(self, timeout=5.0):
        """Fast exit: a live dispatcher serves out what it owns (active
        slots and accepted submits) before exiting; with no dispatcher
        running, queued requests fail."""
        for item in self._stop_dispatcher(timeout):
            self._resolve_err(item, RuntimeError("scheduler closed"))
        if self._thread is None:
            self._dispatcher_exit()
        self._retire_breaker_gauges()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
