"""Autoregressive generation serving: KV-cache sessions and a
continuous-batching scheduler (reference
``paddle_tpu/serving/generation.py``, greedy, core only).

* :class:`GenerationSession` owns one decode batch: ``spec.slots``
  sequences over a model whose per-layer K/V caches stay on the device
  between steps. ``admit()`` prefills a prompt into one free slot and
  returns its first greedy token; ``step()`` decodes one token for every
  active slot, each at its own depth, so sequences admitted at different
  times decode together. The caches are dense ([slots, cache_len,
  d_model] per layer) or, with ``spec.paged``, block pools addressed
  through per-sequence block tables (``serving/paged_cache.py``), with
  copy-on-write sharing of cached prompt prefixes when
  ``spec.prefix_cache`` is on.
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
and metrics; decode policies.

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
from ..models.transformer import kv_dtype
from ..ops.nn_ops import argmax
from . import quant as _quant
from .paged_cache import BlockPool, PoolExhausted, PrefixIndex

__all__ = ["GenerationSpec", "GenerationSession", "GenerationScheduler",
           "ServingOverloadError", "ServingDeadlineError",
           "ServingUnavailableError"]


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
    ``copy_block`` (paged). The paged fields default to the dense
    layout."""

    __slots__ = ("slots", "cache_len", "max_len", "prompt_buckets",
                 "eos_id", "device", "build_model", "dtype", "paged",
                 "block_size", "num_blocks", "max_blocks", "prefix_cache")
    _DEFAULTS = {"dtype": "float32", "paged": False, "block_size": 0,
                 "num_blocks": 0, "max_blocks": 0, "prefix_cache": False}

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
    of an armed weight is kept."""

    def __init__(self, spec, params, arm_quant=None):
        # the amp flag is read at each build and each run, as the
        # reference's executor reads it; generation under amp is not
        # ported (the model's prefill and decode refuse it too)
        if flag_dtype() is not None:
            raise NotImplementedError(
                "KV-cached generation under amp is not ported: turn the "
                "amp flag off to build a session")
        self.spec = spec
        self.device = spec.device
        self.model = spec.build_model(params)
        if arm_quant is None:
            arm_quant = bool(_config.get_flag("serving_quant_compute"))
        self._quant_armed = []
        if arm_quant:
            self._quant_armed = _quant.arm_quant_compute(self.model)
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

    # -- slot bookkeeping ------------------------------------------------
    def free_slots(self):
        return [int(i) for i in np.flatnonzero(~self.active)]

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
        the pool first, and the books are checked to balance at zero."""
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

    # -- execution -------------------------------------------------------
    def admit(self, prompt):
        """Prefill ``prompt`` (1-D int ids) into a free slot and return
        ``(slot, first greedy token)``. Raises RuntimeError when no slot
        is free and ValueError when the prompt fits no bucket.

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
            return self._admit_paged(prompt)
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
        first = int(argmax(logits, -1)[0])
        self.prefills += 1
        self.lengths[slot] = n
        self.last_token[slot] = first
        self.active[slot] = True
        return slot, first

    def _admit_paged(self, prompt):
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
            first = int(argmax(logits, -1)[0])
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
        self._starved.discard(slot)
        self.prefill_log.append((bucket, matched, w))
        if len(self.prefill_log) > 4096:
            del self.prefill_log[:2048]
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
        it at its current length."""
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
        table, starved = None, frozenset()
        if self.paged:
            table = self._prepare_paged(act)
            starved = frozenset(self._starved)
        return (act, starved, self.last_token.reshape(-1, 1).copy(),
                self.lengths.astype(np.int32), table)

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

    def step_run(self, prepared):
        """Phase 2: the device step and the result's application."""
        act, starved, tokens, pos, table = prepared
        dev = self.device
        logits = self.model.decode(
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            None if table is None else torch.from_numpy(table).to(dev))
        nxt = argmax(logits, -1).cpu().numpy()
        self.steps += 1
        result = {}
        for s in act:
            s = int(s)
            if s in starved:
                continue
            self.lengths[s] += 1
            self.last_token[s] = int(nxt[s])
            result[s] = int(nxt[s])
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
        if self.paged:
            self._release_table(slot)
            self._starved.discard(slot)

    def generate(self, prompt, max_new_tokens=None, eos_id=None):
        """Synchronous single-sequence convenience: the greedy
        continuation of ``prompt``, stopping at ``eos_id``,
        ``max_new_tokens`` or an exhausted paged pool, as a list of ids
        (EOS excluded)."""
        eos = self.spec.eos_id if eos_id is None else eos_id
        slot, first = self.admit(prompt)
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
                tokens.append(nxt[slot])
        finally:
            self.retire(slot)
        if tokens[-1] == eos:
            tokens = tokens[:-1]
        return tokens


_STOP = object()


class _GenRequest:
    __slots__ = ("prompt", "max_new", "explicit_budget", "eos_id",
                 "future", "deadline", "tokens", "slot", "session_index")

    def __init__(self, prompt, max_new, explicit_budget, eos_id, deadline):
        self.prompt = prompt
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


class GenerationScheduler:
    """Continuous-batching front door over one or more
    :class:`GenerationSession` replicas.

    ``submit(prompt) -> Future`` resolves to the generated ids as an
    int64 array (greedy continuation, EOS excluded). The dispatcher
    thread admits queued requests into free cache slots (prefill) and
    runs one decode step for every session with active slots, over and
    over; sequences retire slot by slot.

    ``deadline_ms`` (default: the ``serving_deadline_ms`` flag; 0 =
    none) bounds a whole generation: a request whose deadline passes in
    the queue or mid-generation resolves with
    :class:`ServingDeadlineError`. A session whose step or admission
    raises fails the requests it holds with that exception.
    """

    def __init__(self, sessions, max_queue=256, deadline_ms=None,
                 autostart=True):
        if isinstance(sessions, GenerationSession):
            sessions = [sessions]
        if not sessions:
            raise ValueError("need at least one GenerationSession")
        self.sessions = list(sessions)
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

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, timeout=None):
        """Enqueue one prompt; returns a Future of its generated ids.

        ``max_new_tokens`` is capped by the slot capacity left after the
        prompt. ``deadline_ms`` (default: the scheduler's) bounds the
        WHOLE generation. ``timeout``: seconds to wait on a full queue
        before :class:`ServingOverloadError`."""
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
        item = _GenRequest(prompt, max_new, explicit, eos_id, deadline)
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
            slot, first = sess.admit(item.prompt)
        except Exception as exc:  # noqa: BLE001 — the request's outcome
            _resolve(item.future, exception=exc)
            return
        if item.eos_id is None:
            item.eos_id = sess.spec.eos_id
        item.slot = slot
        item.session_index = si
        item.tokens.append(first)
        self._active[(si, slot)] = item
        self._finish_if_done(item)

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
                it.tokens.append(toks[slot])
                self._finish_if_done(it)

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
