"""Paged KV-cache bookkeeping (reference ``paddle_tpu/serving/
paged_cache.py``): the block-pool allocator and the content-hashed
prefix index behind ``generation_paged_kv``.

Each layer's K and V live in one [num_blocks, block_size, d_model] pool;
a sequence owns a host-side block table (the physical block ids backing
its logical positions) and pins only ``ceil(len / block_size)`` blocks.
Both objects are host-only and single-threaded by contract: the
scheduler's dispatcher thread is the only caller, as for the session.

* :class:`BlockPool` — FIFO free list and per-block refcounts. Refcount
  1 is exclusive and writable in place; above 1 the block is shared (by
  another sequence or a prefix-index pin) and a writer copies it first.
* :class:`PrefixIndex` — prompt caching at block granularity: full
  chunks are registered under a chained content hash, a partial tail is
  shared up to the longest common token prefix, registered blocks hold
  one index pin each, and pin-only entries are evicted LRU under pool
  pressure.

Metrics, under the reference's names and help text:
``paddle_generation_prefix_hits_total``, ``_prefix_misses_total``,
``_prefix_shared_tokens_total``, ``_kv_block_cows_total`` (counted by
the session's copy-on-write), ``_kv_pool_evictions_total``,
``_kv_spec_rollback_blocks_total`` (counted by the speculative rollback)
and the gauge ``_kv_blocks_in_use{pool}``; request-trace events
``poolExhausted`` and ``prefixEvict`` (and the session's ``blockCOW``).
One index's own counts are also plain integers on the
:class:`PrefixIndex` (``hits``, ``misses``, ``shared_tokens``, ``cows``,
``evictions``), read through ``stats()``.
"""

import collections
import hashlib
import itertools

import numpy as np

from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace

__all__ = ["BlockPool", "PrefixIndex", "PoolExhausted"]

PREFIX_HITS = _metrics.REGISTRY.counter(
    "paddle_generation_prefix_hits_total",
    "Admissions that reused at least one cached prefix block")
PREFIX_MISSES = _metrics.REGISTRY.counter(
    "paddle_generation_prefix_misses_total",
    "Admissions that found no cached prefix block")
PREFIX_SHARED_TOKENS = _metrics.REGISTRY.counter(
    "paddle_generation_prefix_shared_tokens_total",
    "Prompt tokens served from cached prefix blocks instead of being "
    "re-prefilled")
BLOCK_COWS = _metrics.REGISTRY.counter(
    "paddle_generation_kv_block_cows_total",
    "Copy-on-write block copies (a sequence wrote into a shared "
    "block)")
POOL_EVICTIONS = _metrics.REGISTRY.counter(
    "paddle_generation_kv_pool_evictions_total",
    "Cached prefix blocks reclaimed under pool pressure (LRU, "
    "pin-only entries)")
BLOCKS_IN_USE = _metrics.REGISTRY.gauge(
    "paddle_generation_kv_blocks_in_use",
    "Referenced blocks in one session's pool (labelled per pool — "
    "sessions side by side must not overwrite each other)",
    labelnames=("pool",))
SPEC_ROLLBACKS = _metrics.REGISTRY.counter(
    "paddle_generation_kv_spec_rollback_blocks_total",
    "Blocks returned by speculative-decoding rollbacks (window rows "
    "past the accepted draft prefix)")

_POOL_SEQ = itertools.count()


class PoolExhausted(RuntimeError):
    """No free block and nothing evictable: the pool is at live
    capacity. Admission gates on ``admit_ok``; mid-decode it means the
    growing sequence finishes at its current length."""


class BlockPool:
    """Fixed-size block allocator over one session's K/V pools. One
    block id addresses the same rows of every layer's K and V pool, so
    the allocator is per session. A table entry holds one reference, a
    prefix-index entry one pin; a block returns to the free list exactly
    when its count reaches zero."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("need num_blocks >= 1 and block_size >= 1,"
                             " got %r / %r" % (num_blocks, block_size))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = collections.deque(range(self.num_blocks))
        self._ref = [0] * self.num_blocks
        self._label = "p%d" % next(_POOL_SEQ)
        self._gauge = BLOCKS_IN_USE.labels(pool=self._label)
        self._gauge.set(0)

    def free_count(self):
        return len(self._free)

    def used_count(self):
        return self.num_blocks - len(self._free)

    def refcount(self, block):
        return self._ref[block]

    def alloc(self):
        """One fresh block with refcount 1 (the caller's)."""
        if not self._free:
            # pool pressure decides a request's fate (starve, preempt,
            # park): annotate the active request's trace
            _rtrace.global_event("poolExhausted",
                                 num_blocks=self.num_blocks,
                                 block_size=self.block_size)
            raise PoolExhausted(
                "all %d blocks referenced (%d-row blocks)"
                % (self.num_blocks, self.block_size))
        block = self._free.popleft()
        self._ref[block] = 1
        self._gauge.set(self.used_count())
        return block

    def incref(self, block):
        if self._ref[block] < 1:
            raise RuntimeError("incref on free block %d" % block)
        self._ref[block] += 1

    def decref(self, block):
        """Drop one reference; True when the block was freed."""
        if self._ref[block] < 1:
            raise RuntimeError("decref on free block %d" % block)
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            self._gauge.set(self.used_count())
            return True
        return False

    def truncate_table(self, table, n_blocks):
        """Trim a host block table in place to its first ``n_blocks``
        entries, decref'ing the dropped blocks. Returns how many were
        dropped."""
        surplus = table[n_blocks:]
        if not surplus:
            return 0
        del table[n_blocks:]
        for block in surplus:
            self.decref(block)
        return len(surplus)

    def close(self):
        """Retire this pool's gauge child (label hygiene on session
        teardown)."""
        BLOCKS_IN_USE.remove(pool=self._label)

    def check_invariant(self, tables, index=None):
        """Assert the books balance: every block's refcount equals the
        references the live ``tables`` (iterable of block-id lists) plus
        the ``index`` pins hold, free blocks carry zero references, and
        free + referenced covers the pool. Raises AssertionError with the
        discrepancy."""
        want = collections.Counter()
        for table in tables:
            want.update(int(b) for b in table)
        if index is not None:
            want.update(index.pinned_blocks())
        free = set(self._free)
        assert len(free) == len(self._free), \
            "free list holds duplicates: %r" % (self._free,)
        for block in range(self.num_blocks):
            assert self._ref[block] == want[block], (
                "block %d refcount %d but %d live references "
                "(tables + index pins)"
                % (block, self._ref[block], want[block]))
            assert (self._ref[block] == 0) == (block in free), (
                "block %d refcount %d vs free-list membership %s"
                % (block, self._ref[block], block in free))
        assert len(free) + sum(1 for r in self._ref if r > 0) == \
            self.num_blocks


def _chain_digest(parent, chunk):
    """Content hash of one block-size token chunk chained through its
    left context: the same tokens after a different prefix hash
    differently, so a block is shared only between sequences whose whole
    history up to that block matches."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.ascontiguousarray(chunk, dtype=np.int64).tobytes())
    return h.digest()


class PrefixIndex:
    """Block-granular prompt cache over one :class:`BlockPool`.

    * ``match(tokens)`` — longest cached prefix: full-chunk chain-hash
      hits, then the registered partial tail with the longest common
      token prefix. Returns ``(n_tokens, [block ids])`` without taking
      references (the admitting caller increfs what it keeps).
    * ``register(tokens, table)`` — after a prefill wrote the blocks,
      publish every full chunk and the partial tail of ``tokens``; new
      entries pin their block.
    * ``evict_one()`` — reclaim the LRU entry whose block only the
      index keeps alive.
    """

    def __init__(self, pool):
        self.pool = pool
        self.block_size = pool.block_size
        self._full = {}        # chain digest -> block id
        self._tails = {}       # chain digest -> {token tuple: block id}
        # LRU over every registered entry: ("full", digest) or
        # ("tail", digest, tokens); move_to_end on every hit
        self._lru = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.shared_tokens = 0
        self.cows = 0        # counted by the session's copy-on-write
        self.evictions = 0

    def __len__(self):
        return len(self._lru)

    def pinned_blocks(self):
        """Every block holding an index pin (one per registered entry)."""
        out = list(self._full.values())
        for tails in self._tails.values():
            out.extend(tails.values())
        return out

    def _touch(self, key):
        self._lru[key] = True
        self._lru.move_to_end(key)

    def _walk(self, tokens, touch):
        """Longest cached prefix -> (n_matched, blocks). With ``touch``
        the hit entries refresh their LRU position; without, the walk has
        no side effect at all."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        bs = self.block_size
        digest = b""
        blocks = []
        i = 0
        while (i + 1) * bs <= tokens.size:
            nxt = _chain_digest(digest, tokens[i * bs:(i + 1) * bs])
            block = self._full.get(nxt)
            if block is None:
                break
            digest = nxt
            blocks.append(block)
            if touch:
                self._touch(("full", nxt))
            i += 1
        matched = i * bs
        # partial tail: the longest common token prefix with any tail
        # registered at this chain position (the sharer copies the block
        # before writing past the shared rows)
        rest = tuple(int(t) for t in tokens[matched:matched + bs])
        best_m, best_blk, best_key = 0, None, None
        for tail, block in self._tails.get(digest, {}).items():
            m = 0
            for a, b in zip(tail, rest):
                if a != b:
                    break
                m += 1
            if m > best_m:
                best_m, best_blk = m, block
                best_key = ("tail", digest, tail)
        if best_blk is not None:
            blocks.append(best_blk)
            matched += best_m
            if touch:
                self._touch(best_key)
        return matched, blocks

    def peek(self, tokens):
        """Matched-prefix length only, with no side effects (no
        counters, no LRU touch): what placement consults."""
        matched, _ = self._walk(tokens, touch=False)
        return matched

    def match(self, tokens):
        """Longest cached prefix of ``tokens`` -> (n_matched, blocks).
        The caller caps ``tokens`` (the last prompt token is always
        re-run for its logits). No references are taken here."""
        matched, blocks = self._walk(tokens, touch=True)
        if matched:
            self.hits += 1
            self.shared_tokens += matched
            PREFIX_HITS.inc()
            PREFIX_SHARED_TOKENS.inc(matched)
        else:
            self.misses += 1
            PREFIX_MISSES.inc()
        return matched, blocks

    def register(self, tokens, table):
        """Publish the prompt ``tokens`` whose K/V rows live in
        ``table`` (block ids covering positions [0, len(tokens))).
        Chunks already registered are left as they are; new entries pin
        their block."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        bs = self.block_size
        digest = b""
        nfull = tokens.size // bs
        for i in range(min(nfull, len(table))):
            digest = _chain_digest(digest, tokens[i * bs:(i + 1) * bs])
            if digest not in self._full:
                self._full[digest] = table[i]
                self.pool.incref(table[i])
                self._lru[("full", digest)] = True
            self._touch(("full", digest))
        tail = tuple(int(t) for t in tokens[nfull * bs:])
        if tail and len(table) > nfull:
            tails = self._tails.setdefault(digest, {})
            if tail not in tails:
                tails[tail] = table[nfull]
                self.pool.incref(table[nfull])
                self._lru[("tail", digest, tail)] = True
            self._touch(("tail", digest, tail))

    def _drop(self, key):
        if key[0] == "full":
            block = self._full.pop(key[1])
        else:
            tails = self._tails[key[1]]
            block = tails.pop(key[2])
            if not tails:
                del self._tails[key[1]]
        del self._lru[key]
        self.pool.decref(block)
        return block

    def evictable_count(self):
        """Entries whose block only the index keeps alive: what
        ``admit_ok`` may count as reclaimable."""
        return sum(1 for b in self.pinned_blocks()
                   if self.pool.refcount(b) == 1)

    def evict_one(self):
        """Reclaim the LRU pin-only entry; True when a block was freed.
        Entries whose block a live sequence still references are
        skipped."""
        for key in list(self._lru):
            block = (self._full.get(key[1]) if key[0] == "full"
                     else self._tails.get(key[1], {}).get(key[2]))
            if block is not None and self.pool.refcount(block) == 1:
                self._drop(key)
                self.evictions += 1
                POOL_EVICTIONS.inc()
                _rtrace.global_event("prefixEvict", block=int(block))
                return True
        return False

    def clear(self):
        """Unpin everything (session close)."""
        for key in list(self._lru):
            self._drop(key)

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "shared_tokens": self.shared_tokens,
                "entries": len(self._lru), "cows": self.cows,
                "evictions": self.evictions}
