"""The port's block-pool allocator and prefix index against the
reference's: the same sequence of alloc / incref / decref / register /
match / peek / evict calls through both packages must hand out the same
block ids, match the same lengths and blocks, hash to the same digests,
evict in the same order and agree on every ``check_invariant`` outcome.
Everything here is host-side integer bookkeeping, so equality is exact."""

import numpy as np
import pytest

from paddle_tpu.serving import paged_cache as ref_pc
from paddle_tpu_torch.serving import paged_cache as port_pc

MODULES = (ref_pc, port_pc)


def _alloc(mod, pool, index):
    """The session's allocation rule: evict cold prefix entries before
    giving up."""
    while True:
        try:
            return pool.alloc()
        except mod.PoolExhausted:
            if not index.evict_one():
                raise


def _invariant(pool, tables, index):
    try:
        pool.check_invariant(tables, index)
        return "ok"
    except AssertionError:
        return "broken"


def _drive(mod, seed, steps=400, num_blocks=12, block_size=4):
    """Admissions with shared system prompts, retirements, table
    truncations, evictions and lookups chosen by ``seed``; returns
    everything observable after each call."""
    rs = np.random.RandomState(seed)
    pool = mod.BlockPool(num_blocks, block_size)
    index = mod.PrefixIndex(pool)
    systems = [rs.randint(2, 6, 9) for _ in range(3)]
    tables, trace = [], []
    for _ in range(steps):
        op = rs.randint(6)
        if op <= 1:
            # an admission: a system prompt, a suffix, the reuse cap
            sys_p = systems[rs.randint(len(systems))][:rs.randint(0, 10)]
            toks = np.concatenate([sys_p, rs.randint(2, 6, rs.randint(1, 7))])
            n = toks.size
            matched, shared = index.match(toks[:n - 1])
            trace.append(("match", matched, list(shared)))
            table = list(shared)
            for b in shared:
                pool.incref(b)
            try:
                while len(table) * block_size < n:
                    table.append(_alloc(mod, pool, index))
            except mod.PoolExhausted:
                for b in table:
                    pool.decref(b)
                trace.append(("exhausted",))
                continue
            trace.append(("table", list(table)))
            index.register(toks, table)
            tables.append(table)
        elif op == 2 and tables:
            table = tables.pop(rs.randint(len(tables)))
            trace.append(("freed", [pool.decref(b) for b in table]))
        elif op == 3 and tables:
            table = tables[rs.randint(len(tables))]
            trace.append(("truncated",
                          pool.truncate_table(table, rs.randint(len(table)
                                                                + 1))))
        elif op == 4:
            trace.append(("evicted", index.evict_one()))
        else:
            toks = rs.randint(2, 6, rs.randint(1, 14))
            trace.append(("peek", index.peek(toks)))
        trace.append(("books", pool.free_count(), list(pool._free),
                      [pool.refcount(b) for b in range(num_blocks)],
                      list(index._lru), index.evictable_count(),
                      _invariant(pool, tables, index)))
    stats = index.stats()
    trace.append(("stats", stats["hits"], stats["misses"],
                  stats["shared_tokens"], stats["entries"]))
    index.clear()
    for table in tables:
        for b in table:
            pool.decref(b)
    trace.append(("closed", pool.used_count(), _invariant(pool, [], index)))
    return trace, index


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_call_sequence_identical(seed):
    evictions0 = ref_pc.POOL_EVICTIONS._default().value
    want, _ = _drive(ref_pc, seed)
    ref_evictions = ref_pc.POOL_EVICTIONS._default().value - evictions0
    got, index = _drive(port_pc, seed)
    assert got == want
    kinds = {t[0] for t in want}
    # the sequence really reached sharing, exhaustion and eviction
    assert {"match", "exhausted", "evicted", "truncated"} <= kinds
    assert any(t[0] == "match" and t[1] > 0 for t in want)
    # the reference counts evictions in a Prometheus counter, the port
    # in an integer
    assert index.evictions == ref_evictions > 0


def test_chain_digest_is_blake2b_over_int64():
    chunk = np.asarray([3, 1, 4, 1], np.int64)
    for parent in (b"", ref_pc._chain_digest(b"", chunk)):
        assert port_pc._chain_digest(parent, chunk) == \
            ref_pc._chain_digest(parent, chunk)
        assert port_pc._chain_digest(parent, chunk.astype(np.int32)) == \
            ref_pc._chain_digest(parent, chunk)
        assert len(port_pc._chain_digest(parent, chunk)) == 16


@pytest.mark.parametrize("mod", MODULES, ids=["ref", "port"])
def test_full_chunk_and_partial_tail_matching(mod):
    """The reference's own unit cases, run through both packages."""
    pool = mod.BlockPool(8, 4)
    idx = mod.PrefixIndex(pool)
    toks = np.arange(10, 20)
    table = [pool.alloc(), pool.alloc(), pool.alloc()]
    idx.register(toks, table)
    assert idx.match(toks) == (10, table)
    assert idx.match(np.concatenate([toks[:4], [99, 98, 97, 96]])) == \
        (4, table[:1])
    assert idx.match(np.concatenate([[5, 5, 5, 5], toks[4:8]])) == (0, [])
    pool2 = mod.BlockPool(8, 4)
    idx2 = mod.PrefixIndex(pool2)
    t2 = [pool2.alloc(), pool2.alloc()]
    idx2.register(np.asarray([1, 2, 3, 4, 7, 8, 9]), t2)
    assert idx2.match(np.asarray([1, 2, 3, 4, 7, 8, 5, 5])) == (6, t2)
    assert idx2.match(np.asarray([1, 2, 3, 4, 5])) == (4, t2[:1])
    # peek has no side effects: counters and LRU order unchanged
    before = (idx2.stats(), list(idx2._lru))
    assert idx2.peek(np.asarray([1, 2, 3, 4, 7, 8])) == 6
    assert (idx2.stats(), list(idx2._lru)) == before


@pytest.mark.parametrize("mod", MODULES, ids=["ref", "port"])
def test_eviction_and_invariant_outcomes(mod):
    pool = mod.BlockPool(2, 4)
    idx = mod.PrefixIndex(pool)
    table = [pool.alloc(), pool.alloc()]
    idx.register(np.arange(8), table)
    assert idx.evictable_count() == 0 and not idx.evict_one()
    pool.decref(table[0])
    assert idx.evictable_count() == 1 and idx.evict_one()
    assert pool.free_count() == 1
    pool.check_invariant([[table[1]]], idx)
    with pytest.raises(AssertionError):
        pool.check_invariant([], idx)          # a lost table reference
    full = mod.BlockPool(1, 4)
    full.alloc()
    with pytest.raises(mod.PoolExhausted):
        full.alloc()
    free = mod.BlockPool(2, 4)
    b = free.alloc()
    free.decref(b)
    with pytest.raises(RuntimeError):
        free.decref(b)                         # double free is loud


def test_port_counts_evictions():
    pool = port_pc.BlockPool(2, 4)
    idx = port_pc.PrefixIndex(pool)
    table = [pool.alloc(), pool.alloc()]
    idx.register(np.arange(8), table)
    for b in table:
        pool.decref(b)
    assert idx.evict_one() and idx.evict_one() and not idx.evict_one()
    assert idx.stats()["evictions"] == 2
    assert pool.used_count() == 0
