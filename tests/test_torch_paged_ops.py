"""The port's paged KV-cache ops against the reference's, each run
through a one-op reference program (``_run_one_op`` of
``test_torch_generation_ops``).

The port's write ops take the pool as [NB + 1, BS, D] storage whose last
block is the sink for dropped writes; the first NB blocks are compared
with the reference's [NB, BS, D] pool. Tolerances: the cache writes and
the block copy are copies, so they must be equal exactly; the attention
ops are float32 with atol = rtol = 1e-5 (same math, sums in another
order)."""

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu_torch.ops import generation_ops
from test_torch_generation_ops import _run_one_op

TOL = dict(atol=1e-5, rtol=1e-5)


def _storage(pool):
    """The port's pool storage: the reference pool plus a sink block."""
    sink = np.zeros((1,) + pool.shape[1:], pool.dtype)
    return torch.from_numpy(np.concatenate([pool, sink]))


@pytest.mark.parametrize("hist,length,table", [
    (2, 4, (3, 1, 5)),     # hist > 0 crosses a block edge; 2 padding rows
    (0, 6, (4, 0, 2)),     # a full window from position 0
    (3, 6, (2, 5, 1)),     # a dead entry (= NB) inside the window drops
])
def test_write_paged_matches_reference(hist, length, table):
    nb, bs, d = 5, 4, 3
    rs = np.random.RandomState(hist + length)
    pool = rs.standard_normal((nb, bs, d)).astype(np.float32)
    new = rs.standard_normal((1, 6, d)).astype(np.float32)
    table = np.asarray(table, np.int32)
    want = _run_one_op("kv_cache_write_paged",
                       {"Cache": pool, "New": new, "Table": table,
                        "Hist": np.array([hist], np.int32),
                        "Len": np.array([length], np.int32)}, {},
                       cache="Cache")
    got = _storage(pool)
    generation_ops.kv_cache_write_paged(got, torch.from_numpy(new),
                                        torch.from_numpy(table), hist,
                                        length)
    np.testing.assert_array_equal(got[:nb].numpy(), want)
    assert not np.array_equal(want, pool)     # something was written


def test_append_paged_dead_entry_drops_write():
    nb, bs, d = 4, 4, 3
    rs = np.random.RandomState(1)
    pool = rs.standard_normal((nb, bs, d)).astype(np.float32)
    new = rs.standard_normal((4, 1, d)).astype(np.float32)
    pos = np.array([5, 2, 1, 0], np.int32)
    # slot 2 all dead (an inactive slot), slot 3 dead past its entry
    table = np.array([[0, 2], [1, 0], [nb, nb], [nb + 3, 1]], np.int32)
    want = _run_one_op("kv_cache_append_paged",
                       {"Cache": pool, "New": new, "Pos": pos,
                        "Table": table}, {}, cache="Cache")
    got = _storage(pool)
    generation_ops.kv_cache_append_paged(got, torch.from_numpy(new),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(table))
    np.testing.assert_array_equal(got[:nb].numpy(), want)
    changed = {tuple(i[:2]) for i in np.argwhere(want != pool)}
    assert changed == {(2, 1), (1, 2)}        # only the two live slots


def test_block_copy_matches_reference():
    nb, bs, d = 4, 4, 3
    pool = np.random.RandomState(2).standard_normal(
        (nb, bs, d)).astype(np.float32)
    want = _run_one_op("kv_block_copy",
                       {"Cache": pool, "Src": np.array([1], np.int32),
                        "Dst": np.array([3], np.int32)}, {}, cache="Cache")
    got = _storage(pool)
    generation_ops.kv_block_copy(got, 1, 3)
    np.testing.assert_array_equal(got[:nb].numpy(), want)


@pytest.mark.parametrize("hist,length,bucket", [(0, 5, 8), (6, 3, 4),
                                                (5, 8, 8)])
def test_prefill_paged_attention_matches_reference(hist, length, bucket):
    """The window attends the cached prefix plus itself, causally, through
    a scattered table with dead entries past the live blocks."""
    nb, bs, h, hd, mb = 9, 4, 2, 8, 4
    rs = np.random.RandomState(hist * 10 + length)
    q = rs.standard_normal((1, bucket, h * hd)).astype(np.float32)
    ck = rs.standard_normal((nb, bs, h * hd)).astype(np.float32)
    cv = rs.standard_normal((nb, bs, h * hd)).astype(np.float32)
    live = -(-(hist + length) // bs)
    table = np.full(mb, nb, np.int32)
    table[:live] = rs.permutation(nb)[:live]
    want = _run_one_op("multihead_attention_prefill_paged",
                       {"Q": q, "CacheK": ck, "CacheV": cv, "Table": table,
                        "Hist": np.array([hist], np.int32),
                        "Len": np.array([length], np.int32)},
                       {"num_heads": h}, out_shape=q.shape)
    got = generation_ops.multihead_attention_prefill_paged(
        torch.from_numpy(q), _storage(ck), _storage(cv),
        torch.from_numpy(table), hist, h)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_decode_paged_attention_matches_reference(flash):
    """The reference op with ``flash_attention`` off (its gather
    reference) and on (its Pallas kernel, interpreted)."""
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=flash)
    try:
        nb, bs, h, hd, mb = 10, 4, 2, 8, 3
        rs = np.random.RandomState(5)
        q = rs.standard_normal((3, 1, h * hd)).astype(np.float32)
        ck = rs.standard_normal((nb, bs, h * hd)).astype(np.float32)
        cv = rs.standard_normal((nb, bs, h * hd)).astype(np.float32)
        pos = np.array([0, 6, 11], np.int32)
        table = np.array([[7, nb, nb], [2, 9, nb], [4, 0, 8]], np.int32)
        want = _run_one_op("multihead_attention_decode_paged",
                           {"Q": q, "CacheK": ck, "CacheV": cv, "Pos": pos,
                            "Table": table}, {"num_heads": h},
                           out_shape=q.shape)
    finally:
        ptpu.config.set_flags(flash_attention=prev)
    got = generation_ops.multihead_attention_decode_paged(
        torch.from_numpy(q), _storage(ck), _storage(cv),
        torch.from_numpy(pos), torch.from_numpy(table), h)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
