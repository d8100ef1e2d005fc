"""Kernel B5's plain version (``decode_attention_paged`` on CPU tensors)
against the reference's Pallas kernel ``decode_attention_paged`` in
interpret mode and its ``_decode_paged_reference``, and against the
port's own dense decode on the hand-gathered cache.

Tables are scattered and unordered; for the live slots every pool block
no table references is NaN-poisoned, so the Pallas kernel fails loudly
if it reads a wrong block. Lengths cross block edges (1, BS, BS + 1 and
MB * BS), and one slot has an all-dead table row (entries = NB), as the
session gives inactive slots. Tolerances: 1e-5 against the reference
(float32, sums in another order); 1e-6 against the port's dense decode,
which runs the same torch code after the gather."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention as ref_pa
from paddle_tpu_torch.ops import flash_attention as port_fa

TOL = dict(atol=1e-5, rtol=1e-5)
DENSE_TOL = dict(atol=1e-6, rtol=1e-6)


def _case(seed, heads, hd, nb, bs, mb):
    """q [S, H*D], NaN-poisoned pools, scattered tables, lengths."""
    rs = np.random.RandomState(seed)
    d = heads * hd
    lengths = np.asarray([1, bs, bs + 1, mb * bs, 1], np.int32)
    s = lengths.size
    tables = np.full((s, mb), nb, np.int32)   # the last row stays dead
    pool_k = np.full((nb, bs, d), np.nan, np.float32)
    pool_v = np.full((nb, bs, d), np.nan, np.float32)
    used = iter(rs.permutation(nb - 1))       # block nb-1: below
    for si in range(s - 1):
        for j in range(-(-int(lengths[si]) // bs)):
            b = next(used)
            tables[si, j] = b
            pool_k[b] = rs.standard_normal((bs, d))
            pool_v[b] = rs.standard_normal((bs, d))
    # the dead row's ids clip to nb-1: give that block data, so the dead
    # slot's output is finite (and compared) on both sides
    pool_k[nb - 1] = rs.standard_normal((bs, d))
    pool_v[nb - 1] = rs.standard_normal((bs, d))
    q = rs.standard_normal((s, d)).astype(np.float32)
    return q, pool_k, pool_v, lengths, tables


CASES = [dict(heads=2, hd=8, nb=14, bs=4, mb=4),
         dict(heads=2, hd=16, nb=20, bs=3, mb=5),
         dict(heads=4, hd=8, nb=24, bs=1, mb=6)]


@pytest.mark.parametrize("cfg", CASES, ids=lambda c: "bs%d" % c["bs"])
def test_plain_matches_reference_kernel_and_gather(cfg):
    q, pk, pv, lengths, tables = _case(0, **cfg)
    heads = cfg["heads"]
    t = torch.from_numpy
    got = port_fa.decode_attention_paged(
        t(q), t(np.nan_to_num(pk)), t(np.nan_to_num(pv)), t(lengths),
        t(tables), heads).numpy()
    assert np.isfinite(got).all()
    kernel = np.asarray(ref_pa.decode_attention_paged(
        jnp.asarray(q[:, None]), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(lengths), jnp.asarray(tables), heads,
        interpret=True))[:, 0]
    np.testing.assert_allclose(got, kernel, **TOL)
    gather = np.asarray(ref_pa._decode_paged_reference(
        jnp.asarray(q[:, None]), jnp.asarray(np.nan_to_num(pk)),
        jnp.asarray(np.nan_to_num(pv)), jnp.asarray(lengths),
        jnp.asarray(tables), heads))[:, 0]
    np.testing.assert_allclose(got, gather, **TOL)
    assert port_fa.decode_attention_paged.launches == 0   # CPU: plain


@pytest.mark.parametrize("cfg", CASES, ids=lambda c: "bs%d" % c["bs"])
def test_plain_equals_dense_decode_on_gathered_cache(cfg):
    q, pk, pv, lengths, tables = _case(1, **cfg)
    pk, pv = np.nan_to_num(pk), np.nan_to_num(pv)
    nb, bs, d = pk.shape
    s, mb = tables.shape
    tbl = np.clip(tables, 0, nb - 1)
    kc = pk[tbl].reshape(s, mb * bs, d)
    vc = pv[tbl].reshape(s, mb * bs, d)
    t = torch.from_numpy
    got = port_fa.decode_attention_paged(t(q), t(pk), t(pv), t(lengths),
                                         t(tables), cfg["heads"])
    dense = port_fa.decode_attention(t(q), t(kc), t(vc), t(lengths),
                                     cfg["heads"])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **DENSE_TOL)


def test_rejects_mismatched_shapes():
    q = torch.zeros(2, 16)
    pool = torch.zeros(5, 4, 16)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="tables"):
        port_fa.decode_attention_paged(q, pool, pool, lengths,
                                       torch.zeros(3, 2, dtype=torch.int32),
                                       2)
    with pytest.raises(ValueError, match="pools"):
        port_fa.decode_attention_paged(q, torch.zeros(5, 4, 8), pool,
                                       lengths,
                                       torch.zeros(2, 2, dtype=torch.int32),
                                       2)
