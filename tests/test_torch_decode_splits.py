"""The decompositions of the two decode kernels, modelled in torch on the
CPU and held to the plain versions and to the reference.

* Kernel B3 at decode (``csrc/int8_matmul.cu`` ``int8_gemv_kernel``)
  splits k into the chunks ``quant_ops._plan`` gives and adds the
  chunks' int32 partial sums before the f32 epilogue. The model does
  the same with torch int32 products; it is bitwise equal to
  ``int8_matmul_plain``, to the reference's ``_dense_int8_matmul``
  (compiled, as its executor runs it) and to its Pallas kernel
  ``_pallas_int8_matmul`` in interpret mode, at m 1, 8 and 16, k ragged
  against the chunk, every split count a plan can take, and a zero row.
* Kernel B5 (``csrc/decode_attention_paged.cu``) cuts each slot's
  logical rows into chunks, computes a partial (m, l, acc) per chunk and
  combines the chunks in chunk order. The model does the same in f32
  torch ops; it is within 1e-5 of the plain
  ``_decode_paged_reference`` and of the reference's
  ``decode_attention_paged`` in interpret mode, with lengths at chunk
  boundaries, scattered tables, NaN-poisoned unreferenced blocks and an
  all-dead row.
* B5's determinism rule: chunk boundaries are logical row indices, so a
  slot's output depends on its q, its live rows and its length alone.
  Under any two permutations of the block ids holding the same logical
  rows the model's outputs are bitwise equal (a property test).

The models live here, not in the package: the package has the kernels
and their plain versions."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention as ref_pa
from paddle_tpu.ops import quant_ops as ref_q
from paddle_tpu.serving import quant as ref_sq
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.ops import quant_ops as port_q

TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- B3


def split_k_model(x, wq, ws, plan):
    """B3's decode kernel in torch: x quantized per row once, each k
    chunk's exact int32 product, the chunks' sums added in chunk order,
    then acc * x_scale * w_scale."""
    k = x.shape[1]
    xq, xs = port_q.quantize_rows(x)
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.int32)
    for j in range(plan.splits):
        lo, hi = j * plan.kc, min((j + 1) * plan.kc, k)
        assert lo < hi, "an empty chunk"
        acc += torch.matmul(xq[:, lo:hi].to(torch.int32),
                            wq[lo:hi].to(torch.int32))
    return acc.to(torch.float32) * xs * ws[None, :]


B3_CASES = [(m, k, n, splits) for m in (1, 8, 16)
            for k, n in ((1000, 40), (300, 33), (2048, 24))
            for splits in (None, 1, 2, 4, 8)]


def _b3_ids(c):
    m, k, n, splits = c
    return "m%d-k%d-n%d-%s" % (m, k, n, "plan" if splits is None else
                               "s%d" % splits)


@pytest.mark.parametrize("case", B3_CASES, ids=_b3_ids)
def test_b3_split_k_model_bitwise(case):
    m, k, n, splits = case
    plan = port_q._plan(m, k, n, splits=splits)
    assert plan.tile == -1
    rs = np.random.RandomState(m * 7 + k)
    x = rs.standard_normal((m, k)).astype(np.float32)
    if m > 1:
        x[m // 2] = 0.0
    wq, ws = ref_sq.quantize_array(
        rs.standard_normal((k, n)).astype(np.float32) * np.float32(0.02), 1)
    t = torch.from_numpy
    got = split_k_model(t(x), t(wq), t(ws), plan).numpy()
    assert np.array_equal(got, port_q.int8_matmul_plain(t(x), t(wq),
                                                        t(ws)).numpy())
    dense = np.asarray(jax.jit(ref_q._dense_int8_matmul)(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))
    assert np.array_equal(got, dense)
    if splits is None:    # the reference's kernel once a shape
        pallas = np.asarray(ref_q._pallas_int8_matmul(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
            interpret=True))
        assert np.array_equal(got, pallas)
    if m > 1:
        assert not got[m // 2].any()


# ---------------------------------------------------------------- B5


def chunk_bounds(length, chunk):
    """The logical row ranges [c0, c1) of a slot's chunks: a function of
    its length and the chunk alone."""
    return [(c0, min(c0 + chunk, length)) for c0 in range(0, length, chunk)]


def split_key_model(q, k_pool, v_pool, lengths, tables, heads, chunk):
    """B5 in torch: per slot and head, each chunk's softmax partial
    (m, l, acc) over its logical rows, combined in chunk order as the
    reference's _finish divides: acc / max(l, 1e-30)."""
    s, hd = q.shape
    nb, bs, _ = k_pool.shape
    mb = tables.shape[1]
    d = hd // heads
    tbl = tables.long().clamp(0, nb - 1)
    kf = k_pool.float().reshape(nb * bs, heads, d)
    vf = v_pool.float().reshape(nb * bs, heads, d)
    out = torch.zeros((s, hd), dtype=torch.float32)
    for si in range(s):
        length = min(max(int(lengths[si]), 0), mb * bs)
        rows = torch.arange(length)
        phys = tbl[si, rows // bs] * bs + rows % bs
        kk, vv = kf[phys], vf[phys]
        qh = q[si].reshape(heads, d)
        m_all = torch.full((heads,), -1e30)
        parts = []
        for c0, c1 in chunk_bounds(length, chunk):
            sc = torch.einsum("hd,lhd->hl", qh, kk[c0:c1]) * d ** -0.5
            m = sc.max(dim=-1).values
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hl,lhd->hd", p,
                                                      vv[c0:c1])))
            m_all = torch.maximum(m_all, m)
        l_all = torch.zeros(heads)
        acc = torch.zeros(heads, d)
        for m, l, a in parts:
            f = torch.exp(m - m_all)
            l_all = l_all + l * f
            acc = acc + a * f[:, None]
        out[si] = (acc / l_all.clamp(min=1e-30)[:, None]).reshape(hd)
    return out


def _paged(rs, lens, heads, d, nb, bs, mb, perm=None, content=None):
    """NaN-poisoned pools holding each slot's logical rows (``content``
    [S, MB*BS, 2, H*D], drawn if None) in blocks ``perm`` hands out,
    scattered tables (dead entries NB; a slot of length 0 gets an
    all-dead row and runs at length 1) and lengths."""
    s, hd = len(lens), heads * d
    if content is None:
        content = rs.standard_normal((s, mb * bs, 2, hd)).astype(np.float32)
    perm = iter(rs.permutation(nb) if perm is None else perm)
    tables = np.full((s, mb), nb, np.int32)
    pools = np.full((2, nb, bs, hd), np.nan, np.float32)
    for si, n in enumerate(lens):
        for j in range(-(-n // bs)):
            b = next(perm)
            tables[si, j] = b
            pools[:, b] = content[si, j * bs:(j + 1) * bs].transpose(1, 0, 2)
    lengths = np.asarray([max(n, 1) for n in lens], np.int32)
    return content, pools[0], pools[1], lengths, tables


B5_CASES = [dict(heads=2, d=8, bs=4, mb=6, chunk=5),
            dict(heads=2, d=16, bs=3, mb=7, chunk=6),
            dict(heads=4, d=8, bs=1, mb=9, chunk=4),
            dict(heads=2, d=8, bs=4, mb=6, chunk=8)]


@pytest.mark.parametrize("cfg", B5_CASES,
                         ids=lambda c: "bs%d-chunk%d" % (c["bs"], c["chunk"]))
def test_b5_split_key_model_matches_plain_and_reference(cfg):
    heads, d, bs, mb, chunk = (cfg[k] for k in ("heads", "d", "bs", "mb",
                                                "chunk"))
    cap = mb * bs
    lens = [chunk - 1, chunk, chunk + 1, min(2 * chunk + 1, cap), cap, 1, 0]
    s = len(lens)
    nb = s * mb + 1
    rs = np.random.RandomState(chunk * 11 + bs)
    _, pk, pv, lengths, tables = _paged(rs, lens, heads, d, nb, bs, mb)
    q = rs.standard_normal((s, heads * d)).astype(np.float32)
    t = torch.from_numpy
    pk0, pv0 = np.nan_to_num(pk), np.nan_to_num(pv)
    got = split_key_model(t(q), t(pk0), t(pv0), t(lengths), t(tables), heads,
                          chunk).numpy()
    plain = port_fa.decode_attention_paged(t(q), t(pk0), t(pv0), t(lengths),
                                           t(tables), heads).numpy()
    live = slice(0, s - 1)      # the all-dead row reads block NB - 1
    np.testing.assert_allclose(got[live], plain[live], **TOL)
    kernel = np.asarray(ref_pa.decode_attention_paged(
        jnp.asarray(q[:, None]), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(lengths), jnp.asarray(tables), heads,
        interpret=True))[:, 0]
    np.testing.assert_allclose(got[live], kernel[live], **TOL)


def test_b5_split_key_model_at_the_plans_chunk():
    """At head dim 64 the plan's own chunk (128 rows): lengths around
    it, the table's full width, and a slot at 1."""
    heads, d, bs, mb = 2, 64, 16, 20
    chunk = port_fa._paged_plan(4, heads, d, bs, mb).chunk
    assert chunk == 128
    lens = [chunk - 1, chunk + 1, mb * bs, 1]
    rs = np.random.RandomState(5)
    _, pk, pv, lengths, tables = _paged(rs, lens, heads, d,
                                        len(lens) * mb, bs, mb)
    q = rs.standard_normal((len(lens), heads * d)).astype(np.float32)
    t = torch.from_numpy
    pk0, pv0 = np.nan_to_num(pk), np.nan_to_num(pv)
    got = split_key_model(t(q), t(pk0), t(pv0), t(lengths), t(tables), heads,
                          chunk).numpy()
    plain = port_fa.decode_attention_paged(t(q), t(pk0), t(pv0), t(lengths),
                                           t(tables), heads).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    gather = np.asarray(ref_pa._decode_paged_reference(
        jnp.asarray(q[:, None]), jnp.asarray(pk0), jnp.asarray(pv0),
        jnp.asarray(lengths), jnp.asarray(tables), heads))[:, 0]
    np.testing.assert_allclose(got, gather, **TOL)


@settings(max_examples=25, deadline=None, database=None)
@given(lens=st.lists(st.integers(1, 24), min_size=1, max_size=4),
       chunk=st.integers(1, 9), seeds=st.tuples(st.integers(0, 2 ** 16),
                                                st.integers(0, 2 ** 16)))
def test_b5_chunks_depend_on_the_length_alone(lens, chunk, seeds):
    """The same logical rows under two permutations of the block ids:
    the chunk boundaries are the same function of each slot's length,
    and the model's outputs are bitwise equal."""
    heads, d, bs, mb = 2, 4, 3, 8
    nb = len(lens) * mb + 2
    rs = np.random.RandomState(seeds[0])
    content = rs.standard_normal(
        (len(lens), mb * bs, 2, heads * d)).astype(np.float32)
    q = torch.from_numpy(
        rs.standard_normal((len(lens), heads * d)).astype(np.float32))
    outs = []
    for seed in seeds:
        perm = np.random.RandomState(seed + 1).permutation(nb)
        _, pk, pv, lengths, tables = _paged(rs, lens, heads, d, nb, bs, mb,
                                            perm=perm, content=content)
        t = torch.from_numpy
        outs.append(split_key_model(q, t(np.nan_to_num(pk)),
                                    t(np.nan_to_num(pv)), t(lengths),
                                    t(tables), heads, chunk))
        assert [chunk_bounds(int(n), chunk) for n in lengths] == \
            [chunk_bounds(n, chunk) for n in lens]
    assert torch.equal(outs[0], outs[1])
