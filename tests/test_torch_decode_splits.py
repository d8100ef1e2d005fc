"""The decompositions of the decode kernels, modelled in torch on the CPU
and held to the plain versions and to the reference.

* Kernel B3 at decode (``csrc/int8_matmul.cu`` ``int8_gemv_kernel``)
  splits k into the chunks ``quant_ops._plan`` gives and adds the
  chunks' int32 partial sums before the f32 epilogue. The model does
  the same with torch int32 products; it is bitwise equal to
  ``int8_matmul_plain``, to the reference's ``_dense_int8_matmul``
  (compiled, as its executor runs it) and to its Pallas kernel
  ``_pallas_int8_matmul`` in interpret mode, at m 1, 8 and 16, k ragged
  against the chunk, every split count a plan can take, and a zero row.
* Kernels B4 (``csrc/decode_attention.cu``, a dense cache) and B5
  (``csrc/decode_attention_paged.cu``, a paged pool) share one split-key
  body (``csrc/decode_split.cuh``): each slot's logical rows are cut
  into chunks, a chunk into warps' batches of rows with an online
  softmax, the warps combined in warp order into the chunk's partial
  (m, l, acc), the chunks in chunk order. :func:`split_model` does the
  same in f32 torch ops over a row-address map; through the block table
  (:func:`split_key_model`) it is within 1e-5 of the plain
  ``_decode_paged_reference`` and of the reference's
  ``decode_attention_paged`` in interpret mode, with lengths at chunk
  boundaries, scattered tables, NaN-poisoned unreferenced blocks and an
  all-dead row; over a dense cache (:func:`dense_split_model`) within
  1e-5 of ``decode_attention_plain`` and of the reference's
  ``decode_attention`` in interpret mode, a slot of length 0 exactly 0.
* The determinism rule: chunk and batch boundaries are logical row
  indices, so a slot's output depends on its q, its live rows and its
  length alone. Under any two permutations of the block ids holding the
  same logical rows the paged model's outputs are bitwise equal, and the
  dense model's outputs are bitwise equal to the paged model's on the
  same logical rows (property tests): B4 and B5 give the same tokens.

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
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

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


def batch_rows(d, itemsize):
    """Rows in a warp's batch of the shared body at head dim ``d``: a
    lane loads 16 bytes of a row, so a row takes d / (16 / itemsize)
    lanes and a warp-wide load 32 / that rows; SPLIT_LOADS such loads."""
    dtype = {4: torch.float32, 2: torch.bfloat16}[itemsize]
    return 32 // (d // (16 // itemsize)) * port_fa.SPLIT_LOADS[dtype]


def split_model(q, k_rows, v_rows, lengths, heads, chunk, cap, address,
                rb=8, warps=port_fa.SPLIT_WARPS):
    """The split-key body of B4 and B5 in torch over a row-address map:
    ``address(s, rows)`` gives the indices into ``k_rows``/``v_rows``
    ([N, H*D]) of slot s's logical ``rows``. Per slot and head, the
    logical rows below min(max(length, 0), cap) are cut into chunks of
    ``chunk``; in a chunk, warp w takes the batches of ``rb`` rows that
    start at c0 + w rb, c0 + (w + warps) rb, ..., with an online softmax
    across them; the warps' (m, l, acc) are combined in warp order into
    the chunk's partial, the partials in chunk order, then
    acc / max(l, 1e-30) (the reference's _finish; 0 for a slot of length
    0)."""
    s, hd = q.shape
    d = hd // heads
    kf = k_rows.float().reshape(-1, heads, d)
    vf = v_rows.float().reshape(-1, heads, d)
    neg = torch.full((heads,), -1e30)

    def merge(states):
        m_all = neg
        for m, _, _ in states:
            m_all = torch.maximum(m_all, m)
        l_all, acc = torch.zeros(heads), torch.zeros(heads, d)
        for m, l, a in states:
            f = torch.exp(m - m_all)
            l_all = l_all + l * f
            acc = acc + a * f[:, None]
        return m_all, l_all, acc

    out = torch.zeros((s, hd), dtype=torch.float32)
    for si in range(s):
        length = min(max(int(lengths[si]), 0), cap)
        qh = q[si].reshape(heads, d)
        parts = []
        for c0, c1 in chunk_bounds(length, chunk):
            warps_states = []
            for w in range(warps):
                m, l, acc = neg, torch.zeros(heads), torch.zeros(heads, d)
                for b0 in range(c0 + w * rb, c1, warps * rb):
                    idx = address(si, torch.arange(b0, min(b0 + rb, c1)))
                    sc = torch.einsum("hd,lhd->hl", qh, kf[idx]) * d ** -0.5
                    m_new = torch.maximum(m, sc.max(dim=-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + torch.einsum(
                        "hl,lhd->hd", p, vf[idx])
                    m = m_new
                warps_states.append((m, l, acc))
            parts.append(merge(warps_states))
        _, l_all, acc = merge(parts)
        out[si] = (acc / l_all.clamp(min=1e-30)[:, None]).reshape(hd)
    return out


def split_key_model(q, k_pool, v_pool, lengths, tables, heads, chunk, rb=8):
    """B5: :func:`split_model` through the block table, block ids
    clipped into [0, NB)."""
    nb, bs, hd = k_pool.shape
    tbl = tables.long().clamp(0, nb - 1)
    return split_model(
        q, k_pool.reshape(nb * bs, hd), v_pool.reshape(nb * bs, hd),
        lengths, heads, chunk, tables.shape[1] * bs,
        lambda s, rows: tbl[s, rows // bs] * bs + rows % bs, rb)


def dense_split_model(q, k_cache, v_cache, lengths, heads, chunk, rb=8):
    """B4: :func:`split_model` over a dense [S, C, H*D] cache, logical row
    c of slot s at row s * C + c."""
    s, c, hd = k_cache.shape
    return split_model(q, k_cache.reshape(s * c, hd),
                       v_cache.reshape(s * c, hd), lengths, heads, chunk, c,
                       lambda si, rows: si * c + rows, rb)


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


@pytest.mark.parametrize("cfg", [dict(heads=2, d=8, c=24, chunk=5, rb=2),
                                 dict(heads=2, d=16, c=30, chunk=8, rb=3),
                                 dict(heads=4, d=8, c=17, chunk=4, rb=1),
                                 dict(heads=2, d=64, c=40, chunk=16,
                                      rb=batch_rows(64, 4))],
                         ids=lambda c: "c%d-chunk%d-rb%d" % (
                             c["c"], c["chunk"], c["rb"]))
def test_b4_dense_split_model_matches_plain_and_reference(cfg):
    """B4's model at lengths around the chunk, the cache's full width and
    1: within 1e-5 of the plain version and of the reference's
    decode_attention in interpret mode; a slot of length 0 gives exact
    zeros (the plain version gives V's mean there, the reference
    garbage, so that slot is left out of those two comparisons)."""
    heads, d, c, chunk, rb = (cfg[k] for k in ("heads", "d", "c", "chunk",
                                                "rb"))
    lens = [chunk - 1, chunk, chunk + 1, min(2 * chunk + 1, c), c, 1, 0]
    s = len(lens)
    rs = np.random.RandomState(c * 7 + chunk)
    q = rs.standard_normal((s, heads * d)).astype(np.float32)
    kc, vc = (rs.standard_normal((s, c, heads * d)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray(lens, np.int32)
    t = torch.from_numpy
    got = dense_split_model(t(q), t(kc), t(vc), t(lengths), heads, chunk,
                            rb).numpy()
    assert not got[-1].any()
    live = slice(0, s - 1)
    plain = port_fa.decode_attention_plain(t(q), t(kc), t(vc), t(lengths),
                                           heads).numpy()
    np.testing.assert_allclose(got[live], plain[live], **TOL)
    heads_first = lambda x: x.reshape(s, c, heads, d).transpose(0, 2, 1, 3)
    kernel = np.asarray(ref_pa.decode_attention(
        jnp.asarray(q.reshape(s, heads, d)), jnp.asarray(heads_first(kc)),
        jnp.asarray(heads_first(vc)), jnp.asarray(lengths),
        interpret=True)).reshape(s, heads * d)
    np.testing.assert_allclose(got[live], kernel[live], **TOL)


def test_b4_dense_split_model_at_the_plans_chunk():
    """At head dim 64 and the plan's own chunk (128 rows), f32 batch rows:
    lengths around the chunk and the cache's full width."""
    heads, d, c = 2, 64, 300
    chunk = port_fa._split_plan(3, heads, d, c).chunk
    assert chunk == 128
    lens = [chunk - 1, chunk + 1, c]
    rs = np.random.RandomState(9)
    q = rs.standard_normal((3, heads * d)).astype(np.float32)
    kc, vc = (rs.standard_normal((3, c, heads * d)).astype(np.float32)
              for _ in range(2))
    t = torch.from_numpy
    lengths = t(np.asarray(lens, np.int32))
    got = dense_split_model(t(q), t(kc), t(vc), lengths, heads, chunk,
                            batch_rows(d, 4))
    plain = port_fa.decode_attention_plain(t(q), t(kc), t(vc), lengths,
                                           heads)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@settings(max_examples=25, deadline=None, database=None)
@given(lens=st.lists(st.integers(0, 30), min_size=1, max_size=4),
       chunk=st.integers(1, 12), bs=st.integers(1, 8),
       rb=st.integers(1, 5), seed=st.integers(0, 2 ** 16))
def test_b4_dense_model_bitwise_equal_to_b5_model(lens, chunk, bs, rb, seed):
    """The same logical rows in a dense cache and in a paged pool
    (scattered blocks, NaN-poisoned unreferenced ones; a slot of length
    0 runs at length 0 in both): the dense model's outputs are bitwise
    equal to the paged model's, since the chunk, batch and combine order
    depend on the logical row alone."""
    heads, d = 2, 4
    mb = -(-30 // bs)
    cap = mb * bs
    s = len(lens)
    rs = np.random.RandomState(seed)
    content, pk, pv, _, tables = _paged(rs, lens, heads, d, s * mb + 1, bs,
                                        mb)
    q = torch.from_numpy(rs.standard_normal((s, heads * d))
                         .astype(np.float32))
    lengths = torch.tensor(lens, dtype=torch.int32)
    t = torch.from_numpy
    paged = split_key_model(q, t(pk), t(pv), lengths, t(tables), heads,
                            chunk, rb)
    kc = np.ascontiguousarray(content[:, :cap, 0])
    vc = np.ascontiguousarray(content[:, :cap, 1])
    dense = dense_split_model(q, t(kc), t(vc), lengths, heads, chunk, rb)
    assert torch.equal(dense, paged)
    assert torch.isfinite(dense).all()
    for si, n in enumerate(lens):
        if n == 0:
            assert not dense[si].any()
