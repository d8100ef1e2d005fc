"""The port's attention kernels' plain versions against the reference's
Pallas kernels (interpret mode on the CPU) and their plain versions.

Tolerance: float32, atol = rtol = 1e-5. Both sides compute the same
softmax in f32; only the order of the sums differs (the Pallas kernel
accumulates block by block with an online softmax)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention as ref_attn
from paddle_tpu_torch.ops import flash_attention as port_attn

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rs, *shape):
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _seg(lengths, t):
    return (np.arange(t)[None, :] <
            np.asarray(lengths)[:, None]).astype(np.int32)


@pytest.mark.parametrize("causal,lengths,t,block_q", [
    (True, (256, 133), 256, 128),   # two q tiles, padded rows
    (False, (128, 1), 128, 256),    # length 1: one live key per row
    (True, None, 48, 256),          # no segment ids, ragged T
    (False, None, 64, 16),          # non-causal, four q tiles
    (True, (100, 37), 100, 256),    # unaligned T with segment ids
])
def test_flash_attention_matches_reference(causal, lengths, t, block_q):
    rs = np.random.RandomState(t + int(causal))
    b, h, d = 2, 2, 16
    q, k, v = _qkv(rs, b, h, t, d)
    seg = None if lengths is None else _seg(lengths, t)
    want = np.asarray(ref_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        block_q=block_q, interpret=True))
    before = port_attn.flash_attention.launches
    got = port_attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg)).numpy()
    assert port_attn.flash_attention.launches == before  # plain version
    np.testing.assert_allclose(got, want, **TOL)
    if lengths is not None:
        for bi, n in enumerate(lengths):
            # padded query rows are exactly zero, not merely small
            assert not got[bi, :, n:].any()


def test_flash_attention_3d_layout():
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 4, 32, 8)
    want = np.asarray(ref_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    got = port_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True)
    assert got.shape == (4, 32, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_reference_matches_reference(causal):
    rs = np.random.RandomState(5)
    q, k, v = _qkv(rs, 4, 40, 8)
    seg = np.repeat(_seg((40, 13), 40), 2, axis=0)
    want = np.asarray(ref_attn._reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        jnp.asarray(seg)))
    got = port_attn._reference(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal,
                               torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _to_port_cache(x):
    """[S, H, C, D] (reference kernel layout) -> [S, C, H*D] (the
    native cache layout the port's kernel reads)."""
    s, h, c, d = x.shape
    return torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(s, c, h * d))


@pytest.mark.parametrize("c,lengths", [
    (64, (1, 17, 64)),          # length 1, ragged, full cache
    (1024, (513, 1024, 1)),     # several k blocks in the reference
])
def test_decode_attention_matches_reference(c, lengths):
    rs = np.random.RandomState(c)
    s, h, d = len(lengths), 2, 16
    q = rs.standard_normal((s, h, d)).astype(np.float32)
    k = rs.standard_normal((s, h, c, d)).astype(np.float32)
    v = rs.standard_normal((s, h, c, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(ref_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True))
    before = port_attn.decode_attention.launches
    got = port_attn.decode_attention(
        torch.from_numpy(q.reshape(s, h * d)), _to_port_cache(k),
        _to_port_cache(v), torch.from_numpy(lens), h)
    assert port_attn.decode_attention.launches == before
    np.testing.assert_allclose(got.numpy().reshape(s, h, d), want, **TOL)


def test_decode_plain_reference_matches_reference():
    rs = np.random.RandomState(9)
    q = rs.standard_normal((6, 1, 8)).astype(np.float32)
    k = rs.standard_normal((6, 32, 8)).astype(np.float32)
    v = rs.standard_normal((6, 32, 8)).astype(np.float32)
    lens = np.asarray([1, 2, 31, 32, 5, 16], np.int32)
    want = np.asarray(ref_attn._decode_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = port_attn._decode_reference(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 2, 8, 4)
    with pytest.raises(ValueError, match="shapes differ"):
        port_attn.flash_attention(q, q[:, :, :4], q)
    with pytest.raises(ValueError, match="segment_ids"):
        port_attn.flash_attention(q, q, q, segment_ids=torch.ones(2, 4))
    with pytest.raises(ValueError, match="caches"):
        port_attn.decode_attention(torch.zeros(2, 8), torch.zeros(2, 4, 6),
                                   torch.zeros(2, 4, 6),
                                   torch.ones(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_attn.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
