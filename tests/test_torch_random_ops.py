"""The port's counter-keyed random bits (``paddle_tpu_torch/ops/
random_ops.py``) against JAX's threefry, the reference's decode-side key
schedule (``paddle_tpu/ops/random_ops.py`` ``decoding_key``).

Exact: key words, random bits and uniforms (integer and exact float32
arithmetic). The Gumbel noise goes through two ``log`` implementations
(XLA's float32 one on the CPU; the port's in float64, rounded once, which
is within 1 ulp of it on these keys); its tolerance is 4 float32 ulp at
max(|g|, 1): near g = 0 the error of -log(-log(u)) is absolute (the outer
log of a value near 1), so the ulp of 1 is its scale there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.random_ops import decoding_key as ref_decoding_key
from paddle_tpu_torch.ops import random_ops as port_r

SEEDS = (0, 1, 7, 2 ** 31 - 1)
POSITIONS = (0, 1, 511, 1023, 2047)
N = 32768
# f32 ulp at 1
ULP1 = 2.0 ** -23
GUMBEL_ULPS = 4


def test_threefry_layout_is_partitionable():
    """The port copies the partitionable layout of the random bits; a
    change of this flag's default would change the reference's streams."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_decoding_key_words_equal_reference(seed):
    got = port_r.decoding_key(torch.full((len(POSITIONS),), seed),
                              torch.tensor(POSITIONS))
    want = np.stack([np.asarray(ref_decoding_key(seed, p)) for p in
                     POSITIONS]).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prng_key_and_fold_in_equal_jax():
    for seed in SEEDS:
        key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        np.testing.assert_array_equal(
            port_r.prng_key(seed).numpy(), np.asarray(key).astype(np.int64))
        for data in (0, 3, 2 ** 32 - 1):
            np.testing.assert_array_equal(
                port_r.fold_in(port_r.prng_key(seed), data).numpy(),
                np.asarray(jax.random.fold_in(key, np.uint32(data)))
                .astype(np.int64))


def _keys(seed, pos):
    return ref_decoding_key(seed, pos), \
        port_r.decoding_key(torch.tensor(seed), torch.tensor(pos))


@pytest.mark.parametrize("seed,pos", [(0, 0), (7, 1023), (2 ** 31 - 1, 2047)])
def test_random_bits_bitwise(seed, pos):
    rk, pk = _keys(seed, pos)
    want = np.asarray(jax.random.bits(rk, (N,))).astype(np.int64)
    np.testing.assert_array_equal(port_r.random_bits(pk, N).numpy(), want)


def test_random_bits_rows_are_their_keys_streams():
    """A [R, 2] batch of keys gives each row the stream of its key."""
    keys = port_r.decoding_key(torch.tensor([3, 3, 9]),
                               torch.tensor([5, 6, 5]))
    rows = port_r.random_bits(keys, 257).numpy()
    for i, (s, p) in enumerate(((3, 5), (3, 6), (9, 5))):
        np.testing.assert_array_equal(
            rows[i], np.asarray(jax.random.bits(ref_decoding_key(s, p),
                                                (257,))).astype(np.int64))


@pytest.mark.parametrize("seed,pos", [(1, 1), (7, 511)])
def test_uniform_bitwise(seed, pos):
    rk, pk = _keys(seed, pos)
    tiny = jnp.finfo(jnp.float32).tiny
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.5, 3.0)):
        want = np.asarray(jax.random.uniform(rk, (N,), minval=lo,
                                             maxval=hi))
        got = port_r.uniform(pk, N, minval=float(lo), maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed,pos", [(0, 1), (2 ** 31 - 1, 1023)])
def test_gumbel_within_4_ulp(seed, pos):
    rk, pk = _keys(seed, pos)
    want = np.asarray(jax.random.gumbel(rk, (N,)), np.float64)
    got = port_r.gumbel(pk, N).numpy().astype(np.float64)
    err = np.abs(got - want) / (ULP1 * np.maximum(np.abs(want), 1.0))
    assert err.max() <= GUMBEL_ULPS, (err.max(), int(err.argmax()),
                                      got[err.argmax()], want[err.argmax()])
    assert np.isfinite(got).all()


def test_gumbel_bits_independent_of_threads_and_batching():
    """The noise of a key is a function of the key alone: the same bits
    for a row alone and in a batch, with one CPU thread and with
    several (it is computed in float64 and rounded once)."""
    keys = port_r.decoding_key(torch.tensor([0, 7, 2 ** 31 - 1]),
                               torch.tensor([1, 511, 1023]))
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = port_r.gumbel(keys, N)
        torch.set_num_threads(max(threads, 3))
        many = port_r.gumbel(keys, N)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(one.view(torch.int32), many.view(torch.int32))
    for i in range(keys.shape[0]):
        row = port_r.gumbel(keys[i], N)
        assert torch.equal(row.view(torch.int32), one[i].view(torch.int32))
