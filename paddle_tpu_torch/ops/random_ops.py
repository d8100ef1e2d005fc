"""Counter-keyed random bits for decoding (reference
``paddle_tpu/ops/random_ops.py`` ``decoding_key``, and the parts of JAX's
threefry PRNG it reaches: ``jax._src.prng`` with
``jax_threefry_partitionable`` on, and ``jax._src.random`` ``_uniform``
and ``_gumbel``).

Every function here is integer or floating-point arithmetic in torch
ops, on the device of its inputs. torch has no unsigned 32-bit arithmetic, so a
uint32 word is held in an int64 tensor, masked to its low 32 bits after
each add and rotate. The random bits and the uniforms are bitwise JAX's;
the Gumbel noise is computed in float64 and rounded once, so it is the
same on every device and in every CPU vector path, and agrees with XLA's
float32 ``log`` to an ulp.

Serving code draws every decode-side key through :func:`decoding_key`
and never from torch's own generators (a test greps for them): the key
of position *i* depends only on ``(seed, i)``, which is what makes a
sampled stream replayable.
"""

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "decoding_key",
           "random_bits", "uniform", "gumbel", "F32_TINY"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jnp.finfo(float32).tiny: the uniform's default minval under the Gumbel
F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None):
    """An int64 tensor holding the uint32 value of ``x`` (an int, a numpy
    array or a tensor), wrapped modulo 2**32 as a cast to uint32 wraps."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key
    words ``(k1, k2)``, 20 rounds (``jax._src.prng
    _threefry2x32_lowering``). All four are int64 tensors of uint32
    values that broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))``: the key
    words ``[0, seed]``, [..., 2] int64 for a tensor of seeds."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` with ``data`` cast to uint32:
    ``threefry_2x32(key, threefry_seed(data))``, the counter words
    ``(0, data)``. ``key`` [..., 2] and ``data`` broadcast over the
    leading dims."""
    d = _u32(data, key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def decoding_key(seed, position, device=None):
    """THE decode-side key schedule: ``fold_in(prng_key(seed),
    position)``, elementwise over tensors of seeds and positions (the
    reference vmaps it over rows). Returns [..., 2] int64 key words.
    ``position`` is the sequence index of the token being generated."""
    return fold_in(prng_key(seed, device),
                   _u32(position, device))


def random_bits(key, n):
    """``jax.random.bits(key, (n,))``, 32 bits in the partitionable
    layout: the counters are the 64-bit iota as (hi, lo) = (0, index),
    the bits ``bits1 ^ bits2``. ``key`` [..., 2] gives [..., n] int64
    tensors of uint32 values."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the
    23 high bits as a mantissa under exponent 0 (a float in [1, 2)),
    minus 1, scaled, shifted and clamped below at ``minval``. Bitwise
    JAX's: XLA contracts the scale and shift into one fused multiply-add,
    so they are computed in float64 (the float32 product is exact there)
    and rounded once."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,))`` in its default "low" mode:
    ``-log(-log(u))`` with u uniform on [tiny, 1). Both logs run in
    float64 and the result is rounded to float32 once. A float32 ``log``
    is not correctly rounded, and torch's on the CPU and the card's
    differ by an ulp here and there; the float64 value rounded once is
    the same on both but for a double-rounding tie."""
    u = uniform(key, n, minval=F32_TINY).double()
    return (-torch.log(-torch.log(u))).float()
