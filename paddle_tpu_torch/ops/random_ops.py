"""Counter-keyed random bits for decoding and the random ops of a
program (reference ``paddle_tpu/ops/random_ops.py`` ``decoding_key``,
``gaussian_random`` and ``uniform_random``, and the parts of JAX's
threefry PRNG they reach: ``jax._src.prng`` with
``jax_threefry_partitionable`` on, and ``jax._src.random`` ``split``,
``_uniform``, ``_normal_real`` and ``_gumbel``).

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

The executor splits the scope's key before each random op
(:func:`split`), so a program's ``uniform_random`` draws the reference's
floats bit for bit, and its ``gaussian_random`` the reference's within 2
ulp: XLA's float32 ``erf_inv`` is a polynomial, which :func:`_erf_inv`
evaluates as XLA does, each step as one fused multiply-add rounded to
float32, with the logarithm under it taken in float64 and rounded once.
"""

import math

import numpy as np
import torch

from ..core.framework import convert_dtype
from ..core.registry import register_op

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "decoding_key",
           "random_bits", "uniform", "normal", "gumbel", "F32_TINY"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jnp.finfo(float32).tiny: the uniform's default minval under the Gumbel
F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None):
    """An int64 tensor holding the uint32 value of ``x`` (an int, a numpy
    array or a tensor), wrapped modulo 2**32 as a cast to uint32 wraps."""
    if isinstance(x, int):
        # a fill on the device, not a copy from the host: a captured
        # step (core/executor.py) may make it
        return torch.full((), x & _MASK, dtype=torch.int64, device=device)
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


def split(key, num=2):
    """``jax.random.split(key, num)`` in the partitionable layout: key
    ``i`` is the threefry hash of the counter ``(0, i)`` under ``key``.
    ``key`` [2] gives [num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


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
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
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


# XLA's float32 erf_inv (M. Giles' single-precision approximation, as
# stablehlo's chlo decomposition writes it): a degree-8 polynomial in
# w - 2.5 for w = -log1p(-x^2) < 5, in sqrt(w) - 3 otherwise
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x):
    """XLA's float32 ``erf_inv`` of float32 ``x``: the log1p in float64
    rounded once, each Horner step a multiply-add rounded once."""
    w = (-torch.log1p((x * -x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GT5):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32)).double()
        p = c if p is None else (c + p.double() * w).float()
    res = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


def _erf_inv_uniform(key, n):
    """XLA's float32 ``erf_inv`` of ``jax.random.normal``'s uniform, on
    [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _erf_inv(uniform(key, n, minval=lo, maxval=1.0))


def _f32(v):
    return float(np.float32(v))


def normal(key, n):
    """``jax.random.normal(key, (n,), float32)``: ``sqrt(2) *
    erf_inv(u)``, within 2 ulp of JAX's (see :func:`_erf_inv`)."""
    return torch.full((), _f32(math.sqrt(2.0)), dtype=torch.float32,
                      device=key.device) * _erf_inv_uniform(key, n)


def _float32_draw(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = convert_dtype(ctx.attr("dtype", "float32"))
    if dtype != np.dtype("float32"):
        raise NotImplementedError(
            "%s draws float32 only here, got %s: ROADMAP Queue A, "
            "\"LeNet-5/MNIST slice\"" % (ctx.op.type, dtype))
    return shape, math.prod(shape)


@register_op("gaussian_random", needs_rng=True, skip_eval_shape=True)
def _gaussian_random(ctx):
    """``mean + std * normal`` as XLA compiles it: the two constants
    ``std`` and ``sqrt(2)`` folded into one float32 product, and the
    multiply-add rounded once."""
    shape, n = _float32_draw(ctx)
    scale = _f32(_f32(math.sqrt(2.0)) * _f32(ctx.attr("std", 1.0)))
    e = _erf_inv_uniform(ctx.rng_key, n).double()
    out = e * scale + _f32(ctx.attr("mean", 0.0))
    return {"Out": out.float().reshape(shape)}


@register_op("uniform_random", needs_rng=True, skip_eval_shape=True)
def _uniform_random(ctx):
    shape, n = _float32_draw(ctx)
    return {"Out": uniform(ctx.rng_key, n, ctx.attr("min", -1.0),
                           ctx.attr("max", 1.0)).reshape(shape)}
