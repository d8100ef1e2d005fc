"""Counter-keyed random bits for decoding and the random ops of a
program (reference ``paddle_tpu/ops/random_ops.py`` ``decoding_key``,
``gaussian_random``, ``uniform_random``, ``randint`` and
``sampling_id``, and the parts of JAX's threefry PRNG they reach:
``jax._src.prng`` with ``jax_threefry_partitionable`` on, and
``jax._src.random`` ``split``, ``_uniform``, ``_normal_real``,
``_randint`` and ``_gumbel``).

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
At float16 and bfloat16 both draw the reference's values bit for bit
(the 16-bit paths of ``_uniform``, rounded as XLA rounds them on the
CPU), ``randint`` its integers bit for bit, and ``sampling_id`` its ids
but where two columns' noisy logits lie within an ulp.
"""

import math

import numpy as np
import torch

from ..core.framework import torch_dtype
from ..core.registry import register_op

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "decoding_key",
           "random_bits", "uniform", "normal", "gumbel", "randint",
           "F32_TINY"]

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
        c = torch.where(lt, torch.full((), a, device=x.device),
                        torch.full((), b, device=x.device)).double()
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


# the 16-bit float draws (``jax._src.random._uniform``): the bits each
# takes from the 32-bit word, its mantissa width and the bits of 1.0
_HALF_BITS = {torch.float16: (16, 10, 0x3C00),
              torch.bfloat16: (8, 7, 0x3F80)}


def _draw(ctx):
    shape = tuple(ctx.attr("shape"))
    return shape, math.prod(shape), torch_dtype(ctx.attr("dtype", "float32"))


def _half_uniform(key, n, dtype, minval, maxval):
    """``jax.random.uniform`` at a 16-bit float ``dtype``: the low 16
    (float16) or 8 (bfloat16: fewer than 8 mantissa bits take 8) bits of
    the 32-bit word, shifted under the exponent of 1.0, minus 1, scaled
    and shifted. XLA on the CPU computes float16 in float32 within the
    fusion and rounds once, bfloat16 rounds after each operation: so do
    these."""
    rng_bits, nmant, one = _HALF_BITS[dtype]
    bits = random_bits(key, n) & ((1 << rng_bits) - 1)
    floats = ((bits >> (rng_bits - nmant)) | one).to(torch.int16) \
        .view(dtype) - 1.0
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    if dtype == torch.float16:
        scaled = (floats.float() * (hi - lo).float() + lo.float()).to(dtype)
    else:
        scaled = floats * (hi - lo) + lo
    return torch.maximum(lo, scaled)


def _half_normal(key, n, dtype):
    """``jax.random.normal`` at a 16-bit float ``dtype``: XLA's float32
    ``erf_inv`` of the dtype's uniform on [nextafter(-1, 0), 1), rounded
    to the dtype, times sqrt(2) in the dtype."""
    # nextafter(-1, 0) in the dtype
    lo = -1.0 + (2.0 ** -11 if dtype == torch.float16 else 2.0 ** -8)
    e = _erf_inv(_half_uniform(key, n, dtype, lo, 1.0).float()).to(dtype)
    return e, torch.full((), math.sqrt(2.0), dtype=dtype, device=key.device)


@register_op("gaussian_random", needs_rng=True, skip_eval_shape=True)
def _gaussian_random(ctx):
    """``mean + std * normal`` as XLA compiles it. float32: the two
    constants ``std`` and ``sqrt(2)`` folded into one float32 product,
    and the multiply-add rounded once. float16: the constants folded in
    float16, the multiply-add in float32, rounded to float16. bfloat16:
    each operation rounded to bfloat16, as the reference runs it."""
    shape, n, dtype = _draw(ctx)
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    if dtype in _HALF_BITS:
        e, sqrt2 = _half_normal(ctx.rng_key, n, dtype)
        if dtype == torch.float16:
            scale = (sqrt2 * torch.full((), std, dtype=dtype,
                                        device=e.device)).float()
            out = (e.float() * scale + float(np.float16(mean))).to(dtype)
        else:
            out = torch.full((), mean, dtype=dtype, device=e.device) + \
                torch.full((), std, dtype=dtype, device=e.device) * \
                (e * sqrt2)
        return {"Out": out.reshape(shape)}
    scale = _f32(_f32(math.sqrt(2.0)) * _f32(std))
    e = _erf_inv_uniform(ctx.rng_key, n).double()
    out = e * scale + _f32(mean)
    return {"Out": out.float().reshape(shape)}


@register_op("uniform_random", needs_rng=True, skip_eval_shape=True)
def _uniform_random(ctx):
    shape, n, dtype = _draw(ctx)
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    if dtype in _HALF_BITS:
        return {"Out": _half_uniform(ctx.rng_key, n, dtype, lo, hi)
                .reshape(shape)}
    return {"Out": uniform(ctx.rng_key, n, lo, hi).reshape(shape)}


def randint(key, shape, low, high):
    """``jax.random.randint(key, shape, low, high, int32)``: two draws of
    32 bits from the key's two halves (``split``), the span ``high -
    low`` (1 when empty) as uint32, the multiplier ``(2^16 % span)^2 %
    span``, then ``(hi % span) * multiplier + lo % span`` modulo span,
    plus ``low``; every product and sum wraps at 32 bits as uint32 does
    in JAX.
    Returns an int32 tensor of ``shape`` on the key's device."""
    n = math.prod(shape)
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, n), random_bits(k2, n)
    span = (high - low) & _MASK if high > low else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    out = (offset + low) & _MASK
    # two's complement: the low 32 bits as int32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(
        torch.int32).reshape(tuple(shape))


@register_op("randint", needs_rng=True, skip_eval_shape=True)
def _randint(ctx):
    return {"Out": randint(ctx.rng_key, tuple(ctx.attr("shape")),
                           int(ctx.attr("low", 0)), int(ctx.attr("high")))}


@register_op("sampling_id", needs_rng=True)
def _sampling_id(ctx):
    """A column per row of the probabilities X: ``jax.random.categorical``
    of ``log(max(x, 1e-20))``, the argmax of logits plus Gumbel noise
    (``gumbel``) from the op's key; int32."""
    x = ctx.input("X")
    if x.device.type == "meta":
        return {"Out": torch.empty(x.shape[:-1], dtype=torch.int32,
                                   device="meta")}
    logits = torch.log(torch.maximum(x, torch.full((), 1e-20, dtype=x.dtype,
                                                   device=x.device)))
    noise = gumbel(ctx.rng_key, x.numel()).reshape(x.shape).to(x.dtype)
    return {"Out": torch.argmax(noise + logits, dim=-1).to(torch.int32)}
