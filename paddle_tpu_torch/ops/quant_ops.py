"""int8 weight compute: the wrapper of kernel B3 and its plain version
(reference ``paddle_tpu/ops/quant_ops.py``).

An armed weight is int8 [in, out] with f32 per-output-channel scales
beside it (``serving/quant.py``). Its product with f32 activations x
[m, k]:

* quantizes x per row, symmetric: ``scale = amax * f32(1 / 127)`` (1.0
  for an all-zero row), ``q = clip(round_half_even(x / scale), -127,
  127)``;
* multiplies int8 by int8 into int32, which is exact;
* applies both scales in one f32 epilogue,
  ``acc.float() * x_scale * w_scale[None, :]``, in that order.

Every step is exact or one correctly rounded f32 operation, so the plain
version, the kernel and the reference's compiled dense and Pallas paths
are bitwise equal. The reference writes ``amax / 127.0``; XLA compiles a
division by a constant into a product with its rounded reciprocal, and
the reference's sessions run compiled programs, so the port multiplies
by ``f32(1 / 127)`` as they do. (An eager, uncompiled call of the
reference's ``_dense_int8_matmul`` divides, and its scale can differ in
the last bit.)

:func:`quant_matmul_2d` replaces the Pallas kernel
``paddle_tpu/ops/quant_ops.py::_pallas_int8_matmul``. Kernel:
``csrc/int8_matmul.cu``, int8 tensor-core MMAs: at decode (m <= 16)
with the row quantize fused in; at prefill a quantize pass into an int8
scratch, then a tiled GEMM, the tile chosen by :func:`_plan`. On CPU
tensors it computes the plain version; on CUDA tensors it launches the
kernel or raises, and counts launches in ``quant_matmul_2d.launches``.
"""

import collections

import torch

from . import _build
from .flash_attention import _on_cpu, _require

__all__ = ["SCALE_SUFFIX", "scale_var_name", "quantize_rows",
           "int8_matmul_plain", "quant_matmul_2d"]

# f32(1 / 127), the reciprocal XLA folds ``amax / 127.0`` into; exact
# as a Python float
INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)

# the per-output-channel f32 scales of an armed weight ``name`` travel
# as ``name + SCALE_SUFFIX`` (the reference's scope sidecar name)
SCALE_SUFFIX = "@quant.scale"


# kernel B3's prefill tiles (BM, BN) by the id its C entry takes
# (``kPrefillTiles`` in csrc/int8_matmul.cu): the two ``_plan`` picks; its
# k is padded to a multiple of PREFILL_BK bytes; m up to DECODE_MAX_M
# takes the decode path
PREFILL_TILES = ((64, 128), (32, 64))
PREFILL_BK = 128
DECODE_MAX_M = 16
# the prefill plan takes 64 x 128 where its grid has PREFILL_MIN_CTAS
# CTAs (about one on each of the H100's 132 SMs), else 32 x 64: the
# fastest of the five tiles swept at each prefill shape of the path
# (``python3 -m paddle_tpu_torch.probes.int8 tiles``; PERF.md)
PREFILL_MIN_CTAS = 128

Plan = collections.namedtuple("Plan", "tile bm bn grid m_pad k_pad "
                                      "scratch_bytes")


def _cdiv(a, b):
    return -(-a // b)


def _plan(m, k, n, tile=None, tiles=PREFILL_TILES):
    """Kernel B3's launch for x [m, k] and w [k, n]: the path (tile -1:
    decode, its 16 x 32 CTAs covering the output; else a prefill tile
    id, see PREFILL_MIN_CTAS), the tile's (bm, bn), its (n, m) grid, and
    the prefill scratch: int8 x [m_pad, k_pad] (m up to whole tiles, k
    to PREFILL_BK) followed by m_pad f32 scales. ``tile`` forces a
    prefill tile id of ``tiles``, the table of the build launched (the
    probe's sweep builds edited tables)."""
    if tile is None and m <= DECODE_MAX_M:
        return Plan(-1, 16, 32, (_cdiv(n, 32), _cdiv(m, 16)), m, k, 0)
    if tile is None:
        tile = 0 if _cdiv(m, 64) * _cdiv(n, 128) >= PREFILL_MIN_CTAS else 1
    bm, bn = tiles[tile]
    m_pad = _cdiv(m, bm) * bm
    k_pad = _cdiv(k, PREFILL_BK) * PREFILL_BK
    return Plan(tile, bm, bn, (_cdiv(n, bn), m_pad // bm), m_pad, k_pad,
                m_pad * k_pad + 4 * m_pad)


def scale_var_name(name):
    """Name of the scales of weight ``name``."""
    return name + SCALE_SUFFIX


def quantize_rows(x):
    """Dynamic symmetric int8 over the last axis: ``(q int8, scale f32
    [..., 1])`` with ``scale = amax * f32(1 / 127)`` per row (1.0 for
    all-zero rows) and ``x ~= q * scale``. ``torch.round`` rounds half
    to even, as ``jnp.rint`` does."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def int8_matmul_plain(x2, wq, w_scale):
    """The plain version of kernel B3: x2 f32 [m, k], wq int8 [k, n],
    w_scale f32 [n] -> f32 [m, n], on any device. The int8 product is
    exact: an int32 matmul on the CPU; on CUDA, which has no integer
    matmul, a float64 one, whose partial sums are integers below
    k * 127**2 < 2**53."""
    xq, x_scale = quantize_rows(x2)
    if x2.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int32), wq.to(torch.int32))
    else:
        acc = torch.matmul(xq.to(torch.float64),
                           wq.to(torch.float64)).to(torch.int32)
    return acc.to(torch.float32) * x_scale * w_scale[None, :]


def quant_matmul_2d(x2, wq, w_scale):
    """f32 [m, k] activations times an int8 [k, n] weight with f32 [n]
    per-output-channel scales -> f32 [m, n] (reference
    ``quant_matmul_2d``). x2 is upcast to f32. Any m, k, n >= 1."""
    if x2.dtype != torch.float32:
        x2 = x2.to(torch.float32)
    if w_scale.dtype != torch.float32 or w_scale.dim() != 1:
        w_scale = w_scale.to(torch.float32).reshape(-1)
    _require(x2.dim() == 2 and wq.dim() == 2 and x2.shape[1] == wq.shape[0],
             "x2 [m, k] and wq [k, n] do not chain: %s %s",
             tuple(x2.shape), tuple(wq.shape))
    m, k = x2.shape
    n = wq.shape[1]
    _require(wq.dtype == torch.int8, "wq must be int8, got %s", wq.dtype)
    _require(w_scale.numel() == n,
             "w_scale must have n = %d entries, got %d", n, w_scale.numel())
    if _on_cpu(x2, wq, w_scale):
        return int8_matmul_plain(x2, wq, w_scale)
    _require(m >= 1 and k >= 1 and n >= 1,
             "empty product %s", (m, k, n))
    _require(x2.is_contiguous() and wq.is_contiguous()
             and w_scale.is_contiguous()
             and not (x2.data_ptr() | wq.data_ptr() | w_scale.data_ptr())
             % 16, "x2, wq and w_scale must be contiguous and 16-byte "
             "aligned")
    out = _launch(x2, wq, w_scale, _plan(m, k, n))
    quant_matmul_2d.launches += 1
    return out


quant_matmul_2d.launches = 0


def _launch(x2, wq, w_scale, plan):
    """One launch of B3's C entry by ``plan`` on checked CUDA inputs,
    its scratch allocated here; not counted."""
    m, k = x2.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x2.device) if plan.scratch_bytes else None
    fn = _build.entry("int8_matmul")
    stream = _build.stream(x2.device)
    err = fn(x2.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), m, k, n,
             plan.tile, stream)
    _build.check(err, "int8_matmul")
    return out
