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
``csrc/int8_matmul.cu``, int8 tensor-core MMAs after a quantize pass
that writes x's int8 rows and scales into a scratch once per call. Both
paths are bound by device-memory bytes. At decode (m <= 16) the weight
(4-64 MB on the serving path) must be read at once across the card, so
the product is split over k: :func:`_plan` cuts each 32-column tile's k
into chunks until the grid has at least DECODE_MIN_CTAS CTAs (two on
each of the H100's 132 SMs), each CTA keeps up to 32 KB of 16-byte
weight loads in flight, and a column tile's CTAs, one thread block
cluster, add their exact int32 sums through distributed shared memory
before the f32 epilogue, so the output stays bitwise the plain
version's. At prefill a tiled GEMM, the tile chosen by :func:`_plan`.
The scratch is allocated once per device and stream and reused
(``_build.scratch``). The quantize pass and the product are one torch op,
``paddle_tpu_torch::int8_matmul`` (:func:`int8_matmul`: a fake
implementation for shapes, the plain version on the CPU, the kernel on
the card), so an exported program keeps it as one node; an eager call
takes the implementation directly (``flash_attention._eager``). On CPU tensors
it computes the plain version; on CUDA tensors it launches the kernel or
raises, and counts launches in ``quant_matmul_2d.launches``, and apart by
``(m, k, n)`` in ``quant_matmul_2d.launches_by_shape``.

The executor's armed-program hook :func:`maybe_quant_compute` (a program
tagged by ``serving/quant.py`` ``arm_quant_compute(programs, scope)``)
runs an armed ``mul`` or ``matmul`` through :func:`quant_matmul_2d` and
an armed ``conv2d`` through :func:`quant_conv2d`, the reference's integer
convolution, which has no Pallas kernel and is plain torch on both
devices.
"""

import collections
import functools
import math

import torch
import torch.nn.functional as F

from ..observability import metrics as _metrics
from . import _build
from .flash_attention import _eager, _on_cpu, _require

__all__ = ["QUANT_COMPUTE_TYPES", "SCALE_SUFFIX", "scale_var_name",
           "quantize_rows", "int8_matmul_plain", "quant_matmul_2d",
           "quant_conv2d", "maybe_quant_compute"]

# op types the executor consults this module for, on armed programs only
QUANT_COMPUTE_TYPES = ("mul", "matmul", "conv2d")

# the weight slot of each (serving/quant.py QUANT_OPS)
_WEIGHT_SLOT = {"mul": "Y", "matmul": "Y", "conv2d": "Filter"}

# f32(1 / 127), the reciprocal XLA folds ``amax / 127.0`` into; exact
# as a Python float
INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)

# the per-output-channel f32 scales of an armed weight ``name`` travel
# as ``name + SCALE_SUFFIX`` (the reference's scope sidecar name)
SCALE_SUFFIX = "@quant.scale"

# the reference's trace-time counter, one count per armed op per
# compiled program. A generation session on the module route counts once
# per armed product the first time it runs each of its program shapes (a
# prefill bucket, the decode step, the verify forward;
# ``serving.generation.GenerationSession``); the executor counts once per
# armed op the first time it runs each program version with one fetch
# list and tag (:func:`maybe_quant_compute`), whatever the feed
# signatures of its cache entries: an entry's export, capture and replays
# add nothing. The path is "pallas" for kernel B3 (a CUDA tensor), "dense"
# for its plain version (the CPU) and for every int8 conv2d
QUANT_COMPUTE_OPS = _metrics.REGISTRY.counter(
    "paddle_quant_compute_ops_total",
    "Quantized-compute op lowerings traced, by op type and path "
    "(dense XLA int8 / fused Pallas kernel). Incremented at trace "
    "time only: one count per armed op per compiled program",
    labelnames=("op", "path"))


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
# the decode path (``kDecode*`` in csrc/int8_matmul.cu): 32-column tiles,
# k in chunks of whole 256-row sub-stages (64 rows for each of a CTA's 4
# warps), at most 2048 rows (x's slice sits in shared memory) and at most
# 8 chunks (a portable thread block cluster); the plan splits k until the
# grid has DECODE_MIN_CTAS CTAs. Decode-sized m with a larger k takes a
# prefill tile.
DECODE_BN = 32
DECODE_STAGE_K = 256
DECODE_MAX_KC = 2048
DECODE_MAX_SPLITS = 8
DECODE_MIN_CTAS = 2 * 132

Plan = collections.namedtuple("Plan", "tile bm bn grid m_pad k_pad "
                                      "scratch_bytes splits kc")


def _cdiv(a, b):
    return -(-a // b)


# a plan is a pure function of its arguments, worked out on the host at
# every launch (73 a decode step): cached
@functools.lru_cache(maxsize=1024)
def _plan(m, k, n, tile=None, tiles=PREFILL_TILES, splits=None):
    """Kernel B3's launch for x [m, k] and w [k, n]: the path (tile -1:
    decode; else a prefill tile id, see PREFILL_MIN_CTAS), the CTA's
    (bm, bn) output tile, the grid, the scratch, and the k split.

    Decode (tile -1; m <= DECODE_MAX_M, k up to DECODE_MAX_SPLITS
    chunks): CTAs of all m_pad rows (8, or 16 for m > 8) by DECODE_BN
    columns, grid (column tiles, splits), each CTA taking kc rows of k, a
    column tile's CTAs one cluster; ``splits`` forces the split count (the
    probe's sweep), which must leave no chunk empty, none over
    DECODE_MAX_KC rows and at most DECODE_MAX_SPLITS. Scratch: int8 x
    [m_pad, k_pad = splits * kc], then m_pad f32 scales.

    Prefill: grid (n tiles, m tiles); scratch int8 x [m_pad, k_pad] (m
    up to whole tiles, k to PREFILL_BK) followed by m_pad f32 scales.
    ``tile`` forces a prefill tile id of ``tiles``, the table of the
    build launched (the probe's sweep builds edited tables)."""
    if tile is None and m <= DECODE_MAX_M \
            and k <= DECODE_MAX_SPLITS * DECODE_MAX_KC:
        return _decode_plan(m, k, n, splits)
    if tile is None:
        tile = 0 if _cdiv(m, 64) * _cdiv(n, 128) >= PREFILL_MIN_CTAS else 1
    bm, bn = tiles[tile]
    m_pad = _cdiv(m, bm) * bm
    k_pad = _cdiv(k, PREFILL_BK) * PREFILL_BK
    return Plan(tile, bm, bn, (_cdiv(n, bn), m_pad // bm), m_pad, k_pad,
                m_pad * k_pad + 4 * m_pad, 1, k_pad)


def _decode_plan(m, k, n, splits):
    tiles = _cdiv(n, DECODE_BN)
    stages = _cdiv(k, DECODE_STAGE_K)
    if splits is None:
        splits = 1
        while splits < min(stages, DECODE_MAX_SPLITS) and (
                tiles * splits < DECODE_MIN_CTAS
                or _cdiv(stages, splits) * DECODE_STAGE_K > DECODE_MAX_KC):
            splits *= 2
        splits = min(splits, DECODE_MAX_SPLITS)
    # no chunk empty: the count the chunk size gives, and the chunk size
    # the C entry derives from it
    splits = _cdiv(stages, _cdiv(stages, splits))
    kc = _decode_kc(k, splits)
    if kc > DECODE_MAX_KC or splits > DECODE_MAX_SPLITS:
        raise ValueError("B3 cannot split k = %d into %d chunks of at most "
                         "%d rows, at most %d chunks" % (
                             k, splits, DECODE_MAX_KC, DECODE_MAX_SPLITS))
    m_pad = 8 if m <= 8 else 16
    k_pad = splits * kc
    return Plan(-1, m_pad, DECODE_BN, (tiles, splits), m_pad, k_pad,
                m_pad * k_pad + 4 * m_pad, splits, kc)


def _decode_kc(k, splits):
    """The k rows of each of ``splits`` decode chunks, as the C entry
    computes them: whole sub-stages."""
    return _cdiv(k, splits * DECODE_STAGE_K) * DECODE_STAGE_K


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
    _require(wq.dtype == torch.int8, "wq must be int8, got %s", wq.dtype)
    _require(w_scale.shape[0] == wq.shape[1],
             "w_scale must have n = %d entries, got %d", wq.shape[1],
             w_scale.shape[0])
    cpu = _on_cpu(x2, wq, w_scale)
    if _eager(x2, wq, w_scale):
        impl = int8_matmul_plain if cpu else _int8_matmul_cuda
    else:
        impl = torch.ops.paddle_tpu_torch.int8_matmul
    return impl(x2, wq, w_scale)


quant_matmul_2d.launches = 0
quant_matmul_2d.launches_by_shape = collections.Counter()


@torch.library.custom_op("paddle_tpu_torch::int8_matmul", mutates_args=(),
                         device_types="cpu")
def int8_matmul(x2: torch.Tensor, wq: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """B3's quantize pass and product as a torch op (x2 f32 [m, k], wq
    int8 [k, n], w_scale f32 [n]): on the CPU the plain version, on the
    card the kernel."""
    return int8_matmul_plain(x2, wq, w_scale)


@int8_matmul.register_kernel("cuda")
def _int8_matmul_cuda(x2, wq, w_scale):
    m, k = x2.shape
    n = wq.shape[1]
    _require(m >= 1 and k >= 1 and n >= 1,
             "empty product %s", (m, k, n))
    _require(x2.is_contiguous() and wq.is_contiguous()
             and w_scale.is_contiguous()
             and not (x2.data_ptr() | wq.data_ptr() | w_scale.data_ptr())
             % 16, "x2, wq and w_scale must be contiguous and 16-byte "
             "aligned")
    out = _launch(x2, wq, w_scale, _plan(m, k, n))
    quant_matmul_2d.launches += 1
    quant_matmul_2d.launches_by_shape[m, k, n] += 1
    return out


@int8_matmul.register_fake
def _int8_matmul_fake(x2, wq, w_scale):
    return x2.new_empty((x2.shape[0], wq.shape[1]), dtype=torch.float32)


def _launch(x2, wq, w_scale, plan):
    """One launch of B3's C entry by ``plan`` on checked CUDA inputs;
    not counted."""
    m, k = x2.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    fn = _build.entry("int8_matmul")
    stream = _build.stream(x2.device)
    scratch = _build.scratch(x2.device, stream, plan.scratch_bytes)
    err = fn(x2.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), m, k, n, plan.tile, plan.splits, stream)
    _build.check(err, "int8_matmul")
    return out


def quant_conv2d(x, wq, w_scale, strides=1, paddings=0, dilations=1,
                 groups=1):
    """The reference's int8 ``conv2d`` (``_quant_conv2d``): NCHW
    activations quantized per sample (amax over C, H, W; ``scale = amax
    * f32(1 / 127)``, as its compiled program scales, 1.0 for an all-zero
    sample), the OIHW int8 filter, zero padding (which quantizes to
    zero), the integer convolution, then one f32 epilogue ``acc * scale *
    w_scale`` in that order. The integer sums are exact: the convolution
    runs on the int8 values in float64, whose sums of at most C·kh·kw
    products of |q| <= 127 are integers far below 2**53 whatever the
    order, and are rounded to the integer once more (a convolution
    algorithm that transforms its operands would leave a residue far
    below 0.5). Plain torch on any device; the result is the same bits
    on the CPU and the card."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.where(amax > 0.0, amax * INV_127, torch.ones_like(amax))
    xq = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    acc = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), None,
                   strides, paddings, dilations, groups)
    return torch.round(acc).to(torch.float32) * scale \
        * w_scale.to(torch.float32).reshape(1, -1, 1, 1)


def _quant_mul(op, x, wq, w_scale):
    """``mul`` armed for a 2-D weight with ``y_num_col_dims`` 1: x
    flattened at ``x_num_col_dims`` to [m, k]."""
    xd = op.attrs.get("x_num_col_dims", 1)
    xs = tuple(x.shape)
    x2 = x.reshape(math.prod(xs[:xd]), math.prod(xs[xd:])).contiguous()
    out = quant_matmul_2d(x2, wq, w_scale)
    return {"Out": out.reshape(xs[:xd] + tuple(wq.shape[1:]))}


def _quant_matmul(op, x, wq, w_scale):
    """``matmul`` armed for a 2-D weight without ``transpose_Y``;
    ``transpose_X`` and ``alpha`` as in the float32 op."""
    if op.attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    xs = tuple(x.shape)
    n = wq.shape[1]
    out = quant_matmul_2d(x.reshape(-1, xs[-1]).contiguous(), wq, w_scale)
    out = out.reshape(xs[:-1] + (n,))
    alpha = op.attrs.get("alpha", 1.0)
    return {"Out": out * alpha if alpha != 1.0 else out}


def maybe_quant_compute(op, values, env, trace):
    """The executor's hook for an armed program: ``op`` (one of
    QUANT_COMPUTE_TYPES) on its int8 weight when the program's tag
    (``trace.quant``) covers the weight and the weight is int8 with its
    scales in ``env``; else None, and the float32 op runs. Counts
    ``paddle_quant_compute_ops_total`` once per op in ``trace.quant_seen``
    (the executor's plan of this program version)."""
    slot = _WEIGHT_SLOT.get(op.type)
    names = op.inputs.get(slot) or ()
    if not names or names[0] not in trace.quant["vars"]:
        return None
    wq = values[slot][0]
    if wq is None or wq.dtype != torch.int8:
        return None
    w_scale = env.get(scale_var_name(names[0]))
    if w_scale is None:
        return None
    if id(op) not in trace.quant_seen:
        trace.quant_seen.add(id(op))
        QUANT_COMPUTE_OPS.labels(
            op=op.type, path="pallas" if wq.is_cuda and op.type != "conv2d"
            else "dense").inc()
    if op.type == "mul":
        return _quant_mul(op, values["X"][0], wq, w_scale)
    if op.type == "matmul":
        return _quant_matmul(op, values["X"][0], wq, w_scale)
    return {"Output": quant_conv2d(
        values["Input"][0], wq, w_scale, op.attrs.get("strides", [1, 1]),
        op.attrs.get("paddings", [0, 0]), op.attrs.get("dilations", [1, 1]),
        op.attrs.get("groups", 1) or 1)}
