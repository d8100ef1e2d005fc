"""Flash attention for prefill, training and decode: the wrappers of the
port's three CUDA kernels and their plain PyTorch versions.

* :func:`flash_attention` replaces the Pallas kernel
  ``paddle_tpu/ops/pallas_attention.py::flash_attention`` with its
  ``custom_vjp``: the forward is kernel B2 (``csrc/flash_attention.cu``)
  on float32 or bfloat16 q, k, v, and the backward is the reference's
  chunked recompute ``_flash_bwd`` in torch ops (the reference leaves it
  to XLA too: einsums in a ``lax.scan``, not a kernel), its causal chunks
  cut to the keys below the diagonal. The bf16 forward runs both products
  on the tensor cores (``mma.sync``), bound by shared-memory reads and
  the softmax's exponentials; the f32 forward runs them as f32 FMAs on
  the CUDA cores (TF32 stays off), bound by those operations. Both keep
  the [T, T] scores out of device memory and skip causal tiles above the
  diagonal. :func:`flash_attention_tile` launches the bf16 kernel at any
  of its tile instantiations: the port of the block-size sweep
  ``tools/transformer_mfu_probe.py::bench_kernel`` (T2).
* :func:`decode_attention` replaces
  ``paddle_tpu/ops/pallas_attention.py::decode_attention``. Kernel:
  ``csrc/decode_attention.cu``, bound by device-memory bytes over slots
  of very different lengths. It reads the cache in its native [S, C,
  H*D] layout (no transpose copy) through the split-key body it shares
  with B5 (``csrc/decode_split.cuh``): :func:`_split_plan` cuts each
  slot's logical rows into chunks and sets a fixed grid whose CTAs walk
  the (chunk, slot, head) items, skipping on the card those past a
  slot's length; each keeps 16-byte loads of K and V in flight
  (:data:`SPLIT_LOADS` a lane, by cache dtype) and makes a partial (m,
  l, acc). In one launch, the last CTA to finish a (slot, head) combines
  its chunks in chunk order, counting in a zeroed buffer of its own
  (``_build.counters``).
* :func:`decode_attention_paged` replaces
  ``paddle_tpu/ops/pallas_attention.py::decode_attention_paged``.
  Kernel: ``csrc/decode_attention_paged.cu``: the same body through the
  block table, the partials combined by a second launch. Every boundary
  is a logical row index and the two kernels combine alike, so a slot's
  output depends on its q, live rows and length alone, and B4 on a dense
  cache is bitwise equal to B5 on a pool holding the same logical rows.

bfloat16 flash attention computes what the reference's kernel body does
on its own chip, where both dots run at ``Precision.DEFAULT``, one bf16
pass of the matrix unit with f32 sums: the scores are exact products
summed in f32, scaled in f32; the running max and sum stay f32; the
probabilities enter the PV product rounded to bf16; the output is
rounded to bf16. The plain version keeps the probabilities f32 (the
reference's kernel interpreted on a CPU does too); the two differ by less
than one bf16 step of the output, the tolerance the card's check holds
the kernel to. The reference's own ``_reference`` (its fallback at a T
with no aligned block) rounds the normalized probabilities to bf16; the
port's plain version does not, at any T (ROADMAP Queue C).

The decode kernels read float32 or bfloat16 caches (both of one dtype;
the ``generation_kv_dtype`` flag); q, the output and all arithmetic
stay float32, the cache upcast at the contraction as the reference
does. The plain versions upcast the caches before their einsums.

B2's forward, B4 and B5 are torch ops (``torch.library.custom_op``) in
the ``paddle_tpu_torch`` namespace: ``flash_attention_fwd``,
``decode_attention`` and ``decode_attention_paged``, each with a fake
implementation that only computes shapes, the plain version as its CPU
implementation and the kernel as its CUDA one. So ``torch.export`` keeps
each as one node of a program's graph (``core/executor.py`` ``lower``),
and a graph exported on the CPU launches the kernels when it runs on
the card. The wrappers check shapes and devices and call the ops (or,
eagerly, the op's implementation for the device, :func:`_eager`): a
wrapper given CPU tensors computes the plain version (the CPU tests rely
on it); given CUDA tensors it launches the kernel or raises: there is no
fallback. Each CUDA implementation counts its kernel launches in
``<wrapper>.launches``; :func:`flash_attention` also counts its bfloat16
launches in ``flash_attention.launches_bf16``.
"""

import collections
import functools
from typing import Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from . import _build

_NEG = -1e30
_HEAD_DIMS = (64, 128)
# B2's element types -> suffix of its C entry points
_FLASH_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the tiles the bf16 kernel is instantiated for at head dim 128 (T2's
# sweep; the TPU's 256-1024 were sized for its VMEM), and the
# (block_q, block_k) tile of the path's bf16 launches by head dim: at 128
# the sweep's fastest at the training shape [8, 16, 1024, 128] (128 x 32,
# 15% ahead of 128 x 128 on the H100, PERF.md), at 64 the one
# instantiation. float32 launches its one tile, 32 x 64.
SWEEP_TILES = tuple((bq, bk) for bq in (32, 64, 128) for bk in (32, 64, 128))
PATH_TILES = {64: (64, 64), 128: (128, 32)}


def _reference(q, k, v, causal, seg=None):
    """Plain attention over [BH, T, D] (reference ``_reference``); ``seg``
    [BH, T] int32 segment ids, 0 = padding: a key is attendable by a query
    iff their ids match and the key's id is nonzero. Padded query rows
    output 0. The scores are f32 whatever the inputs' dtype; the
    probabilities take q's dtype before the PV product, as there."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    t = q.shape[1]
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, _NEG)
    if seg is not None:
        m = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != 0)
        s = torch.where(m, s, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if seg is not None:
        # fully-masked (padding) query rows: zero output, not uniform
        p = p * (seg != 0)[:, :, None].to(p.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _decode_reference(q, k, v, lengths):
    """Plain single-query attention over a cache: q [BH, 1, D], k/v
    [BH, C, D], lengths [BH]; cache row c is attendable iff c < length."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * (q.shape[-1] ** -0.5)
    cols = torch.arange(k.shape[1], device=k.device)
    mask = cols[None, None, :] < lengths.to(k.device)[:, None, None]
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _require(cond, msg, *args):
    """Raise ValueError(msg % args) unless ``cond``; the message is
    formatted only on failure, which keeps passing checks cheap on the
    wrappers' per-launch path."""
    if not cond:
        raise ValueError(msg % args if args else msg)


def _on_cpu(*tensors):
    """True when the tensors all lie on the CPU, False when they are all
    CUDA tensors; raises on anything else."""
    tensors = [t for t in tensors if t is not None]
    if all(t.is_cuda for t in tensors):
        return False
    devices = {t.device.type for t in tensors}
    if devices != {"cpu"}:
        raise ValueError("tensors must all lie on the CPU or all on one "
                         "CUDA device, got %s" % sorted(devices))
    return True


def _eager(*tensors):
    """True when a wrapper may call its op's implementation for the
    tensors' device directly: plain tensors, no dispatch mode watching.
    An export, a fake-tensor trace or a FLOP count sees subclassed
    tensors or a mode, and goes through the op, which it records as one
    node; the dispatcher's own cost (tens of µs a call on the host) is
    kept off the eager path, where B3 alone runs 73 times a decode
    step."""
    return _get_current_dispatch_mode() is None and all(
        type(t) is torch.Tensor for t in tensors if t is not None)


def _check_input(name, t, dtype=torch.float32):
    _require(t.dtype == dtype, "%s must be %s, got %s", name, dtype, t.dtype)
    _require(t.is_contiguous(), "%s must be contiguous", name)
    _require(t.data_ptr() % 16 == 0, "%s must be 16-byte aligned", name)


# cache dtype -> suffix of the decode kernels' C entry points
_KV_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_decode_inputs(q, k, v):
    """q f32; the two caches of one dtype the decode kernels read. Returns
    the entry-point suffix."""
    _check_input("q", q)
    _require(k.dtype in _KV_ENTRY and v.dtype == k.dtype,
             "caches must both be float32 or both bfloat16, got %s %s",
             k.dtype, v.dtype)
    _check_input("k", k, k.dtype)
    _check_input("v", v, k.dtype)
    return _KV_ENTRY[k.dtype]


def _block_size(t, cap, align=16):
    """Reference ``_block_size``: the largest divisor of t that is <= cap,
    >= 128 and ``align``-ed, t itself when t <= cap and aligned, else 0."""
    if t <= cap:
        return t if t % align == 0 else 0
    for b in range(cap, 127, -1):
        if t % b == 0 and b % align == 0:
            return b
    return 0


def _bh_segments(segment_ids, b, h, t):
    """[B, T] segment ids -> [B*H, T] int32, or None."""
    if segment_ids is None:
        return None
    return segment_ids.to(torch.int32)[:, None, :].expand(
        b, h, t).reshape(b * h, t)


def flash_attention_plain(q, k, v, causal=False, segment_ids=None):
    """The plain version of :func:`flash_attention`'s forward on
    [B, H, T, D] inputs, on any device. bfloat16 inputs are computed in
    float32 (the reference kernel's promotion) and the output rounded to
    bfloat16."""
    b, h, t, d = q.shape
    seg = _bh_segments(segment_ids, b, h, t)
    out = _reference(q.reshape(b * h, t, d).float(),
                     k.reshape(b * h, t, d).float(),
                     v.reshape(b * h, t, d).float(), causal, seg)
    return out.reshape(b, h, t, d).to(q.dtype)


def _check_flash(q, k, v, segment_ids):
    """The kernel's preconditions on CUDA inputs."""
    _require(q.dtype in _FLASH_ENTRY, "q must be float32 or bfloat16, got "
             "%s", q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_input(name, x, q.dtype)
    _require(q.shape[-1] in _HEAD_DIMS, "head dim %d not in %s",
             q.shape[-1], _HEAD_DIMS)
    if segment_ids is not None:
        _require(segment_ids.dtype == torch.int32
                 and segment_ids.is_contiguous(),
                 "segment_ids must be contiguous int32")


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segment_ids: Optional[torch.Tensor],
                        causal: bool) -> torch.Tensor:
    """B2's forward as a torch op on [B, H, T, D] inputs: on the CPU the
    plain version, on the card the kernel at the path's tile."""
    return flash_attention_plain(q, k, v, causal, segment_ids)


@flash_attention_fwd.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, segment_ids, causal):
    _check_flash(q, k, v, segment_ids)
    out = _launch_flash(q, k, v, segment_ids, causal,
                        PATH_TILES[q.shape[-1]])
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.launches_bf16 += 1
    return out


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, segment_ids, causal):
    return torch.empty_like(q)


def _launch_flash(q, k, v, segment_ids, causal, tile):
    """One launch of B2 on checked CUDA [B, H, T, D] inputs; ``tile`` the
    bf16 (block_q, block_k)."""
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    seg = None if segment_ids is None else segment_ids.data_ptr()
    stream = _build.stream(q.device)
    if q.dtype == torch.float32:
        err = _build.entry("flash_attention_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, out.data_ptr(),
            b * h, t, d, h, int(causal), stream)
    else:
        err = _build.entry("flash_attention_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, out.data_ptr(),
            b * h, t, d, h, int(causal), tile[0], tile[1], stream)
    _build.check(err, "flash_attention")
    return out


def _flash_backward(q, k, v, seg, g, causal, block_q):
    """The reference's ``_flash_bwd`` on [BH, T, D] residuals and
    cotangent ``g``: the probabilities recomputed one chunk of
    ``_block_size(T, block_q)`` query rows at a time (align 16, with or
    without segment ids), never the whole [T, T]; dq cast to q's dtype
    chunk by chunk, dk and dv summed in f32 and cast at the end. Where T
    has no aligned chunk, the autograd of :func:`_reference` over the whole
    sequence.

    Under ``causal``, chunk i reads only keys [0, (i + 1) bq): past them
    its probabilities and ``ds`` are exactly 0, so dk and dv take the same
    sums over that prefix (the reference's scan reads every key). The
    ``s`` and ``dp`` products take q or g against k or v: on CUDA with
    bf16 inputs they run as bf16 x bf16 -> f32 products on the tensor
    cores (``torch.bmm(..., out_dtype=torch.float32)``), the reference's
    einsums of two bf16 operands with ``preferred_element_type=f32``,
    exact products with f32 sums; elsewhere the operands are upcast to
    f32. dq, dk and dv take ``ds`` or ``p`` (f32) against a bf16 operand,
    which jnp promotes to f32: those products run in f32 everywhere."""
    bh, t, d = q.shape
    bq = _block_size(t, block_q)
    if not bq:
        with torch.enable_grad():
            qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
            out = _reference(qa, ka, va, causal, seg)
        return torch.autograd.grad(out, (qa, ka, va), g)
    scale = d ** -0.5
    tensor_cores = q.is_cuda and q.dtype == torch.bfloat16
    k32 = k.float()
    v32 = None if tensor_cores else v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty_like(q)
    # causal, no segment ids: each chunk's keys below its first row are
    # live for every row, so only its diagonal block is masked (the
    # strict upper triangle), and no row is fully masked
    upper = None
    if causal and seg is None:
        upper = torch.ones(bq, bq, dtype=torch.bool,
                           device=q.device).triu(1)
    for i in range(t // bq):
        r0, kend = i * bq, ((i + 1) * bq if causal else t)
        rows = slice(r0, r0 + bq)
        qb, gb = q[:, rows], g[:, rows]
        qb32, gb32 = qb.float(), gb.float()
        if tensor_cores:
            s = torch.bmm(qb, k[:, :kend].transpose(1, 2),
                          out_dtype=torch.float32)
            dp = torch.bmm(gb, v[:, :kend].transpose(1, 2),
                           out_dtype=torch.float32)
        else:
            s = torch.einsum("bqd,bkd->bqk", qb32, k32[:, :kend])
            dp = torch.einsum("bqd,bkd->bqk", gb32, v32[:, :kend])
        s.mul_(scale)
        live = None
        if seg is not None:
            live = (seg[:, rows, None] == seg[:, None, :kend]) & \
                (seg[:, None, :kend] != 0)
            if causal:
                live = live & (torch.arange(r0, r0 + bq, device=q.device)
                               [:, None] >= torch.arange(
                                   kend, device=q.device)[None, :])
            s.masked_fill_(~live, _NEG)
        elif causal:
            s[:, :, r0:].masked_fill_(upper, _NEG)
        p = torch.softmax(s, dim=-1)
        if live is not None:
            p.masked_fill_(~live, 0.0)      # fully-masked rows -> 0
        ds = dp.sub_((dp * p).sum(dim=-1, keepdim=True)).mul_(p)
        dq[:, rows] = (torch.einsum("bqk,bkd->bqd", ds, k32[:, :kend])
                       * scale).to(q.dtype)
        dk[:, :kend] += torch.einsum("bqk,bqd->bkd", ds, qb32) * scale
        dv[:, :kend] += torch.einsum("bqk,bqd->bkd", p, gb32)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Forward: the op :func:`flash_attention_fwd` (kernel B2 on CUDA
    inputs, the plain version on CPU ones); saved for the backward: q, k,
    v and the segment ids only (reference ``_flash_fwd``), never the
    probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, block_q):
        cpu = _on_cpu(q, k, v, segment_ids)
        if not _eager(q, k, v, segment_ids):
            out = torch.ops.paddle_tpu_torch.flash_attention_fwd(
                q, k, v, segment_ids, causal)
        elif cpu:
            out = flash_attention_plain(q, k, v, causal, segment_ids)
        else:
            out = _flash_attention_fwd_cuda(q, k, v, segment_ids, causal)
        ctx.save_for_backward(q, k, v, segment_ids)
        ctx.causal, ctx.block_q = causal, block_q
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, segment_ids = ctx.saved_tensors
        b, h, t, d = q.shape
        grads = _flash_backward(
            q.reshape(b * h, t, d), k.reshape(b * h, t, d),
            v.reshape(b * h, t, d), _bh_segments(segment_ids, b, h, t),
            g.reshape(b * h, t, d), ctx.causal, ctx.block_q)
        dq, dk, dv = (x.reshape(b, h, t, d) for x in grads)
        return dq, dk, dv, None, None, None


def _flash_args(q, k, v, segment_ids):
    """[BH, T, D] inputs (with [T] or [B, T] ids) -> [B, H, T, D] ones,
    checked; and whether to squeeze the batch axis back out."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
        if segment_ids is not None and segment_ids.dim() == 1:
            segment_ids = segment_ids[None]
    b, _, t, _ = q.shape
    _require(k.shape == q.shape and v.shape == q.shape,
             "q, k, v shapes differ: %s %s %s", tuple(q.shape),
             tuple(k.shape), tuple(v.shape))
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k, v dtypes differ: %s %s %s", q.dtype, k.dtype, v.dtype)
    if segment_ids is not None:
        _require(tuple(segment_ids.shape) == (b, t),
                 "segment_ids must be [B, T] = %s, got %s", (b, t),
                 tuple(segment_ids.shape))
    return q, k, v, segment_ids, squeeze


def flash_attention(q, k, v, causal=False, segment_ids=None, block_q=256):
    """q, k, v: [B, H, T, D] (or [BH, T, D]) float32 or bfloat16 ->
    same-shape output, differentiable. ``segment_ids``: [B, T] int (0 =
    padding) — a key is attendable iff its id matches the query's and is
    nonzero; padded query rows yield zeros. ``block_q``: the backward's
    query chunk, as in the reference (the forward's tile is the
    kernel's own)."""
    q, k, v, segment_ids, squeeze = _flash_args(q, k, v, segment_ids)
    out = _Flash.apply(q, k, v, segment_ids, causal, block_q)
    return out[0] if squeeze else out


flash_attention.launches = 0
flash_attention.launches_bf16 = 0


def flash_attention_tile(q, k, v, block_q, block_k, causal=False):
    """B2's bfloat16 forward at the tile ``block_q`` x ``block_k`` (one of
    :data:`SWEEP_TILES`, head dim 128) with no segment ids: the sweep
    entry of T2. Not differentiable; CPU inputs take the plain version,
    which no tile changes."""
    q, k, v, _, squeeze = _flash_args(q, k, v, None)
    if _on_cpu(q, k, v):
        out = flash_attention_plain(q, k, v, causal)
    else:
        _check_flash(q, k, v, None)
        _require(q.dtype == torch.bfloat16 and q.shape[-1] == 128
                 and (block_q, block_k) in SWEEP_TILES,
                 "the tile sweep takes bfloat16 at head dim 128 and a tile "
                 "of %s, got %s, D %d, %s", SWEEP_TILES, q.dtype,
                 q.shape[-1], (block_q, block_k))
        out = _launch_flash(q, k, v, None, causal, (block_q, block_k))
        flash_attention_tile.launches += 1
    return out[0] if squeeze else out


flash_attention_tile.launches = 0


def decode_attention_plain(q, k_cache, v_cache, lengths, num_heads):
    """The plain version of :func:`decode_attention`, on any device:
    the cache is upcast to float32 and transposed to [S*H, C, D] for
    :func:`_decode_reference`."""
    s, hd = q.shape
    c = k_cache.shape[1]
    d = hd // num_heads
    k_cache, v_cache = k_cache.float(), v_cache.float()
    kh = k_cache.reshape(s, c, num_heads, d).transpose(1, 2)
    vh = v_cache.reshape(s, c, num_heads, d).transpose(1, 2)
    out = _decode_reference(
        q.reshape(s * num_heads, 1, d), kh.reshape(s * num_heads, c, d),
        vh.reshape(s * num_heads, c, d), lengths.repeat_interleave(num_heads))
    return out.reshape(s, hd)


def decode_attention(q, k_cache, v_cache, lengths, num_heads):
    """One query per slot against a dense cache in its native layout:
    q [S, H*D], k_cache/v_cache [S, C, H*D], lengths [S] int (live rows
    per slot; row c is attendable iff c < lengths[s]), the caches
    float32 or bfloat16. Returns [S, H*D] float32. A length of 0
    yields zeros from the kernel and the mean of V from the plain
    version; callers pass lengths >= 1."""
    s, hd = q.shape
    _require(k_cache.dim() == 3 and k_cache.shape[0] == s
             and k_cache.shape[2] == hd and v_cache.shape == k_cache.shape,
             "caches must be [S, C, H*D] = [%d, C, %d], got %s %s", s, hd,
             tuple(k_cache.shape), tuple(v_cache.shape))
    _require(hd % num_heads == 0,
             "H*D = %d not divisible by %d heads", hd, num_heads)
    _require(tuple(lengths.shape) == (s,),
             "lengths must be [S] = [%d], got %s", s, tuple(lengths.shape))
    cpu = _on_cpu(q, k_cache, v_cache, lengths)
    if _eager(q, k_cache, v_cache, lengths):
        impl = decode_attention_plain if cpu else _decode_attention_cuda
    else:
        impl = torch.ops.paddle_tpu_torch.decode_attention
    return impl(q, k_cache, v_cache, lengths, num_heads)


decode_attention.launches = 0


@torch.library.custom_op("paddle_tpu_torch::decode_attention",
                         mutates_args=(), device_types="cpu")
def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, lengths: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """:func:`decode_attention` as a torch op: on the CPU the plain
    version, on the card kernel B4."""
    return decode_attention_plain(q, k_cache, v_cache, lengths,
                                  num_heads)


@decode_attention_op.register_kernel("cuda")
def _decode_attention_cuda(q, k_cache, v_cache, lengths, num_heads):
    s, hd = q.shape
    d = hd // num_heads
    kind = _check_decode_inputs(q, k_cache, v_cache)
    _require(d in _HEAD_DIMS, "head dim %d not in %s", d, _HEAD_DIMS)
    _require(lengths.dtype == torch.int32 and lengths.is_contiguous(),
             "lengths must be contiguous int32")
    out = _launch_dense(q, k_cache, v_cache, lengths, num_heads,
                        _split_plan(s, num_heads, d, k_cache.shape[1]),
                        _build.entry("decode_attention_" + kind))
    decode_attention.launches += 1
    return out


@decode_attention_op.register_fake
def _decode_attention_fake(q, k_cache, v_cache, lengths, num_heads):
    return torch.empty_like(q)


def _launch_dense(q, k_cache, v_cache, lengths, num_heads, plan, fn,
                  work=None):
    """One launch of B4 through its C entry ``fn`` by ``plan`` on checked
    CUDA inputs; not counted. The partials go to the thread's shared
    scratch, the counters to a zeroed buffer of their own, which the
    kernel leaves zeroed. ``work``, an int32 [2] on the card, gains the
    CTAs that took a work item and the items they took."""
    s, hd = q.shape
    out = torch.empty_like(q)
    dev = q.device
    stream = _build.stream(dev)
    scratch, counters = _build.split_buffers(dev, stream, plan.scratch_bytes,
                                             plan.counters)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
             counters.data_ptr(), None if work is None else work.data_ptr(),
             s, num_heads, hd // num_heads, k_cache.shape[1], plan.chunk,
             plan.ctas, stream)
    _build.check(err, "decode_attention")
    return out


# the split-key body both decode kernels share (``kWarps``, ``kLoadsF32``,
# ``kLoadsBF16`` in csrc/decode_split.cuh): CTAs of SPLIT_WARPS warps,
# each lane keeping SPLIT_LOADS[cache dtype] 16-byte loads of K and of V
# in flight, work items of one head and SPLIT_CHUNK logical rows; the grid
# walks the items with at most SPLIT_MAX_CTAS CTAs (eight on each of the
# H100's 132 SMs: at the serving path's width one CTA an item). The
# chunk, the grid and the loads are the fastest of the sweep at the
# probe's three sets of lengths (``python3 -m
# paddle_tpu_torch.probes.decode sweep``; PERF.md)
SPLIT_WARPS = 8
SPLIT_LOADS = {torch.float32: 8, torch.bfloat16: 4}
SPLIT_CHUNK = 128
SPLIT_MAX_CTAS = 8 * 132

SplitPlan = collections.namedtuple("SplitPlan", "chunk max_chunks ctas "
                                                "scratch_bytes counters")


@functools.lru_cache(maxsize=1024)
def _split_plan(slots, heads, d, cap, chunk=None, ctas=None):
    """The launch of a split-key decode kernel for ``slots`` x ``heads``
    queries of head dim ``d`` over ``cap`` logical rows a slot (B4: the
    cache's C; B5: the table's MB * BS): the chunk of logical rows a work
    item takes, the most chunks a slot can have, the CTAs of the grid,
    the scratch for each (slot, head, chunk)'s partial (m, l, acc[d]) in
    f32, and the int32 counters B4 needs, one a (slot, head). Nothing
    here depends on the lengths, which stay on the card. ``chunk`` and
    ``ctas`` serve the probe's sweep."""
    chunk = SPLIT_CHUNK if chunk is None else chunk
    max_chunks = -(-cap // chunk)
    items = slots * max_chunks * heads
    ctas = min(items, SPLIT_MAX_CTAS if ctas is None else ctas)
    return SplitPlan(chunk, max_chunks, ctas,
                     4 * (2 + d) * slots * heads * max_chunks, slots * heads)


def _paged_plan(slots, heads, d, bs, mb, chunk=None, ctas=None):
    """Kernel B5's launch over tables of ``mb`` blocks of ``bs`` rows:
    :func:`_split_plan` at MB * BS logical rows a slot."""
    return _split_plan(slots, heads, d, mb * bs, chunk, ctas)


def _decode_paged_reference(q, k_pool, v_pool, lengths, tables, num_heads):
    """The plain version of :func:`decode_attention_paged`, on any
    device (reference ``_decode_paged_reference``): block ids clipped
    into [0, NB), each slot's blocks gathered into a dense [S, MB*BS,
    H*D] cache, then :func:`decode_attention_plain` on it. After the
    gather it is the dense decode exactly, so the paged and dense
    layouts give the same tokens."""
    s = q.shape[0]
    nb, bs, hd = k_pool.shape
    tbl = tables.to(device=k_pool.device, dtype=torch.long).clamp(0, nb - 1)
    c = tbl.shape[1] * bs
    return decode_attention_plain(q, k_pool[tbl].reshape(s, c, hd),
                                  v_pool[tbl].reshape(s, c, hd), lengths,
                                  num_heads)


def decode_attention_paged(q, k_pool, v_pool, lengths, tables, num_heads):
    """One query per slot against a paged cache: q [S, H*D], pools
    [NB, BS, H*D] (float32 or bfloat16, as for :func:`decode_attention`),
    lengths [S] int (live logical rows per slot), tables
    [S, MB] int block ids: logical row c of slot s is pool row
    ``tables[s, c // BS] * BS + c % BS``. Entries outside [0, NB) are
    clamped into it (the host marks dead entries with NB) and the length
    keeps them unattended. Returns [S, H*D]. Lengths >= 1, as for
    :func:`decode_attention`."""
    s, hd = q.shape
    _require(k_pool.dim() == 3 and k_pool.shape[2] == hd
             and v_pool.shape == k_pool.shape,
             "pools must be [NB, BS, H*D] = [NB, BS, %d], got %s %s", hd,
             tuple(k_pool.shape), tuple(v_pool.shape))
    _require(hd % num_heads == 0,
             "H*D = %d not divisible by %d heads", hd, num_heads)
    _require(tuple(lengths.shape) == (s,),
             "lengths must be [S] = [%d], got %s", s, tuple(lengths.shape))
    _require(tables.dim() == 2 and tables.shape[0] == s
             and tables.shape[1] >= 1,
             "tables must be [S, MB] = [%d, MB >= 1], got %s", s,
             tuple(tables.shape))
    cpu = _on_cpu(q, k_pool, v_pool, lengths, tables)
    if _eager(q, k_pool, v_pool, lengths, tables):
        impl = _decode_paged_reference if cpu \
            else _decode_attention_paged_cuda
    else:
        impl = torch.ops.paddle_tpu_torch.decode_attention_paged
    return impl(q, k_pool, v_pool, lengths, tables, num_heads)


decode_attention_paged.launches = 0


@torch.library.custom_op("paddle_tpu_torch::decode_attention_paged",
                         mutates_args=(), device_types="cpu")
def decode_attention_paged_op(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, lengths: torch.Tensor,
                              tables: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """:func:`decode_attention_paged` as a torch op: on the CPU the plain
    version, on the card kernel B5."""
    return _decode_paged_reference(q, k_pool, v_pool, lengths, tables,
                                   num_heads)


@decode_attention_paged_op.register_kernel("cuda")
def _decode_attention_paged_cuda(q, k_pool, v_pool, lengths, tables,
                                 num_heads):
    s, hd = q.shape
    nb, bs, _ = k_pool.shape
    mb = tables.shape[1]
    d = hd // num_heads
    kind = _check_decode_inputs(q, k_pool, v_pool)
    _require(d in _HEAD_DIMS, "head dim %d not in %s", d, _HEAD_DIMS)
    _require(nb >= 1 and bs >= 1, "empty pool %s", tuple(k_pool.shape))
    for name, x in (("lengths", lengths), ("tables", tables)):
        _require(x.dtype == torch.int32 and x.is_contiguous(),
                 "%s must be contiguous int32", name)
    plan = _paged_plan(s, num_heads, d, bs, mb)
    out = _launch_paged(q, k_pool, v_pool, lengths, tables, num_heads, plan,
                        _build.entry("decode_attention_paged_" + kind))
    decode_attention_paged.launches += 1
    return out


@decode_attention_paged_op.register_fake
def _decode_attention_paged_fake(q, k_pool, v_pool, lengths, tables,
                                 num_heads):
    return torch.empty_like(q)


def _launch_paged(q, k_pool, v_pool, lengths, tables, num_heads, plan, fn,
                  work=None):
    """One call of B5's C entry ``fn`` (its split and combine launches)
    by ``plan`` on checked CUDA inputs; not counted. ``work``, an int32
    [2] on the card, gains the split's CTAs that took a work item and the
    items they took."""
    s, hd = q.shape
    nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    stream = _build.stream(q.device)
    scratch = _build.scratch(q.device, stream, plan.scratch_bytes)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), None if work is None else work.data_ptr(),
             s, num_heads, hd // num_heads, nb, bs,
             tables.shape[1], plan.chunk, plan.ctas, stream)
    _build.check(err, "decode_attention_paged")
    return out
