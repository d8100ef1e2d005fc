"""Flash attention for prefill and decode: the wrappers of the port's two
CUDA kernels and their plain PyTorch versions.

* :func:`flash_attention` replaces the Pallas kernel
  ``paddle_tpu/ops/pallas_attention.py::flash_attention`` (forward only:
  the port serves, it does not train yet). Kernel:
  ``csrc/flash_attention.cu``. On the H100 it is bound by f32
  operations on the CUDA cores; the kernel keeps the [T, T] scores out
  of device memory and skips causal tiles above the diagonal.
* :func:`decode_attention` replaces
  ``paddle_tpu/ops/pallas_attention.py::decode_attention``. Kernel:
  ``csrc/decode_attention.cu``. It is bound by device-memory bytes; the
  kernel reads the cache in its native [S, C, H*D] layout (no transpose
  copy) and only the rows below each slot's length.

A wrapper given CPU tensors computes the plain version (the CPU tests
rely on it). Given CUDA tensors it launches the kernel or raises: there
is no fallback. Each wrapper counts its kernel launches in
``<wrapper>.launches``.
"""

import torch

from . import _build

_NEG = -1e30
_HEAD_DIMS = (64, 128)


def _reference(q, k, v, causal, seg=None):
    """Plain attention over [BH, T, D]; ``seg`` [BH, T] int32 segment
    ids, 0 = padding: a key is attendable by a query iff their ids match
    and the key's id is nonzero. Padded query rows output 0."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * (q.shape[-1] ** -0.5)
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


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _on_cpu(*tensors):
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError("tensors must all lie on the CPU or all on one "
                         "CUDA device, got %s" % sorted(devices))
    return False


def _check_f32(name, t):
    _require(t.dtype == torch.float32,
             "%s must be float32, got %s" % (name, t.dtype))
    _require(t.is_contiguous(), "%s must be contiguous" % name)
    _require(t.data_ptr() % 16 == 0, "%s must be 16-byte aligned" % name)


def flash_attention_plain(q, k, v, causal=False, segment_ids=None):
    """The plain version of :func:`flash_attention` on [B, H, T, D]
    inputs, on any device."""
    b, h, t, d = q.shape
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)[:, None, :].expand(
            b, h, t).reshape(b * h, t)
    out = _reference(q.reshape(b * h, t, d), k.reshape(b * h, t, d),
                     v.reshape(b * h, t, d), causal, seg)
    return out.reshape(b, h, t, d)


def flash_attention(q, k, v, causal=False, segment_ids=None):
    """q, k, v: [B, H, T, D] (or [BH, T, D]) -> same-shape output.
    ``segment_ids``: [B, T] int (0 = padding) — a key is attendable iff
    its id matches the query's and is nonzero; padded query rows yield
    zeros."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
        if segment_ids is not None and segment_ids.dim() == 1:
            segment_ids = segment_ids[None]
    b, h, t, d = q.shape
    _require(k.shape == q.shape and v.shape == q.shape,
             "q, k, v shapes differ: %s %s %s"
             % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if segment_ids is not None:
        _require(tuple(segment_ids.shape) == (b, t),
                 "segment_ids must be [B, T] = %s, got %s"
                 % ((b, t), tuple(segment_ids.shape)))
    if _on_cpu(q, k, v, segment_ids):
        out = flash_attention_plain(q, k, v, causal, segment_ids)
    else:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_f32(name, x)
        _require(d in _HEAD_DIMS, "head dim %d not in %s" % (d, _HEAD_DIMS))
        if segment_ids is not None:
            _require(segment_ids.dtype == torch.int32
                     and segment_ids.is_contiguous(),
                     "segment_ids must be contiguous int32")
        out = torch.empty_like(q)
        fn = _build.entry("flash_attention_f32")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if segment_ids is None else segment_ids.data_ptr(),
                 out.data_ptr(), b * h, t, d, h, int(causal), stream)
        _build.check(err, "flash_attention")
        flash_attention.launches += 1
    return out[0] if squeeze else out


flash_attention.launches = 0


def decode_attention_plain(q, k_cache, v_cache, lengths, num_heads):
    """The plain version of :func:`decode_attention`, on any device:
    the cache is transposed to [S*H, C, D] for :func:`_decode_reference`."""
    s, hd = q.shape
    c = k_cache.shape[1]
    d = hd // num_heads
    kh = k_cache.reshape(s, c, num_heads, d).transpose(1, 2)
    vh = v_cache.reshape(s, c, num_heads, d).transpose(1, 2)
    out = _decode_reference(
        q.reshape(s * num_heads, 1, d), kh.reshape(s * num_heads, c, d),
        vh.reshape(s * num_heads, c, d), lengths.repeat_interleave(num_heads))
    return out.reshape(s, hd)


def decode_attention(q, k_cache, v_cache, lengths, num_heads):
    """One query per slot against a dense cache in its native layout:
    q [S, H*D], k_cache/v_cache [S, C, H*D], lengths [S] int (live rows
    per slot; row c is attendable iff c < lengths[s]). Returns
    [S, H*D]. A length of 0 yields zeros from the kernel and the mean
    of V from the plain version; callers pass lengths >= 1."""
    s, hd = q.shape
    _require(k_cache.dim() == 3 and k_cache.shape[0] == s
             and k_cache.shape[2] == hd and v_cache.shape == k_cache.shape,
             "caches must be [S, C, H*D] = [%d, C, %d], got %s %s"
             % (s, hd, tuple(k_cache.shape), tuple(v_cache.shape)))
    _require(hd % num_heads == 0,
             "H*D = %d not divisible by %d heads" % (hd, num_heads))
    _require(tuple(lengths.shape) == (s,),
             "lengths must be [S] = [%d], got %s" % (s, tuple(lengths.shape)))
    c = k_cache.shape[1]
    d = hd // num_heads
    if _on_cpu(q, k_cache, v_cache, lengths):
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      num_heads)
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check_f32(name, x)
    _require(d in _HEAD_DIMS, "head dim %d not in %s" % (d, _HEAD_DIMS))
    _require(lengths.dtype == torch.int32 and lengths.is_contiguous(),
             "lengths must be contiguous int32")
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention_f32")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), s, num_heads, d, c, stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
