"""Ring attention: sequence parallelism over a mesh axis (reference
``paddle_tpu/parallel/ring_attention.py``).

The time dimension of attention is split over the ranks of one mesh
axis. Each rank keeps its queries and passes key/value blocks around the
ring (``torch.distributed.batch_isend_irecv`` to the previous rank, from
the next), accumulating flash-attention-style online-softmax partials in
float32, with the reference's guard for fully masked rows. Memory per
rank is O(T / P).

The backward recomputes: a second trip around the ring carries each
key/value block with the gradients of that block accumulated so far, and
after P steps every block is back at its owner with its gradient.
"""

import torch

from . import spmd

__all__ = ["ring_attention", "dense_attention"]

_NEG = -1e30


def dense_attention(q, k, v, causal=False, scale=None):
    """Single-device attention; q, k, v [B, T, H, D]."""
    scale = scale or (q.shape[-1] ** -0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _rotate(tensors, group):
    """Each tensor from this rank to the previous one of the ring, and
    the next one's to this rank."""
    n = spmd.group_size(group)
    if n == 1:
        return tensors
    dist = torch.distributed
    me = spmd.group_rank(group)
    prev = dist.get_global_rank(group, (me - 1) % n)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), prev, group))
        ops.append(dist.P2POp(dist.irecv, o, nxt, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _scores(q, k_blk, q_pos, k_pos, causal, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    return s


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n = spmd.group_size(group)
        idx = spmd.group_rank(group)
        b, tc, h, d = q.shape
        dev = q.device
        q_pos = idx * tc + torch.arange(tc, device=dev)
        m = torch.full((b, h, tc), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, tc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, tc, h, d), dtype=torch.float32, device=dev)
        k_blk, v_blk = k, v
        for i in range(n):
            src = (idx + i) % n            # owner of the block we hold
            k_pos = src * tc + torch.arange(tc, device=dev)
            s = _scores(q, k_blk, q_pos, k_pos, causal, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a fully masked row (m_new = -inf) contributes nothing
            dead = m_new <= _NEG / 2
            safe_m = torch.where(dead, torch.zeros_like(m_new), m_new)
            p = torch.exp(torch.where(dead[..., None],
                                      torch.full_like(s, _NEG),
                                      s - safe_m[..., None]))
            corr = torch.exp(torch.where(m <= _NEG / 2,
                                         torch.full_like(m, _NEG),
                                         m - safe_m))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p, v_blk.float())
            m = m_new
            if i + 1 < n:
                k_blk, v_blk = _rotate([k_blk, v_blk], group)
        lc = torch.clamp(l, min=1e-30)
        out = acc / lc.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(lc))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n = spmd.group_size(group)
        idx = spmd.group_rank(group)
        b, tc, h, d = q.shape
        dev = q.device
        g = g.float()
        q_pos = idx * tc + torch.arange(tc, device=dev)
        delta = (g * out).sum(dim=-1).transpose(1, 2)      # [b, h, tc]
        dq = torch.zeros((b, tc, h, d), dtype=torch.float32, device=dev)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for i in range(n):
            src = (idx + i) % n
            k_pos = src * tc + torch.arange(tc, device=dev)
            s = _scores(q, k_blk, q_pos, k_pos, causal, scale)
            p = torch.where(s <= _NEG / 2, torch.zeros_like(s),
                            torch.exp(s - lse[..., None]))
            dp = torch.einsum("bqhd,bkhd->bhqk", g, v_blk.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float())
            dk_blk = dk_blk + torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
            dv_blk = dv_blk + torch.einsum("bhqk,bqhd->bkhd", p, g)
            # n rotations bring every block, and its gradient, home
            k_blk, v_blk, dk_blk, dv_blk = _rotate(
                [k_blk, v_blk, dk_blk, dv_blk], group)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False,
                   scale=None, local=False):
    """q, k, v [B, T, H, D]; the time dimension is split over the ranks
    of ``axis_name``. By default every rank passes the GLOBAL q, k, v
    (the reference's global view) and gets the global output, gathered;
    with ``local`` each passes its own chunk of T (rank i of the axis
    holds positions i*Tc .. (i+1)*Tc - 1) and gets its chunk of the
    output. Differentiable."""
    scale = scale or (q.shape[-1] ** -0.5)
    group = mesh.group(axis_name)
    if local:
        return _Ring.apply(q, k, v, group, causal, scale)
    q, k, v = (spmd.SliceShared.apply(t, group, 1) for t in (q, k, v))
    out = _Ring.apply(q, k, v, group, causal, scale)
    return spmd.GatherShared.apply(out, group, 1)
