"""Sequence ops over padded batches and explicit lengths (reference
``paddle_tpu/ops/sequence_ops.py``): a sequence batch is ``(data[B, T,
...], length[B])``, and padding is masked so that the results are the
reference's ragged semantics.

The reference's ``lax.scan`` time loops are Python loops of torch ops on
the tensors' device here: state flows through padded steps unchanged,
by the masked carry ``m * h_new + (1 - m) * h_prev``, and ``is_reverse``
flips the time axis before and after. The recurrent products are
``torch.matmul`` (cuBLAS on the card), as the reference's are XLA dots
outside any Pallas kernel; ``torch.nn.LSTM``/``GRU`` are not used (their
gate order differs and they do not carry padded steps through).

Gate layouts are the reference's, so checkpoints cross unchanged:
``dynamic_lstm``'s weight is {W_ch, W_ih, W_fh, W_oh}, gates ordered
[candidate, input, forget, output], its bias {b_c, b_i, b_f, b_o} then
the peepholes {W_ic, W_fc, W_oc}; ``lstm_unit`` is [input, forget,
output, candidate]; a GRU is [update, reset | candidate] with
h_t = (1 - u) * h_{t-1} + u * c_t.

No op reads anything back to the host: lengths stay tensors, and every
gather clamps or wraps its indices on the device as XLA's does.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..core.framework import torch_dtype
from ..core.registry import register_op
from .tensor_ops import _on_device

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": (lambda x: x), "linear": (lambda x: x)}


def _mask_from(ctx, x, time_axis=1):
    """[B, T] float32 mask from the optional ``Length`` input; all ones
    without it (a fully packed batch)."""
    t = x.shape[time_axis]
    if ctx.has_input("Length"):
        length = ctx.input("Length").reshape(-1)
        cols = torch.arange(t, device=length.device)
        return (cols[None, :] < length[:, None]).to(torch.float32)
    return torch.ones((x.shape[0], t), dtype=torch.float32, device=x.device)


def _trail(t, ndim):
    """``t`` with ``ndim`` unit dimensions appended."""
    return t.reshape(tuple(t.shape) + (1,) * ndim)


def take_time(x, idx, axis=1):
    """``jnp.take_along_axis(x, idx[..., None...], axis)`` for an index
    of ``x``'s leading dims through ``axis``: negative indices wrap once
    (as JAX normalizes them) and the rest is broadcast over the trailing
    dims. Indices past the end must not occur."""
    n = x.shape[axis]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    idx = _trail(idx, x.ndim - idx.ndim)
    idx = idx.expand(tuple(idx.shape[:axis + 1]) + tuple(x.shape[axis + 1:]))
    return torch.gather(x, axis, idx)


def _steps(*seqs, axis=1):
    """Each of ``seqs`` as its steps along ``axis`` (``torch.unbind``):
    one node whose gradient stacks the steps' gradients, where a slice a
    step would add a zero-filled gradient of the whole tensor a step."""
    return [torch.unbind(s, dim=axis) for s in seqs]


def _loop_steps(*seqs):
    """``_steps`` of ``seqs`` along the time axis, and the length the
    stacked steps take: on ``meta`` tensors (shape inference at build
    time) only the first step, since every step has its shapes and an
    unknown length stands in as 8191 steps; the caller expands the
    stacked step to the length."""
    t = seqs[0].shape[1]
    if seqs[0].device.type == "meta":
        seqs = [s[:, :1] for s in seqs]
    return _steps(*seqs), t


def _stack_steps(steps, t):
    """The steps of a ``_loop_steps`` loop stacked to [B, t, ...]."""
    out = torch.stack(steps, dim=1)
    return out if out.shape[1] == t else out.expand(-1, t, *out.shape[2:])


def _finfo_min(x):
    return torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                      device=x.device)


@register_op("sequence_mask")
def _sequence_mask(ctx):
    """[B, maxlen] mask of ``dtype``: 1 where the column is below the
    row's length (``Length`` flattened to [B])."""
    length = ctx.input("Length").reshape(-1)
    maxlen = ctx.attr("maxlen")
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    cols = torch.arange(maxlen, device=length.device)
    return {"Out": (cols[None, :] < length[:, None]).to(dtype)}


def pool_masked(x, m, pool, axis):
    """The masked pools of ``sequence_pool`` over ``axis`` (``m`` the mask
    broadcast to ``x``), shared with ``nested_sequence_pool``: average,
    sum, sqrt and max; None for the positional pools."""
    count = torch.clamp(torch.sum(m, dim=axis), min=1.0)
    if pool in ("average", "avg"):
        return torch.sum(x * m, dim=axis) / count
    if pool == "sum":
        return torch.sum(x * m, dim=axis)
    if pool == "sqrt":
        return torch.sum(x * m, dim=axis) / torch.sqrt(count)
    if pool == "max":
        return torch.amax(torch.where(m > 0, x, _finfo_min(x)), dim=axis)
    return None


@register_op("sequence_pool")
def _sequence_pool(ctx):
    """Pool over time with padding masked: average, sum, sqrt, max,
    first, last. ``last`` of a zero-length row takes index -1, which
    wraps to the row's last (padding) step, as the reference's
    ``take_along_axis`` does."""
    x = ctx.input("X")
    pool = ctx.attr("pool_type", "average").lower()
    mask = _mask_from(ctx, x)
    m = _trail(mask, x.ndim - 2).to(x.dtype)
    out = pool_masked(x, m, pool, 1)
    if out is not None:
        return {"Out": out}
    if pool == "first":
        return {"Out": x[:, 0]}
    if pool == "last":
        if ctx.has_input("Length"):
            idx = ctx.input("Length").reshape(-1) - 1
            return {"Out": take_time(x, idx[:, None])[:, 0]}
        return {"Out": x[:, -1]}
    raise ValueError("unknown pool_type %r" % pool)


@register_op("sequence_softmax")
def _sequence_softmax(ctx):
    x = ctx.input("X")
    mask = _mask_from(ctx, x).to(x.dtype)
    out = torch.softmax(torch.where(mask > 0, x, _finfo_min(x)), dim=1)
    return {"Out": out * mask}


@register_op("sequence_expand")
def _sequence_expand(ctx):
    """Each row of X [B, ...] repeated over Y's time axis; with a
    ``Length`` (Y's lengths) the steps past a row's length are zero."""
    x, y = ctx.input("X"), ctx.input("Y")
    t = y.shape[1]
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    if ctx.has_input("Length"):
        length = ctx.input("Length").reshape(-1)
        mask = torch.arange(t, device=x.device)[None, :] < length[:, None]
        out = torch.where(_trail(mask, x.ndim - 1), out,
                          torch.zeros((), dtype=x.dtype, device=x.device))
    return {"Out": out}


@register_op("sequence_reverse")
def _sequence_reverse(ctx):
    """Reverse the valid prefix of each row, the padding staying at the
    end."""
    x = ctx.input("X")
    t = x.shape[1]
    if not ctx.has_input("Length"):
        return {"Out": torch.flip(x, dims=(1,))}
    length = ctx.input("Length").reshape(-1)
    cols = torch.arange(t, device=x.device)[None, :]
    idx = length[:, None] - 1 - cols
    valid = idx >= 0
    idx = torch.where(valid, idx, cols)
    out = take_time(x, idx)
    return {"Out": torch.where(_trail(valid, x.ndim - 2), out, x)}


def _left_pack(x, keep):
    """(x's kept elements first in their order, zeros after; the kept
    counts as int32): a stable sort on ``~keep``, as the reference's
    ``argsort(..., stable=True)``."""
    t = x.shape[1]
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(x, 1, order)
    new_len = torch.sum(keep, dim=1).to(torch.int32)
    out_mask = torch.arange(t, device=x.device)[None, :] < new_len[:, None]
    return torch.where(out_mask, packed, torch.zeros((), dtype=x.dtype,
                                                     device=x.device)), \
        new_len


@register_op("sequence_erase")
def _sequence_erase(ctx):
    """Remove the listed tokens and left-pack each row."""
    x = ctx.input("X")
    length = ctx.input("Length").reshape(-1)
    tokens = tuple(ctx.attr("tokens"))
    t = x.shape[1]
    in_range = torch.arange(t, device=x.device)[None, :] < length[:, None]
    erased = torch.isin(x, _on_device(tokens, (len(tokens),),
                                      np.dtype(str(x.dtype).split(".")[1]),
                                      x.device)) \
        if tokens else torch.zeros_like(in_range)
    out, new_len = _left_pack(x, in_range & ~erased)
    return {"Out": out, "OutLength": new_len}


@register_op("sequence_conv")
def _sequence_conv(ctx):
    """Context-window projection: the rows of a sliding window
    concatenated, then one product with the filter."""
    x = ctx.input("X")
    w = ctx.input("Filter")
    ctx_len = ctx.attr("contextLength", 3)
    ctx_start = ctx.attr("contextStart", -(ctx_len // 2))
    t = x.shape[1]
    cols = []
    for off in range(ctx_start, ctx_start + ctx_len):
        if off < 0:
            cols.append(F.pad(x, (0, 0, -off, 0))[:, :t])
        elif off > 0:
            cols.append(F.pad(x, (0, 0, 0, off))[:, off:])
        else:
            cols.append(x)
    return {"Out": torch.matmul(torch.cat(cols, dim=-1), w)}


def run_lstm(x_proj, w, bias, mask, h0, c0, use_peepholes, acts):
    """The reference's ``_run_lstm``: x_proj [B, T, 4H] (the input's gate
    projection), mask [B, T]; returns hidden and cell [B, T, H]."""
    act_gate, act_cell, act_cand = acts
    b, _, four_h = x_proj.shape
    h = four_h // 4
    peep = None
    if bias is not None:
        gate_bias = bias.reshape(-1)[:4 * h]
        if use_peepholes:
            peep = bias.reshape(-1)[4 * h:]
    else:
        gate_bias = 0.0
    if peep is not None:
        w_ic, w_fc, w_oc = torch.chunk(peep, 3)
    hp = h0 if h0 is not None else x_proj.new_zeros((b, h))
    cp = c0 if c0 is not None else x_proj.new_zeros((b, h))
    ms = mask.to(x_proj.dtype)[:, :, None]
    keeps = 1.0 - ms      # once for every step, as each step's 1 - m
    hs, cs = [], []
    steps, t = _loop_steps(x_proj, ms, keeps)
    for x_t, m, keep in zip(*steps):
        gates = x_t + hp @ w + gate_bias
        gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
        if peep is not None:
            gi = gi + cp * w_ic
            gf = gf + cp * w_fc
        ig = act_gate(gi)
        fg = act_gate(gf)
        cand = act_cand(gc)
        c_new = fg * cp + ig * cand
        if peep is not None:
            go = go + c_new * w_oc
        o = act_gate(go)
        h_new = o * act_cell(c_new)
        hp = m * h_new + keep * hp
        cp = m * c_new + keep * cp
        hs.append(hp)
        cs.append(cp)
    return _stack_steps(hs, t), _stack_steps(cs, t)


@register_op("dynamic_lstm")
def _dynamic_lstm(ctx):
    x = ctx.input("Input")
    mask = _mask_from(ctx, x)
    acts = (_ACT[ctx.attr("gate_activation", "sigmoid")],
            _ACT[ctx.attr("cell_activation", "tanh")],
            _ACT[ctx.attr("candidate_activation", "tanh")])
    rev = ctx.attr("is_reverse", False)
    if rev:
        x, mask = torch.flip(x, dims=(1,)), torch.flip(mask, dims=(1,))
    hidden, cell = run_lstm(x, ctx.input("Weight"), ctx.input("Bias"), mask,
                            ctx.input("H0"), ctx.input("C0"),
                            ctx.attr("use_peepholes", False), acts)
    if rev:
        hidden, cell = torch.flip(hidden, dims=(1,)), \
            torch.flip(cell, dims=(1,))
    return {"Hidden": hidden, "Cell": cell}


def gru_step(x_t, hp, w_g, w_c, b_g, b_c, m, keep, act_gate, act_cand):
    """One masked GRU step (the reference's ``dynamic_gru`` body); ``keep``
    is ``1 - m``."""
    h = hp.shape[-1]
    g = x_t[:, :2 * h] + hp @ w_g + b_g
    u, r = torch.chunk(act_gate(g), 2, dim=-1)
    c = act_cand(x_t[:, 2 * h:] + (r * hp) @ w_c + b_c)
    h_new = (1.0 - u) * hp + u * c
    return m * h_new + keep * hp


@register_op("dynamic_gru")
def _dynamic_gru(ctx):
    x = ctx.input("Input")
    w = ctx.input("Weight")
    bias = ctx.input("Bias")
    mask = _mask_from(ctx, x)
    act_gate = _ACT[ctx.attr("gate_activation", "sigmoid")]
    act_cand = _ACT[ctx.attr("candidate_activation", "tanh")]
    rev = ctx.attr("is_reverse", False)
    if rev:
        x, mask = torch.flip(x, dims=(1,)), torch.flip(mask, dims=(1,))
    b, _, three_h = x.shape
    h = three_h // 3
    w_g, w_c = w[:, :2 * h], w[:, 2 * h:]
    bvec = bias.reshape(-1) if bias is not None else x.new_zeros(3 * h)
    b_g, b_c = bvec[:2 * h], bvec[2 * h:]
    hp = ctx.input("H0")
    if hp is None:
        hp = x.new_zeros((b, h))
    ms = mask.to(x.dtype)[:, :, None]
    keeps = 1.0 - ms
    hs = []
    steps, t = _loop_steps(x, ms, keeps)
    for x_t, m, keep in zip(*steps):
        hp = gru_step(x_t, hp, w_g, w_c, b_g, b_c, m, keep, act_gate,
                      act_cand)
        hs.append(hp)
    hidden = _stack_steps(hs, t)
    if rev:
        hidden = torch.flip(hidden, dims=(1,))
    return {"Hidden": hidden}


@register_op("gru_unit")
def _gru_unit(ctx):
    x = ctx.input("Input")
    hp = ctx.input("HiddenPrev")
    w = ctx.input("Weight")
    bias = ctx.input("Bias")
    act_gate = _ACT[ctx.attr("gate_activation", "sigmoid")]
    act_cand = _ACT[ctx.attr("activation", "tanh")]
    h = hp.shape[-1]
    xb = x + bias.reshape(-1) if bias is not None else x + 0.0
    gate = act_gate(xb[:, :2 * h] + hp @ w[:, :2 * h])
    u, r = torch.chunk(gate, 2, dim=-1)
    reset_h = r * hp
    c = act_cand(xb[:, 2 * h:] + reset_h @ w[:, 2 * h:])
    h_new = (1.0 - u) * hp + u * c
    return {"Hidden": h_new, "Gate": torch.cat([gate, c], dim=-1),
            "ResetHiddenPrev": reset_h}


@register_op("lstm_unit")
def _lstm_unit(ctx):
    x = ctx.input("X")
    cp = ctx.input("C_prev")
    forget_bias = ctx.attr("forget_bias", 0.0)
    gi, gf, go, gc = torch.chunk(x, 4, dim=-1)
    c_new = torch.sigmoid(gf + forget_bias) * cp + \
        torch.sigmoid(gi) * torch.tanh(gc)
    h_new = torch.sigmoid(go) * torch.tanh(c_new)
    return {"H": h_new, "C": c_new}


@register_op("sequence_reshape")
def _sequence_reshape(ctx):
    """[B, T, D] -> [B, T*D/new_dim, new_dim], the lengths scaled by
    D/new_dim (each valid length must satisfy (length * D) % new_dim ==
    0, as the reference's contract says)."""
    x = ctx.input("X")
    new_dim = ctx.attr("new_dim")
    b, t, d = x.shape
    if (t * d) % new_dim:
        raise ValueError("sequence_reshape: T*D=%d not divisible by "
                         "new_dim=%d" % (t * d, new_dim))
    outs = {"Out": x.reshape(b, (t * d) // new_dim, new_dim)}
    if ctx.has_input("Length"):
        length = ctx.input("Length").reshape(-1)
        outs["OutLength"] = torch.div(length * d, new_dim,
                                      rounding_mode="floor").to(length.dtype)
    return outs


@register_op("lod_reset")
def _lod_reset(ctx):
    """The data through unchanged and the new lengths clipped to the time
    axis and, given ``OrigLength``, to the valid lengths."""
    x = ctx.input("X")
    new_len = ctx.input("Length").reshape(-1)
    t = x.shape[1] if x.ndim > 1 else x.shape[0]
    out_len = torch.clamp(new_len, 0, t)
    if ctx.has_input("OrigLength"):
        out_len = torch.minimum(out_len,
                                ctx.input("OrigLength").reshape(-1))
    return {"Out": x, "OutLength": out_len.to(new_len.dtype)}


@register_op("max_sequence_len")
def _max_sequence_len(ctx):
    return {"Out": torch.amax(ctx.input("Length").reshape(-1)).reshape(1)}


@register_op("sequence_concat_packed")
def _sequence_concat_packed(ctx):
    """out[i] = a[i, :la[i]] ++ b[i, :lb[i]], left-packed and zero-padded
    to Ta + Tb."""
    a, b = ctx.input("A"), ctx.input("B")
    la = ctx.input("LenA").reshape(-1).to(torch.int32)
    lb = ctx.input("LenB").reshape(-1).to(torch.int32)
    ta, tb = a.shape[1], b.shape[1]
    src = torch.cat([a, b], dim=1)
    t = torch.arange(ta + tb, device=a.device)[None, :]
    idx = torch.where(t < la[:, None], t, ta + (t - la[:, None]))
    idx = torch.clamp(idx, 0, ta + tb - 1)
    gathered = take_time(src, idx)
    valid = _trail(t < (la + lb)[:, None], a.ndim - 2)
    out = torch.where(valid, gathered,
                      torch.zeros((), dtype=src.dtype, device=src.device))
    return {"Out": out, "OutLen": la + lb}
