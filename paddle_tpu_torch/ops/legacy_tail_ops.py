"""The legacy layer tail (reference ``paddle_tpu/ops/legacy_tail_ops.py``):
``bilinear_interp``, ``selective_fc``, ``data_norm``, ``mdlstm``,
``lambda_cost`` and ``cross_entropy_over_beam``.

* ``bilinear_interp`` keeps the reference's corner-aligned ratio
  ``(in - 1) / (out - 1)`` and its order: rows gathered and blended, then
  columns (``F.interpolate(align_corners=True)`` rounds in another
  order).
* ``selective_fc`` gathers the selected weight columns and never forms
  the dense [B, V] product; its gradient scatters onto those columns.
* ``mdlstm`` runs the 2-D recurrence as a wavefront: the cells of one
  anti-diagonal depend only on the one before, so H + W - 1 steps each
  advance a whole diagonal (the reference scans rows, then cells).
* ``lambda_cost`` is a ``torch.autograd.Function`` whose backward is the
  hand-derived LambdaRank gradient (the reference's ``custom_vjp``):
  NDCG is piecewise constant, so autograd of the forward would be zero.
* ``cross_entropy_over_beam`` is gathers and a softmax; autograd gives
  the reference's backward.
"""

import torch

from ..core.registry import register_op

__all__ = ["LambdaCost", "ndcg", "lambda_grads"]

_BIG = torch.finfo(torch.float32).max


@register_op("bilinear_interp")
def _bilinear_interp(ctx):
    """Corner-aligned bilinear resize of NCHW X to (out_h, out_w)."""
    x = ctx.input("X")
    out_h = ctx.attr("out_h")
    out_w = ctx.attr("out_w")
    h, w = x.shape[2], x.shape[3]
    dev = x.device

    def axis_weights(in_dim, out_dim):
        ratio = (in_dim - 1.0) / (out_dim - 1.0) if out_dim > 1 else 0.0
        pos = torch.arange(out_dim, dtype=torch.float32, device=dev) * \
            torch.full((), ratio, dtype=torch.float32, device=dev)
        lo = torch.floor(pos).to(torch.int64).clamp(max=in_dim - 1)
        hi = (lo + 1).clamp(max=in_dim - 1)
        return lo, hi, (pos - lo.to(torch.float32)).to(x.dtype)

    y0, y1, fy = axis_weights(h, out_h)
    x0, x1, fx = axis_weights(w, out_w)
    fy = fy[None, None, :, None]
    top = x[:, :, y0, :] * (1 - fy) + x[:, :, y1, :] * fy
    return {"Out": top[:, :, :, x0] * (1 - fx) + top[:, :, :, x1] * fx}


@register_op("selective_fc")
def _selective_fc(ctx):
    """out[b, k] = x[b] . W[:, sel[b, k]] + bias[sel[b, k]] for the
    selected columns Sel [B, K] (-1: padding, output 0); without Sel a
    plain fc."""
    x = ctx.input("X")            # [B, D]
    w = ctx.input("W")            # [D, V]
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None
    if not ctx.has_input("Sel"):
        out = x @ w
        return {"Out": out + bias if bias is not None else out}
    sel = ctx.input("Sel").to(torch.int64)
    valid = sel >= 0
    ids = torch.where(valid, sel, 0)
    wsel = w.t()[ids]                                  # [B, K, D]
    out = torch.einsum("bd,bkd->bk", x, wsel)
    if bias is not None:
        out = out + bias[ids]
    return {"Out": torch.where(valid, out, torch.zeros_like(out))}


@register_op("data_norm")
def _data_norm(ctx):
    """Per-feature normalization: z-score (x - mean) / std, min-max
    (x - min) / (max - min), or decimal scaling x / 10^j."""
    x = ctx.input("X")
    mode = ctx.attr("mode", "z-score")
    eps = 1e-8
    if mode == "z-score":
        return {"Out": (x - ctx.input("Mean")) /
                ctx.input("Std").clamp(min=eps)}
    if mode == "min-max":
        mn = ctx.input("Min")
        return {"Out": (x - mn) / (ctx.input("Max") - mn).clamp(min=eps)}
    if mode == "decimal-scaling":
        j = torch.ceil(torch.log10(ctx.input("Max").clamp(min=eps)))
        return {"Out": x / torch.pow(torch.full_like(j, 10.0),
                                     j.clamp(min=0.0))}
    raise ValueError("data_norm mode must be z-score | min-max | "
                     "decimal-scaling, got %r" % mode)


@register_op("mdlstm")
def _mdlstm(ctx):
    """2-D multi-dimensional LSTM over an NHWC grid of gate inputs
    GatesX [B, H, W, 5 nb] (x.Wx + b), shared recurrent WeightH [nb, 5 nb]
    and Peephole [4 nb]. A cell (i, j) with predecessors up (i-1, j) and
    left (i, j-1), zero past the border:

      g    = gates_x + h_left.Wh + h_up.Wh
      ig   = sigm(g_ig + (c_up + c_left) * p_ig)
      fg0  = sigm(g_fg0 + c_up * p_fg0);  fg1 = sigm(g_fg1 + c_left * p_fg1)
      c    = fg0 * c_up + fg1 * c_left + ig * tanh(g_cell)
      h    = tanh(c) * sigm(g_og + c * p_og)

    gate layout [ig, fg0, fg1, og, cell]; ``directions[d]`` False runs
    that axis backwards. Out [B, H, W, nb]."""
    gx = ctx.input("GatesX")
    wh = ctx.input("WeightH")
    peep = ctx.input("Peephole")
    nb = wh.shape[0]
    directions = ctx.attr("directions", (True, True))
    b, h, w, _ = gx.shape
    dev = gx.device
    if not directions[0]:
        gx = gx.flip(1)
    if not directions[1]:
        gx = gx.flip(2)
    p_ig, p_fg0, p_fg1, p_og = (peep[i * nb:(i + 1) * nb] for i in range(4))

    rows = torch.arange(h, device=dev)
    g_rows = gx.permute(1, 2, 0, 3)                     # [H, W, B, 5nb]
    zero = gx.new_zeros((1, b, nb))
    c_prev = h_prev = gx.new_zeros((h, b, nb))          # diagonal d - 1
    diagonals = []
    for d in range(h + w - 1):
        cols = d - rows
        on = ((cols >= 0) & (cols < w))[:, None, None]  # [H, 1, 1]
        g_cell = g_rows[rows, cols.clamp(0, w - 1)]     # [H, B, 5nb]
        # up: row i - 1 of the previous diagonal; left: row i of it
        c_up = torch.cat([zero, c_prev[:-1]])
        h_up = torch.cat([zero, h_prev[:-1]])
        c_left, h_left = c_prev, h_prev
        g = g_cell + h_left @ wh + h_up @ wh
        ig = torch.sigmoid(g[..., :nb] + (c_up + c_left) * p_ig)
        fg0 = torch.sigmoid(g[..., nb:2 * nb] + c_up * p_fg0)
        fg1 = torch.sigmoid(g[..., 2 * nb:3 * nb] + c_left * p_fg1)
        cell = torch.tanh(g[..., 4 * nb:])
        c = fg0 * c_up + fg1 * c_left + ig * cell
        og = torch.sigmoid(g[..., 3 * nb:4 * nb] + c * p_og)
        hh = torch.tanh(c) * og
        c_prev = torch.where(on, c, torch.zeros_like(c))
        h_prev = torch.where(on, hh, torch.zeros_like(hh))
        diagonals.append(h_prev)
    # cell (i, j) is row i of diagonal i + j
    stacked = torch.stack(diagonals)                    # [D, H, B, nb]
    cols = torch.arange(w, device=dev)
    out = stacked[rows[:, None] + cols[None, :], rows[:, None]]
    out = out.permute(2, 0, 1, 3)                       # [B, H, W, nb]
    if not directions[0]:
        out = out.flip(1)
    if not directions[1]:
        out = out.flip(2)
    return {"Out": out}


def _big(like):
    return torch.full((), _BIG, dtype=torch.float32, device=like.device)


def ndcg(rank_scores, true_scores, valid, k):
    """NDCG@k of ``true_scores`` ordered by ``rank_scores`` descending
    (a stable sort; padding, ``valid`` False, sorts last and weighs 0),
    over the ideal DCG@k."""
    length = rank_scores.shape[-1]
    big = _big(rank_scores)
    order = torch.argsort(torch.where(valid, -rank_scores, big), dim=-1,
                          stable=True)
    picked = torch.gather(true_scores, -1, order)
    pvalid = torch.gather(valid, -1, order)
    pos = torch.arange(length, dtype=torch.float32, device=valid.device)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    two = torch.full((), 2.0, dtype=torch.float32, device=valid.device)
    wt = torch.where((pos < k) & pvalid, 1.0 / torch.log(pos + 2.0), zero)
    dcg = ((torch.pow(two, picked) - 1.0) * wt).sum(-1)
    ideal = torch.sort(torch.where(valid, true_scores, -big), dim=-1,
                       descending=True).values
    ivalid = torch.sort(valid.to(torch.float32), dim=-1,
                        descending=True).values > 0
    iwt = torch.where((pos < k) & ivalid, 1.0 / torch.log(pos + 2.0), zero)
    max_dcg = ((torch.pow(two, ideal) - 1.0) * iwt).sum(-1)
    return dcg / max_dcg.clamp(min=1e-12)


def lambda_grads(out_scores, true_scores, valid, k):
    """LambdaRank pseudo-gradients over the full sort: the pairs (i, j)
    of positions in the stable descending order of the true scores,
    lambda_ij = -|dcg_dif| / (1 + exp(out_i - out_j)) / maxDCG@k,
    scattered back to the original positions."""
    length = out_scores.shape[-1]
    big = _big(out_scores)
    order = torch.argsort(torch.where(valid, -true_scores, big), dim=-1,
                          stable=True)
    s = torch.gather(true_scores, -1, order)
    o = torch.gather(out_scores, -1, order)
    v = torch.gather(valid, -1, order)
    pos = torch.arange(length, dtype=torch.float32, device=valid.device)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    two = torch.full((), 2.0, dtype=torch.float32, device=valid.device)
    inv_log = 1.0 / torch.log(pos + 2.0)
    wt = torch.where((pos < k) & v, inv_log, zero)
    max_dcg = ((torch.pow(two, s) - 1.0) * wt).sum(-1, keepdim=True) \
        .clamp(min=1e-12)
    gain = torch.pow(two, s)
    dcg_dif = (gain[..., :, None] - gain[..., None, :]) * \
        (inv_log[:, None] - inv_log[None, :])
    lam = -dcg_dif.abs() / (1.0 + torch.exp(o[..., :, None] -
                                            o[..., None, :]))
    pair = (pos[:, None] < pos[None, :]) & v[..., :, None] & v[..., None, :]
    lam = torch.where(pair, lam, zero) / max_dcg[..., None]
    g_sorted = lam.sum(-1) - lam.sum(-2)
    return torch.gather(g_sorted, -1, torch.argsort(order, dim=-1))


class LambdaCost(torch.autograd.Function):
    """Forward: each valid position carries its list's NDCG@k (0 at
    padding). Backward: the lambda gradients, scaled by the mean
    cotangent over the list's valid positions."""

    @staticmethod
    def forward(ctx, out_scores, true_scores, valid, k):
        ctx.save_for_backward(out_scores, true_scores, valid)
        ctx.k = k
        cost = ndcg(out_scores, true_scores, valid, k)
        return torch.where(valid, cost[..., None],
                           torch.zeros_like(out_scores))

    @staticmethod
    def backward(ctx, ct):
        out_scores, true_scores, valid = ctx.saved_tensors
        grads = lambda_grads(out_scores, true_scores, valid, ctx.k)
        denom = valid.sum(-1, keepdim=True).clamp(min=1)
        g_seq = torch.where(valid, ct, torch.zeros_like(ct)) \
            .sum(-1, keepdim=True) / denom
        return grads * g_seq, None, None, None


@register_op("lambda_cost")
def _lambda_cost(ctx):
    """LambdaRank cost over padded lists: X, the model's scores, and
    Score, the true relevance, [B, L]; Length [B]. Out [B, L]."""
    out_scores = ctx.input("X").to(torch.float32)
    true_scores = ctx.input("Score").to(torch.float32)
    length = ctx.input("Length").reshape(-1)
    k = int(ctx.attr("NDCG_num", 5))
    valid = torch.arange(out_scores.shape[-1],
                         device=out_scores.device)[None, :] < length[:, None]
    return {"Out": LambdaCost.apply(out_scores, true_scores, valid, k)}


@register_op("cross_entropy_over_beam")
def _cross_entropy_over_beam(ctx):
    """Globally normalized cross entropy over beam expansions. Step e:
    Scores_e [B, S_e] candidate scores, Ids_e [B, R_e, W] the W picks of
    each surviving row into Scores_e (-1: pruned; row r at step e + 1
    descends from the r-th valid pick of step e, row-major), Gold_e [B]
    the gold index. The paths are the valid picks of the last step where
    gold stayed on the beam, each scored by its picks along its parent
    chain; if gold fell off, its chain joins as an extra path. Out [B, 1]
    = -log softmax(path scores)[gold]."""
    scores = ctx.inputs("Scores")
    ids = ctx.inputs("Ids")
    gold = [g.to(torch.int64) for g in ctx.inputs("Gold")]
    n_steps = len(scores)
    b = scores[0].shape[0]
    dev = scores[0].device
    neg = -1e9
    int_max = torch.iinfo(torch.int32).max

    flat_ids = [i.reshape(b, -1).to(torch.int64) for i in ids]
    valid = [f >= 0 for f in flat_ids]
    ranks = [torch.cumsum(v.to(torch.int64), dim=-1) - 1 for v in valid]
    width = ids[0].shape[-1]
    cols = torch.arange(width, device=dev)[None, :]

    gold_row = torch.zeros((b,), dtype=torch.int64, device=dev)
    on_beam = torch.ones((b,), dtype=torch.bool, device=dev)
    gold_flat_pos, gold_found, gold_alive = [], [], []
    for e in range(n_steps):
        row_ids = torch.gather(flat_ids[e], -1, gold_row[:, None] * width +
                               cols)
        hit = row_ids == gold[e][:, None]
        found = hit.any(dim=-1) & on_beam
        fpos = gold_row * width + hit.to(torch.int8).argmax(dim=-1)
        gold_flat_pos.append(torch.where(found, fpos, 0))
        gold_found.append(found)
        gold_alive.append(on_beam)
        gold_row = torch.where(
            found, torch.gather(ranks[e], -1, fpos[:, None])[:, 0], 0)
        on_beam = found

    # the last valid expansion: the first step where gold is missing
    fell = torch.stack([(~f) & a for f, a in zip(gold_found, gold_alive)],
                       dim=-1)                                # [B, E]
    any_fell = fell.any(dim=-1)
    lv = torch.where(any_fell, fell.to(torch.int8).argmax(dim=-1),
                     n_steps - 1)

    width_p = max(f.shape[1] for f in flat_ids)

    def pad_to(x, fill):
        return torch.nn.functional.pad(x, (0, width_p - x.shape[1]),
                                       value=fill)

    path_scores, path_valids = [], []
    prev_acc = None
    for e in range(n_steps):
        pick = torch.gather(scores[e], -1, flat_ids[e].clamp(min=0))
        pick = torch.where(valid[e], pick.to(torch.float32),
                           torch.zeros((), device=dev))
        if e == 0:
            acc = pick
        else:
            # row r of step e descends from the pick of rank r at e - 1
            parent_row = torch.arange(flat_ids[e].shape[1],
                                      device=dev) // width
            prev_rank = pad_to(torch.where(valid[e - 1], ranks[e - 1],
                                           int_max), int_max)
            rank_to_pos = torch.argsort(prev_rank, dim=-1, stable=True)
            parent_pos = torch.gather(rank_to_pos, -1,
                                      parent_row[None, :].expand(b, -1))
            acc = pick + torch.gather(prev_acc, -1, parent_pos)
        acc_p = pad_to(torch.where(valid[e], acc, torch.full_like(acc, neg)),
                       neg)
        path_scores.append(acc_p)
        path_valids.append(pad_to(valid[e], False))
        prev_acc = acc_p

    ps = torch.stack(path_scores, dim=1)                       # [B, E, P]
    pv = torch.stack(path_valids, dim=1)
    sel = lv[:, None, None].expand(b, 1, width_p)
    sel_ps = torch.gather(ps, 1, sel)[:, 0]
    sel_pv = torch.gather(pv, 1, sel)[:, 0]
    gold_steps = torch.stack(
        [torch.gather(scores[e], -1, gold[e][:, None])[:, 0]
         .to(torch.float32) for e in range(n_steps)], dim=-1)
    gold_score = torch.gather(torch.cumsum(gold_steps, dim=-1), -1,
                              lv[:, None])[:, 0]
    gold_pos = torch.gather(torch.stack(gold_flat_pos, dim=-1), -1,
                            lv[:, None])[:, 0]
    survived = ~any_fell
    all_scores = torch.cat([sel_ps, torch.where(
        survived, torch.full_like(gold_score, neg), gold_score)[:, None]],
        dim=-1)
    all_valid = torch.cat([sel_pv, (~survived)[:, None]], dim=-1)
    logits = torch.where(all_valid, all_scores,
                         torch.full_like(all_scores, neg))
    logz = torch.logsumexp(logits, dim=-1)
    gold_logit = torch.where(
        survived, torch.gather(sel_ps, -1, gold_pos[:, None])[:, 0],
        gold_score)
    return {"Out": (logz - gold_logit)[:, None]}
