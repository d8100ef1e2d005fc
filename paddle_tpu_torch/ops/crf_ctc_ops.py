"""Structured-prediction ops (reference ``paddle_tpu/ops/crf_ctc_ops.py``):
the linear-chain CRF's cost and Viterbi decoding, the CTC loss and its
greedy alignment, and the edit distance, over padded batches.

The dynamic programs loop over time on the device in log space and are
differentiable by autograd, as the reference's ``lax.scan``s are by
``jax.vjp``. Empty paths score ``NEG = -1e30``, a finite constant, so
that ``logsumexp`` and its gradient stay finite where ``-inf`` would
give NaNs.

The CRF's transition is the reference's [C+2, C]: row 0 the start
weights, row 1 the stop weights, rows 2.. transition[from, to].

The edit distance computes a whole row of the table at once: first
``D'[i, j] = min(D[i-1, j] + 1, D[i-1, j-1] + cost)``, then the left
pass ``D[i, j] = min_k (D'[i, k] + j - k)`` as ``cummin(D' - j) + j``
(exact in float32: every value is a small integer), T1 steps instead of
the reference's T1 * T2.
"""

import torch

from ..core.registry import register_op
from .sequence_ops import _left_pack

NEG = -1e30


def _lengths(ctx, slot, n, t, device):
    if ctx.has_input(slot):
        return ctx.input(slot).reshape(-1).to(torch.int32)
    return torch.full((n,), t, dtype=torch.int32, device=device)


def _neg(shape, like):
    return torch.full(shape, NEG, dtype=torch.float32, device=like.device)


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx):
    """Emission [N, T, C], Label [N, T] int, Length [N], Transition
    [C+2, C] -> LogLikelihood [N, 1], the NEGATIVE log-likelihood (a cost,
    as the reference's)."""
    em = ctx.input("Emission").to(torch.float32)
    n, t, c = em.shape
    label = ctx.input("Label").reshape(n, -1).long()
    w = ctx.input("Transition").to(torch.float32)
    length = _lengths(ctx, "Length", n, t, em.device)
    start, stop, trans = w[0], w[1], w[2:]
    mask = torch.arange(t, device=em.device)[None, :] < length[:, None]

    ems = torch.unbind(em, dim=1)
    alpha = start[None, :] + ems[0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            ems[i]
        alpha = torch.where(mask[:, i, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)

    fmask = mask.to(torch.float32)
    em_score = torch.sum(torch.gather(em, 2, label[:, :, None])[..., 0]
                         * fmask, dim=1)
    trans_score = torch.sum(trans[label[:, :-1], label[:, 1:]]
                            * fmask[:, 1:], dim=1)
    last_idx = torch.clamp(length - 1, min=0).long()
    last_lab = torch.gather(label, 1, last_idx[:, None])[:, 0]
    path = em_score + trans_score + start[label[:, 0]] + stop[last_lab]
    return {"LogLikelihood": (logz - path).reshape(n, 1)}


@register_op("crf_decoding")
def _crf_decoding(ctx):
    """Viterbi decoding: Emission [N, T, C], Transition [C+2, C], Length
    [N] -> ViterbiPath [N, T] int32 (padding zero)."""
    em = ctx.input("Emission").to(torch.float32)
    w = ctx.input("Transition").to(torch.float32)
    n, t, c = em.shape
    length = _lengths(ctx, "Length", n, t, em.device)
    start, stop, trans = w[0], w[1], w[2:]
    mask = torch.arange(t, device=em.device)[None, :] < length[:, None]
    ident = torch.arange(c, dtype=torch.int32,
                         device=em.device)[None].expand(n, c)
    alpha = start[None, :] + em[:, 0]
    bps = []
    for i in range(1, t):
        scores = alpha[:, :, None] + trans[None]
        best = torch.amax(scores, dim=1) + em[:, i]
        bp = torch.argmax(scores, dim=1).to(torch.int32)
        m = mask[:, i, None]
        alpha = torch.where(m, best, alpha)
        # a frozen step backtracks to itself
        bps.append(torch.where(m, bp, ident))
    tok = torch.argmax(alpha + stop[None, :], dim=1).to(torch.int32)
    path = [None] * t
    for i in range(t - 1, 0, -1):
        path[i] = tok
        tok = torch.gather(bps[i - 1], 1, tok[:, None].long())[:, 0]
    path[0] = tok
    path = torch.stack(path, dim=1)
    return {"ViterbiPath": torch.where(mask, path, torch.zeros_like(path))}


@register_op("warpctc")
def _warpctc(ctx):
    """CTC loss: Logits [N, T, C], Label [N, L], LogitsLength [N],
    LabelLength [N]; attr ``blank`` -> Loss [N, 1]. The forward algorithm
    over the blank-interleaved label sequence, in log space."""
    logits = ctx.input("Logits").to(torch.float32)
    label = ctx.input("Label").to(torch.int64)
    lg_len = ctx.input("LogitsLength").reshape(-1).to(torch.int32)
    lb_len = ctx.input("LabelLength").reshape(-1).to(torch.int32)
    blank = ctx.attr("blank", 0)
    n, t, c = logits.shape
    s = 2 * label.shape[1] + 1
    dev = logits.device

    logp = torch.log_softmax(logits, dim=-1)
    ext = torch.full((n, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    ext_valid = torch.arange(s, device=dev)[None, :] < \
        (2 * lb_len + 1)[:, None]
    can_skip = torch.zeros((n, s), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])

    first_lab = torch.gather(logp[:, 0], 1, ext[:, 1:2])[:, 0]
    alpha = torch.cat([
        logp[:, 0, blank:blank + 1],
        torch.where(lb_len > 0, first_lab, _neg((), logp))[:, None],
        _neg((n, s - 2), logp)], dim=1)
    live = torch.arange(t, device=dev)[None, :] < lg_len[:, None]
    neg1, neg2 = _neg((n, 1), logp), _neg((n, 2), logp)
    lps = torch.unbind(logp, dim=1)
    for i in range(1, t):
        shift1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat([neg2, alpha[:, :-2]],
                                                 dim=1), _neg((), logp))
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        emit = torch.gather(lps[i], 1, ext)
        nxt = torch.where(ext_valid, merged + emit, _neg((), logp))
        alpha = torch.where(live[:, i, None], nxt, alpha)
    end1 = torch.gather(alpha, 1, (2 * lb_len)[:, None].long())[:, 0]
    end2 = torch.gather(alpha, 1, torch.clamp(2 * lb_len - 1, min=0)
                        [:, None].long())[:, 0]
    end2 = torch.where(lb_len > 0, end2, _neg((), logp))
    loss = -torch.logaddexp(end1, end2)
    if ctx.attr("norm_by_times", False):
        loss = loss / torch.clamp(lg_len.to(torch.float32), min=1.0)
    return {"Loss": loss.reshape(n, 1)}


@register_op("ctc_align")
def _ctc_align(ctx):
    """Greedy CTC post-processing: repeats merged, blanks dropped, the
    rest left-packed. Input [N, T] ids and Length [N]."""
    x = ctx.input("Input").to(torch.int32)
    length = ctx.input("Length").reshape(-1).to(torch.int32)
    blank = ctx.attr("blank", 0)
    n, t = x.shape
    prev = torch.cat([torch.full((n, 1), -1, dtype=torch.int32,
                                 device=x.device), x[:, :-1]], dim=1)
    valid = torch.arange(t, device=x.device)[None, :] < length[:, None]
    out, new_len = _left_pack(x, (x != blank) & (x != prev) & valid)
    return {"Output": out, "OutputLength": new_len}


@register_op("edit_distance")
def _edit_distance(ctx):
    """Levenshtein distance between padded int sequences: Hyps [N, T1] and
    HypsLength, Refs [N, T2] and RefsLength; ``normalized`` divides by the
    reference's length. Out [N, 1] float32, SequenceNum (N, int32)."""
    hyp = ctx.input("Hyps").to(torch.int32)
    ref = ctx.input("Refs").to(torch.int32)
    hlen = ctx.input("HypsLength").reshape(-1).long()
    rlen = ctx.input("RefsLength").reshape(-1).long()
    n, t1 = hyp.shape
    t2 = ref.shape[1]
    dev = hyp.device
    cols = torch.arange(t2 + 1, dtype=torch.float32, device=dev)[None]
    row = cols.expand(n, t2 + 1)
    rows = [row]
    for i in range(1, t1 + 1):
        cost = (hyp[:, i - 1:i] != ref).to(torch.float32)
        inner = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)
        first = torch.full((n, 1), float(i), dtype=torch.float32,
                           device=dev)
        d = torch.cat([first, inner], dim=1) - cols
        row = torch.cummin(d, dim=1).values + cols
        rows.append(row)
    table = torch.stack(rows)                       # [T1 + 1, N, T2 + 1]
    d = table[hlen, torch.arange(n, device=dev)]   # [N, T2 + 1]
    dist = torch.gather(d, 1, rlen[:, None])[:, 0]
    if ctx.attr("normalized", True):
        dist = dist / torch.clamp(rlen.to(torch.float32), min=1.0)
    return {"Out": dist.reshape(n, 1),
            "SequenceNum": torch.full((), n, dtype=torch.int32, device=dev)}
