"""Metric ops (reference ``paddle_tpu/ops/metric_ops.py``):
``accuracy`` after ``top_k``, as ``layers.accuracy`` chains them,
``auc``, ``precision_recall`` and ``positive_negative_pair``. Their
per-batch statistics (``StatCounts``, ``AccumStatesInfo``, the pair
counts) are outputs; a program accumulates them across batches in
persistable variables with a ``sum`` op, as the reference's evaluators
do. Counts are exact; the ratios and the AUC's trapezoid sum in torch's
order, within a few ulp of the reference's. ``chunk_eval_counts``
counts IOB chunks of padded tag sequences."""

import functools

import numpy as np
import torch

from ..core.registry import register_op

__all__ = ["accuracy"]


def accuracy(input, label, k=1):
    """Top-k accuracy of predictions [N, D] against int labels with N
    entries: ``(accuracy f32, correct int32, total int32)``; a row hits
    when its label is among its k largest entries."""
    with torch.no_grad():
        idx = torch.topk(input, k, dim=-1).indices
        hit = (idx == label.reshape(-1, 1).to(idx.dtype)).any(dim=1)
        correct = hit.sum().to(torch.int32)
        total = torch.full((), idx.shape[0], dtype=torch.int32,
                           device=input.device)
        return correct.float() / total.float(), correct, total


@register_op("accuracy")
def _accuracy(ctx):
    """Top-k indices [N, k] (from ``top_k``) against the labels: the hit
    ratio, and the hits and rows as int32."""
    idx = ctx.input("Indices")
    label = ctx.input("Label").reshape(-1, 1)
    hit = (idx == label.to(idx.dtype)).any(dim=1)
    # a fill on the card, not a copy from the host: a captured step
    # replays it
    total = torch.full((), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    correct = hit.sum().to(torch.int32)
    return {"Accuracy": correct.float() / total.float(),
            "Correct": correct, "Total": total}


@functools.lru_cache(maxsize=16)
def _thresholds(num, device):
    """``jnp.linspace(0, 1, num)`` in float32: ``i / (num - 1)`` rounded
    once, then 1."""
    i = np.arange(num - 1, dtype=np.float32)
    t = np.concatenate([i / np.float32(num - 1), np.ones(1, np.float32)])
    return torch.from_numpy(t).to(device)


def _ratio(num, den):
    """``num / max(den, 1e-12)``."""
    return num / torch.maximum(den, torch.full((), 1e-12, dtype=den.dtype,
                                               device=den.device))


@register_op("auc")
def _auc(ctx):
    """ROC AUC over ``num_thresholds`` thresholds on [0, 1]: a score
    above a threshold predicts positive; the trapezoid over the
    thresholds' (fpr, tpr), and the per-threshold [tp, fp, fn, tn]
    (``StatCounts``) an evaluator accumulates."""
    preds = ctx.input("Out")
    label = ctx.input("Label").reshape(-1)
    score = preds[:, -1] if preds.dim() == 2 else preds
    num = ctx.attr("num_thresholds", 200)
    if score.device.type == "meta":
        thresholds = torch.empty((num,), device="meta")
    else:
        thresholds = _thresholds(num, str(score.device))
    pred_pos = score[None, :] > thresholds[:, None]
    is_pos = (label > 0)[None, :]
    tp = (pred_pos & is_pos).sum(dim=1).to(torch.float32)
    fp = (pred_pos & ~is_pos).sum(dim=1).to(torch.float32)
    fn = (~pred_pos & is_pos).sum(dim=1).to(torch.float32)
    tn = (~pred_pos & ~is_pos).sum(dim=1).to(torch.float32)
    tpr, fpr = _ratio(tp, tp + fn), _ratio(fp, fp + tn)
    auc = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) /
                    torch.full((), 2.0, device=tpr.device))
    return {"AUC": torch.abs(auc),
            "StatCounts": torch.stack([tp, fp, fn, tn], dim=1)}


@register_op("precision_recall")
def _precision_recall(ctx):
    """Per-class precision, recall and F1 of the predicted ``Indices``
    against ``Labels``: [macro p, r, f1, micro p, r, f1] for the batch
    (``BatchMetrics``, and ``AccumMetrics`` alike), and the per-class
    [tp, fp, fn] (``AccumStatesInfo``)."""
    idx = ctx.input("Indices").reshape(-1)
    label = ctx.input("Labels").reshape(-1)
    cls = torch.arange(ctx.attr("class_number"), device=idx.device)
    pred = idx[:, None] == cls[None, :]
    true = label[:, None] == cls[None, :]
    tp = (pred & true).sum(dim=0).to(torch.float32)
    fp = (pred & ~true).sum(dim=0).to(torch.float32)
    fn = (~pred & true).sum(dim=0).to(torch.float32)
    precision, recall = _ratio(tp, tp + fp), _ratio(tp, tp + fn)
    f1 = _ratio(2 * precision * recall, precision + recall)
    macro = torch.stack([precision.mean(), recall.mean(), f1.mean()])
    micro_p = _ratio(tp.sum(), (tp + fp).sum())
    micro_r = _ratio(tp.sum(), (tp + fn).sum())
    micro_f = _ratio(2 * micro_p * micro_r, micro_p + micro_r)
    metrics = torch.cat([macro, torch.stack([micro_p, micro_r, micro_f])])
    return {"BatchMetrics": metrics, "AccumMetrics": metrics.clone(),
            "AccumStatesInfo": torch.stack([tp, fp, fn], dim=1)}


@register_op("positive_negative_pair")
def _positive_negative_pair(ctx):
    """Within each query, the pairs whose label order the scores keep
    (positive), reverse (negative) or tie (neutral, half to each)."""
    score = ctx.input("Score").reshape(-1)
    label = ctx.input("Label").reshape(-1)
    qid = ctx.input("QueryID").reshape(-1)
    better = (label[:, None] > label[None, :]) & \
        (qid[:, None] == qid[None, :])
    pos = (better & (score[:, None] > score[None, :])).sum()
    neg = (better & (score[:, None] < score[None, :])).sum()
    neu = (better & (score[:, None] == score[None, :])).sum() \
        .to(torch.float32)
    return {"PositivePair": pos.to(torch.float32) + 0.5 * neu,
            "NegativePair": neg.to(torch.float32) + 0.5 * neu,
            "NeutralPair": neu}


@register_op("chunk_eval_counts")
def _chunk_eval_counts(ctx):
    """IOB chunk counts (reference ``chunk_eval_counts``): tag 2t begins a
    chunk of type t, 2t+1 continues it, 2 * num_chunk_types is outside;
    a chunk is a B followed by the I's of its type. Returns the counts of
    correct, inferred and labeled chunks (float32) over padded [N, T]
    tags and their lengths."""
    inf = ctx.input("Inference")
    inf = inf.reshape(inf.shape[0], -1).to(torch.int32)
    lab = ctx.input("Label").reshape(inf.shape[0], -1).to(torch.int32)
    length = ctx.input("Length").reshape(-1)
    o_tag = 2 * ctx.attr("num_chunk_types")
    n, t = inf.shape
    pos = torch.arange(t, device=inf.device)
    valid = pos[None, :] < length[:, None]

    def analyze(tags):
        tags = torch.where(valid, tags, torch.full_like(tags, o_tag))
        is_b = (tags % 2 == 0) & (tags < o_tag)
        typ = tags // 2
        # the length of the run of I's of one tag starting at each step,
        # from the end backwards
        runs = [None] * t
        run = torch.zeros(n, dtype=torch.int32, device=tags.device)
        nxt = torch.full((n,), -1, dtype=torch.int32, device=tags.device)
        for i in range(t - 1, -1, -1):
            tag = tags[:, i]
            run = torch.where((tag % 2 == 1) & (tag < o_tag),
                              1 + torch.where(nxt == tag, run,
                                              torch.zeros_like(run)),
                              torch.zeros_like(run))
            nxt = tag
            runs[i] = run
        runs = torch.stack(runs, dim=1)
        nxt_run = torch.cat([runs[:, 1:], torch.zeros_like(runs[:, :1])],
                            dim=1)
        nxt_tag = torch.cat([tags[:, 1:], torch.full_like(tags[:, :1], -1)],
                            dim=1)
        ext = torch.where(nxt_tag == 2 * typ + 1, nxt_run,
                          torch.zeros_like(nxt_run))
        return is_b, typ, pos[None, :] + ext

    ib_i, ty_i, end_i = analyze(inf)
    ib_l, ty_l, end_l = analyze(lab)
    match = ib_i & ib_l & (ty_i == ty_l) & (end_i == end_l)
    return {"Correct": torch.sum(match).to(torch.float32),
            "Infer": torch.sum(ib_i).to(torch.float32),
            "Label": torch.sum(ib_l).to(torch.float32)}
