"""The SSD detection family (reference ``paddle_tpu/ops/detection_ops.py``):
``prior_box`` (anchors), ``box_coder`` (center-size encode and decode),
``multibox_loss`` (IoU matching, smooth-L1 localization, softmax
confidence with 3:1 hard-negative mining) and ``detection_output``
(decode, per-class NMS, cross-class top-k).

Everything is static in shape, as in the reference: ground truth comes
padded (boxes [N, G, 4], labels [N, G], count [N]), NMS runs a fixed
``k`` steps over a fixed candidate set, and the detections are
[N, keep_top_k, 6] rows with label -1 for an empty row. Nothing is read
back to the host, so a step holding these ops captures.

Where torch parts from JAX, the reference's rule is kept:

* the force-match of each ground-truth box to its best prior: when two
  valid boxes share a best prior, the reference's scatter lets the later
  one win; here each prior takes the highest box index aimed at it
  (``scatter_reduce`` ``amax``, deterministic on the card, where
  ``index_put_`` with duplicate indices is not);
* ties among the hard negatives and among the NMS candidates are broken
  by stable sorts (``jnp.argsort`` is stable, ``torch.argsort`` only when
  asked), and the top-k selections keep the lowest index first among
  equal scores, as ``lax.top_k``;
* the images (loss) and the images x foreground classes (NMS) are
  batched, where the reference maps one image at a time.

The priors' widths and heights are computed in Python doubles and cast
to float32, their centers as ``(arange + offset) * step`` in float32, and
the corners scaled by the image size's float32 reciprocal: the compiled
reference's arithmetic, bitwise.
"""

import math

import torch

from ..core.registry import register_op
from .beam_search_ops import top_k_stable

__all__ = ["iou_matrix", "decode", "encode", "match", "nms_mask"]


def iou_matrix(a, b):
    """IoU between corner boxes a [..., P, 4] and b [..., G, 4] ->
    [..., P, G]."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _center_size(boxes):
    """corner [..., 4] -> (cx, cy, w, h)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + w * 0.5, boxes[..., 1] + h * 0.5, w, h


def decode(loc, priors, variances):
    """SSD center-size decode of offsets ``loc`` [..., 4] against corner
    ``priors``."""
    pcx, pcy, pw, ph = _center_size(priors)
    cx = variances[..., 0] * loc[..., 0] * pw + pcx
    cy = variances[..., 1] * loc[..., 1] * ph + pcy
    w = torch.exp(variances[..., 2] * loc[..., 2]) * pw
    h = torch.exp(variances[..., 3] * loc[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def encode(gt, priors, variances):
    """Inverse of :func:`decode`: the regression targets of ``gt``."""
    pcx, pcy, pw, ph = _center_size(priors)
    gcx, gcy, gw, gh = _center_size(gt)
    eps = 1e-8
    tx = (gcx - pcx) / pw.clamp(min=eps) / variances[..., 0]
    ty = (gcy - pcy) / ph.clamp(min=eps) / variances[..., 1]
    tw = torch.log(gw.clamp(min=eps) / pw.clamp(min=eps)) / \
        variances[..., 2]
    th = torch.log(gh.clamp(min=eps) / ph.clamp(min=eps)) / \
        variances[..., 3]
    return torch.stack([tx, ty, tw, th], dim=-1)


@register_op("prior_box")
def _prior_box(ctx):
    """SSD anchors for one feature map in the reference's per-cell order:
    for each min_size the (min, min) box, then one sqrt(min * max) box
    per max_size; then the non-unit aspect-ratio boxes once, sized by the
    last min_size; ``flip`` adds each ratio's reciprocal. Boxes and
    Variances [H, W, num_priors, 4]."""
    feat = ctx.input("Input")          # [N, C, H, W]
    img = ctx.input("Image")           # [N, 3, IH, IW]
    min_sizes = [float(v) for v in ctx.attr("min_sizes")]
    max_sizes = [float(v) for v in ctx.attr("max_sizes") or []]
    ars_attr = [float(v) for v in ctx.attr("aspect_ratios") or []]
    variances = [float(v) for v in ctx.attr("variances",
                                            [0.1, 0.1, 0.2, 0.2])]
    flip = ctx.attr("flip", True)
    clip = ctx.attr("clip", True)
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    step_w = ctx.attr("step_w", 0.0) or iw / w
    step_h = ctx.attr("step_h", 0.0) or ih / h
    offset = ctx.attr("offset", 0.5)
    dev = feat.device

    ars = []
    for ar in ars_attr:
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)
    whs = []
    for ms in min_sizes:
        whs.append((ms, ms))
        for mx in max_sizes:
            s = math.sqrt(ms * mx)
            whs.append((s, s))
    for ar in ars:
        if abs(ar - 1.0) < 1e-6:
            continue
        whs.append((min_sizes[-1] * math.sqrt(ar),
                    min_sizes[-1] / math.sqrt(ar)))
    num_priors = len(whs)

    def f32(v):
        """A float32 constant made by fills on the device (a tensor
        copied from the host would hold a captured step back)."""
        if isinstance(v, list):
            return torch.cat([f32(x).reshape(1) for x in v])
        return torch.full((), v, dtype=torch.float32, device=dev)
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + f32(offset)) \
        * f32(step_w)
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + f32(offset)) \
        * f32(step_h)
    cx = cx[None, :, None].expand(h, w, num_priors)
    cy = cy[:, None, None].expand(h, w, num_priors)
    bw = f32([p[0] for p in whs]) / 2.0
    bh = f32([p[1] for p in whs]) / 2.0
    # the compiled reference divides by the image's size as a product
    # with its float32 reciprocal
    rw, rh = 1.0 / f32(float(iw)), 1.0 / f32(float(ih))
    boxes = torch.stack([(cx - bw) * rw, (cy - bh) * rh,
                         (cx + bw) * rw, (cy + bh) * rh], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = f32(variances).expand(boxes.shape)
    return {"Boxes": boxes, "Variances": var}


@register_op("box_coder")
def _box_coder(ctx):
    """Center-size box coding, ``code_type`` 'decode_center_size' or
    'encode_center_size'."""
    priors = ctx.input("PriorBox").reshape(-1, 4)
    pvar = ctx.input("PriorBoxVar").reshape(-1, 4)
    t = ctx.input("TargetBox")
    if ctx.attr("code_type", "decode_center_size") == "decode_center_size":
        return {"OutputBox": decode(t, priors, pvar)}
    return {"OutputBox": encode(t, priors, pvar)}


def match(iou, valid_g, overlap_threshold):
    """SSD matching of iou [N, P, G] with valid boxes [N, G]: each valid
    box's best prior is force-matched to it (the highest box index where
    several share a prior, as the reference's scatter leaves it); every
    other prior takes its best box if that IoU passes the threshold.
    Returns [N, P] int64 box indices, -1 unmatched."""
    n, p, _ = iou.shape
    iou = torch.where(valid_g[:, None, :], iou, torch.full_like(iou, -1.0))
    best_gt_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)      # the first maximal index, as jnp's
    matched = torch.where(best_gt_iou > overlap_threshold, best_gt,
                          torch.full_like(best_gt, -1))
    best_prior = iou.argmax(dim=1)                         # [N, G]
    gt_ids = torch.arange(iou.shape[2], device=iou.device).expand(n, -1)
    # padding boxes aim at the spare column p, dropped below
    tgt = torch.where(valid_g, best_prior, torch.full_like(best_prior, p))
    forced = torch.full((n, p + 1), -1, dtype=torch.int64,
                        device=iou.device).scatter_reduce(
        1, tgt, gt_ids, "amax", include_self=True)[:, :p]
    return torch.where(forced >= 0, forced, matched)


@register_op("multibox_loss")
def _multibox_loss(ctx):
    """SSD loss: smooth-L1 of the matched priors' offsets plus softmax
    cross entropy of the matched priors and of the hardest negatives (by
    loss, at most ``neg_pos_ratio`` per positive), each over the image's
    positives; Loss, LocLoss and ConfLoss are means over the images."""
    loc = ctx.input("Loc")        # [N, P, 4]
    conf = ctx.input("Conf")      # [N, P, C] logits
    priors = ctx.input("PriorBox").reshape(-1, 4)
    pvar = ctx.input("PriorBoxVar").reshape(-1, 4)
    gt_box = ctx.input("GtBox")   # [N, G, 4]
    n, g = gt_box.shape[0], gt_box.shape[1]
    gt_label = ctx.input("GtLabel").reshape(n, -1)
    gt_count = ctx.input("GtCount").reshape(-1)
    overlap_t = ctx.attr("overlap_threshold", 0.5)
    neg_ratio = ctx.attr("neg_pos_ratio", 3.0)
    background = ctx.attr("background_label", 0)
    dev = loc.device

    valid_g = torch.arange(g, device=dev)[None, :] < gt_count[:, None]
    iou = iou_matrix(priors.expand(n, -1, -1), gt_box)    # [N, P, G]
    m = match(iou, valid_g, overlap_t)
    pos = m >= 0
    n_pos = pos.sum(dim=1, dtype=torch.int32)
    safe_m = m.clamp(min=0)
    # localization: smooth L1 against the matched box's encoding
    matched_box = torch.gather(gt_box, 1,
                               safe_m[:, :, None].expand(-1, -1, 4))
    diff = loc - encode(matched_box, priors, pvar)
    a = diff.abs()
    sl1 = torch.where(a < 1.0, 0.5 * a * a, a - 0.5).sum(-1)
    loc_loss = (sl1 * pos).sum(dim=1)
    # confidence: cross entropy against the matched label or background
    cls = torch.where(pos, torch.gather(gt_label, 1, safe_m).to(torch.int64),
                      torch.full_like(safe_m, background))
    logp = torch.log_softmax(conf, dim=-1)
    ce = -torch.gather(logp, 2, cls[:, :, None])[:, :, 0]
    # hard negatives: the n_neg largest losses among the negatives, ties
    # to the lower prior index (a stable sort, as jnp.argsort)
    n_neg = torch.minimum((neg_ratio * n_pos.to(torch.float32))
                          .to(torch.int32),
                          (~pos).sum(dim=1, dtype=torch.int32))
    neg_ce = torch.where(pos, torch.full_like(ce, -math.inf), ce)
    order = torch.argsort(-neg_ce.detach(), dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=dev).expand_as(order))
    neg_sel = (~pos) & (rank < n_neg[:, None])
    conf_loss = (ce * (pos | neg_sel)).sum(dim=1)
    denom = n_pos.clamp(min=1).to(loc.dtype)
    loc_l, conf_l = loc_loss / denom, conf_loss / denom
    return {"Loss": (loc_l + conf_l).mean().reshape(1),
            "LocLoss": loc_l.mean().reshape(1),
            "ConfLoss": conf_l.mean().reshape(1)}


def nms_mask(boxes, valid, nms_threshold):
    """Greedy NMS of each row's candidates: boxes [R, K, 4] and valid
    [R, K], in the order of their scores, descending (``top_k_stable``'s:
    the stable argsort of the reference, which re-sorts them, keeps that
    order). K steps over the rows at once: a valid candidate not yet
    suppressed is kept and suppresses the candidates overlapping it by
    more than the threshold. Returns the keep mask [R, K]."""
    iou = iou_matrix(boxes, boxes)                       # [R, K, K]
    banned = torch.zeros_like(valid)
    keep = []
    for i in range(valid.shape[1]):
        ok = valid[:, i] & ~banned[:, i]
        keep.append(ok)
        banned = banned | (ok[:, None] & (iou[:, i] > nms_threshold))
    return torch.stack(keep, dim=1)


@register_op("detection_output")
def _detection_output(ctx):
    """Decode, per-class NMS over each class's ``nms_top_k`` best priors,
    then the ``keep_top_k`` best kept candidates across the classes:
    [N, keep_top_k, 6] rows (label, score, xmin, ymin, xmax, ymax), label
    -1 where the score does not pass ``confidence_threshold``."""
    loc = ctx.input("Loc")        # [N, P, 4]
    scores = ctx.input("Scores")  # [N, P, C] probabilities
    priors = ctx.input("PriorBox").reshape(-1, 4)
    pvar = ctx.input("PriorBoxVar").reshape(-1, 4)
    background = ctx.attr("background_label", 0)
    score_t = ctx.attr("confidence_threshold", 0.01)
    nms_t = ctx.attr("nms_threshold", 0.45)
    nms_top_k = int(ctx.attr("nms_top_k", 64))
    keep_top_k = int(ctx.attr("keep_top_k", 16))
    n, p, n_cls = scores.shape
    dev = scores.device
    nc = n_cls - (0 <= background < n_cls)
    k = min(nms_top_k, p)

    boxes = decode(loc, priors, pvar)                       # [N, P, 4]
    cls_idx = torch.cat([torch.arange(background, device=dev),
                         torch.arange(background + 1, n_cls, device=dev)]) \
        if 0 <= background < n_cls else torch.arange(n_cls, device=dev)
    s = scores.index_select(2, cls_idx).transpose(1, 2)     # [N, C', P]
    top_s, top_idx = top_k_stable(s.reshape(n * nc, p), k)
    top_s, top_idx = top_s.reshape(n, nc, k), top_idx.reshape(n, nc, k)
    cand = torch.gather(boxes[:, None].expand(n, nc, p, 4), 2,
                        top_idx[..., None].expand(n, nc, k, 4))
    valid = top_s > score_t
    keep = nms_mask(cand.reshape(n * nc, k, 4), valid.reshape(n * nc, k),
                    nms_t).reshape(n, nc, k)
    sel_s = torch.where(keep, top_s, torch.full_like(top_s, -1.0))
    labels = cls_idx.to(torch.float32)[None, :, None].expand(n, nc, k) \
        .reshape(n, nc * k)
    sc = sel_s.reshape(n, nc * k)
    bx = cand.reshape(n, nc * k, 4)
    kk = min(keep_top_k, nc * k)
    fs, fi = top_k_stable(sc, kk)
    rows = torch.cat([
        torch.where(fs > score_t, torch.gather(labels, 1, fi),
                    torch.full_like(fs, -1.0))[..., None],
        fs[..., None], torch.gather(bx, 1, fi[..., None].expand(n, kk, 4))],
        dim=-1)
    if kk < keep_top_k:
        rows = torch.cat([rows, torch.full((n, keep_top_k - kk, 6), -1.0,
                                           dtype=rows.dtype, device=dev)],
                         dim=1)
    return {"Out": rows}
