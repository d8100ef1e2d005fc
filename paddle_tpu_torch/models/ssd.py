"""SSD single-shot detector (reference ``paddle_tpu/models/ssd.py``): a
compact multi-scale SSD, a three-stage conv backbone whose maps at
strides 4 and 8 each carry (loc, conf) conv heads and priors; the
multibox loss in training, decode and NMS in inference. Built as a
program (``ops/detection_ops.py``)."""

from .. import layers

__all__ = ["ssd_net"]


def _head(feat, num_priors, num_classes, name):
    """Per-feature-map loc/conf conv heads -> flattened per-prior rows."""
    loc = layers.conv2d(feat, num_filters=num_priors * 4, filter_size=3,
                        padding=1, act=None, name=name + "_loc")
    conf = layers.conv2d(feat, num_filters=num_priors * num_classes,
                         filter_size=3, padding=1, act=None,
                         name=name + "_conf")
    # [N, P*4, H, W] -> [N, H*W*P, 4]
    loc = layers.transpose(loc, perm=[0, 2, 3, 1])
    loc = layers.reshape(loc, [-1,
                               loc.shape[1] * loc.shape[2] * num_priors,
                               4])
    conf = layers.transpose(conf, perm=[0, 2, 3, 1])
    conf = layers.reshape(
        conf, [-1, conf.shape[1] * conf.shape[2] * num_priors,
               num_classes])
    return loc, conf


def ssd_net(img, num_classes=21, gt_box=None, gt_label=None,
            gt_count=None, mode="train", min_sizes=((30.0,), (60.0,)),
            aspect_ratios=(2.0,), nms_threshold=0.45, keep_top_k=16):
    """img: [N, 3, H, W]. train mode needs padded GT (boxes [N,G,4]
    normalized corners, labels [N,G], count [N]) and returns
    (loss, loc_loss, conf_loss); 'infer' returns [N, keep_top_k, 6]
    detections (label, score, box)."""
    # backbone: 3 conv stages; maps at stride 4 and 8
    c1 = layers.conv2d(img, num_filters=16, filter_size=3, padding=1,
                       act="relu")
    p1 = layers.pool2d(c1, pool_size=2, pool_type="max", pool_stride=2)
    c2 = layers.conv2d(p1, num_filters=32, filter_size=3, padding=1,
                       act="relu")
    p2 = layers.pool2d(c2, pool_size=2, pool_type="max", pool_stride=2)
    c3 = layers.conv2d(p2, num_filters=64, filter_size=3, padding=1,
                       act="relu")
    p3 = layers.pool2d(c3, pool_size=2, pool_type="max", pool_stride=2)
    feats = [p2, p3]

    locs, confs, boxes, vars_ = [], [], [], []
    for i, feat in enumerate(feats):
        pb, pv = layers.prior_box(feat, img,
                                  min_sizes=list(min_sizes[i]),
                                  aspect_ratios=list(aspect_ratios))
        # priors per cell = len(min_sizes)*(1 + len(max_sizes)) plus the
        # flip-expanded non-unit aspect-ratio boxes emitted once (see
        # prior_box); read it off the op output rather than recomputing
        num_priors = pb.shape[2]
        loc, conf = _head(feat, num_priors, num_classes, "head%d" % i)
        locs.append(loc)
        confs.append(conf)
        boxes.append(layers.reshape(pb, [-1, 4]))
        vars_.append(layers.reshape(pv, [-1, 4]))

    loc = layers.concat(locs, axis=1)       # [N, P_total, 4]
    conf = layers.concat(confs, axis=1)     # [N, P_total, C]
    priors = layers.concat(boxes, axis=0)   # [P_total, 4]
    pvar = layers.concat(vars_, axis=0)

    if mode == "train":
        return layers.multibox_loss(loc, conf, priors, pvar, gt_box,
                                    gt_label, gt_count)
    scores = layers.softmax(conf)
    return layers.detection_output(loc, scores, priors, pvar,
                                   nms_threshold=nms_threshold,
                                   keep_top_k=keep_top_k)
