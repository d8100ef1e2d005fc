"""Detection layers of the program front end (reference
``paddle_tpu/layers/detection.py``): the SSD family's ``roi_pool``,
``prior_box``, ``box_coder``, ``multibox_loss`` and ``detection_output``
over ``ops/detection_ops.py`` and ``ops/misc_ops.py``. The mAP is the
host-side ``evaluator.DetectionMAP``."""

from ..layer_helper import LayerHelper

__all__ = ["roi_pool", "prior_box", "box_coder", "multibox_loss",
           "detection_output"]


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, **kwargs):
    helper = LayerHelper("roi_pool", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    argmax = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="roi_pool",
                     inputs={"X": [input.name], "ROIs": [rois.name]},
                     outputs={"Out": [out.name], "Argmax": [argmax.name]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variances=(0.1, 0.1, 0.2, 0.2), flip=True, clip=True,
              step_w=0.0, step_h=0.0, offset=0.5, **kwargs):
    """SSD anchors for a feature map (PriorBox.cpp:95-150). Returns
    (boxes [H,W,P,4], variances [H,W,P,4]) in normalized corners."""
    helper = LayerHelper("prior_box", **kwargs)
    boxes = helper.create_tmp_variable("float32", stop_gradient=True)
    var = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(type="prior_box",
                     inputs={"Input": [input.name],
                             "Image": [image.name]},
                     outputs={"Boxes": [boxes.name],
                              "Variances": [var.name]},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios or []),
                            "variances": list(variances), "flip": flip,
                            "clip": clip, "step_w": step_w,
                            "step_h": step_h, "offset": offset})
    return boxes, var


def box_coder(prior_box_var, prior_box, target_box,
              code_type="decode_center_size", **kwargs):
    helper = LayerHelper("box_coder", **kwargs)
    out = helper.create_tmp_variable(target_box.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": [prior_box.name],
                             "PriorBoxVar": [prior_box_var.name],
                             "TargetBox": [target_box.name]},
                     outputs={"OutputBox": [out.name]},
                     attrs={"code_type": code_type})
    return out


def multibox_loss(loc, conf, prior_boxes, prior_variances, gt_box,
                  gt_label, gt_count, overlap_threshold=0.5,
                  neg_pos_ratio=3.0, background_label=0, **kwargs):
    """SSD training loss (MultiBoxLossLayer.cpp). loc [N,P,4], conf
    logits [N,P,C], padded GT (boxes [N,G,4], labels [N,G],
    count [N]). Returns (loss, loc_loss, conf_loss) scalars."""
    helper = LayerHelper("multibox_loss", **kwargs)
    loss = helper.create_tmp_variable("float32")
    ll = helper.create_tmp_variable("float32")
    cl = helper.create_tmp_variable("float32")
    helper.append_op(
        type="multibox_loss",
        inputs={"Loc": [loc.name], "Conf": [conf.name],
                "PriorBox": [prior_boxes.name],
                "PriorBoxVar": [prior_variances.name],
                "GtBox": [gt_box.name], "GtLabel": [gt_label.name],
                "GtCount": [gt_count.name]},
        outputs={"Loss": [loss.name], "LocLoss": [ll.name],
                 "ConfLoss": [cl.name]},
        attrs={"overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio,
               "background_label": background_label})
    return loss, ll, cl


def detection_output(loc, scores, prior_boxes, prior_variances,
                     background_label=0, confidence_threshold=0.01,
                     nms_threshold=0.45, nms_top_k=64, keep_top_k=16,
                     **kwargs):
    """Decode + per-class NMS + top-k (detection_output_op.h). scores
    are post-softmax probabilities [N,P,C]. Output [N, keep_top_k, 6]:
    (label, score, xmin, ymin, xmax, ymax), label -1 = empty row."""
    helper = LayerHelper("detection_output", **kwargs)
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        type="detection_output",
        inputs={"Loc": [loc.name], "Scores": [scores.name],
                "PriorBox": [prior_boxes.name],
                "PriorBoxVar": [prior_variances.name]},
        outputs={"Out": [out.name]},
        attrs={"background_label": background_label,
               "confidence_threshold": confidence_threshold,
               "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k})
    return out
