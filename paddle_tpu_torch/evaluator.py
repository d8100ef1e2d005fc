"""Evaluators that accumulate over batches (reference
``paddle_tpu/evaluator.py``): ``Accuracy``, ``ChunkEvaluator``, ``Auc``,
``PrecisionRecall``, ``PnPair``, ``EditDistanceEvaluator``,
``SumEvaluator`` and ``ColumnSumEvaluator`` keep their state in
persistable scope variables, updated by ``sum`` ops inside the step, so
the state stays on the device until ``eval()`` reads it; ``DetectionMAP``
is host numpy over the detections, as the reference's; the seven
printers attach ``layers.Print`` (a ``print`` op: a read back to the
host at every run)."""

import numpy as np

import torch

from . import layers
from .core import unique_name
from .core.scope import global_scope
from .layer_helper import LayerHelper
from .initializer import ConstantInitializer

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "DetectionMAP",
           "Auc", "PrecisionRecall", "PnPair", "EditDistanceEvaluator",
           "SumEvaluator", "ColumnSumEvaluator", "ValuePrinter",
           "GradientPrinter", "MaxIdPrinter", "MaxFramePrinter",
           "SeqTextPrinter", "ClassificationErrorPrinter"]


def _host(value):
    """A state variable read back to the host as numpy."""
    return value.detach().cpu().numpy()


class Evaluator:
    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []

    def _create_state(self, suffix, shape, dtype="float32"):
        var = self.helper.create_global_variable(
            shape=shape, dtype=dtype, persistable=True,
            name=unique_name.generate("%s.%s" % (self.helper.name,
                                                 suffix)),
            initializer=ConstantInitializer(0.0))
        self.states.append(var)
        return var

    def reset(self, executor=None, scope=None):
        scope = scope or global_scope()
        for var in self.states:
            cur = scope.find_var(var.name)
            if cur is not None:
                scope.set_var(var.name, torch.zeros_like(cur))

    def eval(self, executor=None, scope=None):
        raise NotImplementedError


class Accuracy(Evaluator):
    """Accumulated accuracy (reference evaluator.py Accuracy)."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        total = self._create_state("total", [], "float32")
        correct = self._create_state("correct", [], "float32")

        helper = self.helper
        topk_out = helper.create_tmp_variable(input.dtype,
                                              stop_gradient=True)
        topk_idx = helper.create_tmp_variable("int64", stop_gradient=True)
        helper.append_op(type="top_k", inputs={"X": [input.name]},
                         outputs={"Out": [topk_out.name],
                                  "Indices": [topk_idx.name]},
                         attrs={"k": k})
        acc = helper.create_tmp_variable("float32", stop_gradient=True)
        bcorrect = helper.create_tmp_variable("int64", stop_gradient=True)
        btotal = helper.create_tmp_variable("int64", stop_gradient=True)
        helper.append_op(type="accuracy",
                         inputs={"Indices": [topk_idx.name],
                                 "Label": [label.name]},
                         outputs={"Accuracy": [acc.name],
                                  "Correct": [bcorrect.name],
                                  "Total": [btotal.name]})
        # state += batch
        for state, batch in ((total, btotal), (correct, bcorrect)):
            casted = helper.create_tmp_variable("float32",
                                                stop_gradient=True)
            helper.append_op(type="cast", inputs={"X": [batch.name]},
                             outputs={"Out": [casted.name]},
                             attrs={"out_dtype": "float32"})
            helper.append_op(type="sum",
                             inputs={"X": [state.name, casted.name]},
                             outputs={"Out": [state.name]},
                             infer_shape=False)
        self.metric = acc
        self._total, self._correct = total, correct

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        total = float(_host(scope.find_var(self._total.name)))
        correct = float(_host(scope.find_var(self._correct.name)))
        return correct / max(total, 1.0)


class ChunkEvaluator(Evaluator):
    """Chunk-level F1 over padded tag sequences (reference
    ChunkEvaluator / chunk_eval_op) for IOB-tagged outputs."""

    def __init__(self, input, label, length, num_chunk_types,
                 chunk_scheme="IOB", **kwargs):
        super().__init__("chunk_evaluator", **kwargs)
        self.num_correct = self._create_state("correct", [], "float32")
        self.num_infer = self._create_state("infer", [], "float32")
        self.num_label = self._create_state("label", [], "float32")
        helper = self.helper
        correct = helper.create_tmp_variable("float32",
                                             stop_gradient=True)
        infer = helper.create_tmp_variable("float32", stop_gradient=True)
        lab = helper.create_tmp_variable("float32", stop_gradient=True)
        helper.append_op(type="chunk_eval_counts",
                         inputs={"Inference": [input.name],
                                 "Label": [label.name],
                                 "Length": [length.name]},
                         outputs={"Correct": [correct.name],
                                  "Infer": [infer.name],
                                  "Label": [lab.name]},
                         attrs={"num_chunk_types": num_chunk_types,
                                "chunk_scheme": chunk_scheme})
        for state, batch in ((self.num_correct, correct),
                             (self.num_infer, infer),
                             (self.num_label, lab)):
            helper.append_op(type="sum",
                             inputs={"X": [state.name, batch.name]},
                             outputs={"Out": [state.name]},
                             infer_shape=False)

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        c = float(_host(scope.find_var(self.num_correct.name)))
        i = float(_host(scope.find_var(self.num_infer.name)))
        l = float(_host(scope.find_var(self.num_label.name)))
        precision = c / i if i else 0.0
        recall = c / l if l else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0
        return precision, recall, f1


class DetectionMAP:
    """Host-side mAP evaluator (reference
    ``gserver/evaluators/DetectionMAPEvaluator.cpp``; the reference also
    computes mAP on CPU outside the device graph). Feed per batch:
    ``update(detections, gt_boxes, gt_labels, gt_counts)`` (arrays or
    tensors, read back to the host) with
    detections [N, K, 6] rows (label, score, x1, y1, x2, y2), label -1
    = empty, and padded ground truth. ``eval()`` returns mAP over the
    accumulated stream (11-point interpolation by default, or
    'integral')."""

    def __init__(self, num_classes, overlap_threshold=0.5,
                 ap_version="11point", background_label=0):
        self.num_classes = num_classes
        self.overlap = overlap_threshold
        self.ap_version = ap_version
        self.background = background_label
        self.reset()

    def reset(self, executor=None, scope=None):
        # per class: list of (score, tp) + GT count
        self._dets = {c: [] for c in range(self.num_classes)}
        self._n_gt = {c: 0 for c in range(self.num_classes)}

    @staticmethod
    def _iou(a, b):
        ax1, ay1, ax2, ay2 = a
        bx1, by1, bx2, by2 = b
        ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        iy = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = ix * iy
        ua = max(0.0, ax2 - ax1) * max(0.0, ay2 - ay1) + \
            max(0.0, bx2 - bx1) * max(0.0, by2 - by1) - inter
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gt_boxes, gt_labels, gt_counts):
        detections, gt_boxes, gt_labels, gt_counts = (
            _host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in (detections, gt_boxes, gt_labels, gt_counts))
        gt_labels = gt_labels.reshape(gt_boxes.shape[0], -1)
        gt_counts = gt_counts.reshape(-1)
        for n in range(detections.shape[0]):
            cnt = int(gt_counts[n])
            # tolerate padded / out-of-range GT labels like detection
            # rows (label -1 = empty)
            gts = [(int(gt_labels[n, g]), gt_boxes[n, g])
                   for g in range(cnt) if int(gt_labels[n, g]) >= 0]
            for c in set(l for l, _ in gts):
                self._n_gt[c] = self._n_gt.get(c, 0) + \
                    sum(1 for l, _ in gts if l == c)
            used = [False] * cnt
            rows = [r for r in detections[n] if r[0] >= 0]
            rows.sort(key=lambda r: -r[1])
            for r in rows:
                c = int(r[0])
                best, best_g = 0.0, -1
                for g, (gl, gb) in enumerate(gts):
                    if gl != c or used[g]:
                        continue
                    v = self._iou(r[2:6], gb)
                    if v > best:
                        best, best_g = v, g
                tp = best >= self.overlap and best_g >= 0
                if tp:
                    used[best_g] = True
                self._dets.setdefault(c, []).append((float(r[1]), tp))

    def _ap(self, recs, precs):
        if self.ap_version == "integral":
            ap, prev_r = 0.0, 0.0
            for r, p in zip(recs, precs):
                ap += (r - prev_r) * p
                prev_r = r
            return ap
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            ps = [p for r, p in zip(recs, precs) if r >= t]
            ap += (max(ps) if ps else 0.0) / 11.0
        return ap

    def eval(self, executor=None, scope=None):
        aps = []
        for c in range(self.num_classes):
            if c == self.background or self._n_gt.get(c, 0) == 0:
                continue
            dets = sorted(self._dets.get(c, []), key=lambda d: -d[0])
            tp_cum, recs, precs = 0, [], []
            for i, (_, tp) in enumerate(dets):
                tp_cum += int(tp)
                recs.append(tp_cum / self._n_gt[c])
                precs.append(tp_cum / (i + 1))
            aps.append(self._ap(recs, precs) if dets else 0.0)
        return float(np.mean(aps)) if aps else 0.0


class Auc(Evaluator):
    """Accumulated ROC-AUC (reference auc_op.cc accumulation +
    gserver rankauc evaluator capability): per-threshold TP/FP/FN/TN
    counts accumulate across batches; eval() integrates the ROC."""

    def __init__(self, input, label, num_thresholds=200, **kwargs):
        super().__init__("auc_evaluator", **kwargs)
        self.num_thresholds = num_thresholds
        self._counts = self._create_state("counts",
                                          [num_thresholds, 4], "float32")
        helper = self.helper
        auc_out = helper.create_tmp_variable("float32",
                                             stop_gradient=True)
        counts = helper.create_tmp_variable("float32", stop_gradient=True)
        helper.append_op(type="auc",
                         inputs={"Out": [input.name],
                                 "Label": [label.name]},
                         outputs={"AUC": [auc_out.name],
                                  "StatCounts": [counts.name]},
                         attrs={"num_thresholds": num_thresholds})
        helper.append_op(type="sum",
                         inputs={"X": [self._counts.name, counts.name]},
                         outputs={"Out": [self._counts.name]},
                         infer_shape=False)
        self.metric = auc_out

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        c = _host(scope.find_var(self._counts.name))
        tp, fp, fn, tn = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
        tpr = tp / np.maximum(tp + fn, 1e-12)
        fpr = fp / np.maximum(fp + tn, 1e-12)
        return float(abs(np.sum((fpr[:-1] - fpr[1:]) *
                                (tpr[:-1] + tpr[1:]) / 2.0)))


class PrecisionRecall(Evaluator):
    """Accumulated per-class precision/recall/F1 (reference
    precision_recall_op.cc states + gserver precision_recall
    evaluator). eval() returns 6 numbers: macro then micro (p, r, f1)."""

    def __init__(self, input, label, num_classes, **kwargs):
        super().__init__("precision_recall_evaluator", **kwargs)
        self.num_classes = num_classes
        self._states = self._create_state("tp_fp_fn", [num_classes, 3],
                                          "float32")
        helper = self.helper
        topk_out = helper.create_tmp_variable(input.dtype,
                                              stop_gradient=True)
        topk_idx = helper.create_tmp_variable("int64", stop_gradient=True)
        helper.append_op(type="top_k", inputs={"X": [input.name]},
                         outputs={"Out": [topk_out.name],
                                  "Indices": [topk_idx.name]},
                         attrs={"k": 1})
        batch = helper.create_tmp_variable("float32", stop_gradient=True)
        accum = helper.create_tmp_variable("float32", stop_gradient=True)
        states = helper.create_tmp_variable("float32", stop_gradient=True)
        helper.append_op(type="precision_recall",
                         inputs={"MaxProbs": [topk_out.name],
                                 "Indices": [topk_idx.name],
                                 "Labels": [label.name]},
                         outputs={"BatchMetrics": [batch.name],
                                  "AccumMetrics": [accum.name],
                                  "AccumStatesInfo": [states.name]},
                         attrs={"class_number": num_classes})
        helper.append_op(type="sum",
                         inputs={"X": [self._states.name, states.name]},
                         outputs={"Out": [self._states.name]},
                         infer_shape=False)
        self.metric = batch

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        s = _host(scope.find_var(self._states.name))
        tp, fp, fn = s[:, 0], s[:, 1], s[:, 2]
        p = tp / np.maximum(tp + fp, 1e-12)
        r = tp / np.maximum(tp + fn, 1e-12)
        f1 = 2 * p * r / np.maximum(p + r, 1e-12)
        mi_p = tp.sum() / max(float((tp + fp).sum()), 1e-12)
        mi_r = tp.sum() / max(float((tp + fn).sum()), 1e-12)
        mi_f = 2 * mi_p * mi_r / max(mi_p + mi_r, 1e-12)
        return (float(p.mean()), float(r.mean()), float(f1.mean()),
                float(mi_p), float(mi_r), float(mi_f))


class PnPair(Evaluator):
    """Accumulated positive-negative pair ranking ratio (reference
    positive_negative_pair_op / gserver pnpair evaluator)."""

    def __init__(self, score, label, query_id, **kwargs):
        super().__init__("pnpair_evaluator", **kwargs)
        self._pos = self._create_state("pos", [], "float32")
        self._neg = self._create_state("neg", [], "float32")
        helper = self.helper
        pos = helper.create_tmp_variable("float32", stop_gradient=True)
        neg = helper.create_tmp_variable("float32", stop_gradient=True)
        neu = helper.create_tmp_variable("float32", stop_gradient=True)
        helper.append_op(type="positive_negative_pair",
                         inputs={"Score": [score.name],
                                 "Label": [label.name],
                                 "QueryID": [query_id.name]},
                         outputs={"PositivePair": [pos.name],
                                  "NegativePair": [neg.name],
                                  "NeutralPair": [neu.name]})
        for state, batch in ((self._pos, pos), (self._neg, neg)):
            helper.append_op(type="sum",
                             inputs={"X": [state.name, batch.name]},
                             outputs={"Out": [state.name]},
                             infer_shape=False)

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        pos = float(_host(scope.find_var(self._pos.name)))
        neg = float(_host(scope.find_var(self._neg.name)))
        return pos / max(neg, 1e-12)


class EditDistanceEvaluator(Evaluator):
    """Accumulated mean edit distance (reference ctc_error evaluator /
    edit_distance_op accumulation)."""

    def __init__(self, hyps, hyps_length, refs, refs_length,
                 normalized=False, **kwargs):
        super().__init__("edit_distance_evaluator", **kwargs)
        self._total = self._create_state("total", [], "float32")
        self._count = self._create_state("count", [], "float32")
        helper = self.helper
        dist = helper.create_tmp_variable("float32", stop_gradient=True)
        seq_num = helper.create_tmp_variable("float32",
                                             stop_gradient=True)
        helper.append_op(type="edit_distance",
                         inputs={"Hyps": [hyps.name],
                                 "HypsLength": [hyps_length.name],
                                 "Refs": [refs.name],
                                 "RefsLength": [refs_length.name]},
                         outputs={"Out": [dist.name],
                                  "SequenceNum": [seq_num.name]},
                         attrs={"normalized": normalized})
        summed = helper.create_tmp_variable("float32",
                                            stop_gradient=True)
        cnt = helper.create_tmp_variable("float32", stop_gradient=True)
        helper.append_op(type="reduce_sum", inputs={"X": [dist.name]},
                         outputs={"Out": [summed.name]},
                         attrs={"dim": None, "keep_dim": False,
                                "reduce_all": True})
        helper.append_op(type="cast", inputs={"X": [seq_num.name]},
                         outputs={"Out": [cnt.name]},
                         attrs={"out_dtype": "float32"})
        for state, batch in ((self._total, summed),
                             (self._count, cnt)):
            helper.append_op(type="sum",
                             inputs={"X": [state.name, batch.name]},
                             outputs={"Out": [state.name]},
                             infer_shape=False)
        self.metric = dist

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        total = float(_host(scope.find_var(self._total.name)))
        n_seq = float(_host(scope.find_var(self._count.name)))
        return total / max(n_seq, 1.0)


class SumEvaluator(Evaluator):
    """Accumulated sum of the input, reported per sample (reference
    SumEvaluator, Evaluator.cpp:160-270; config api sum_evaluator).
    Optional ``weight`` multiplies per-sample rows and divides the
    sample count, as the reference's weighted mode."""

    _NAME = "sum_evaluator"
    _REDUCE_DIM = None   # full sum; ColumnSum keeps columns

    def __init__(self, input, weight=None, **kwargs):
        super().__init__(self._NAME, **kwargs)
        shape = [] if self._REDUCE_DIM is None else [input.shape[-1]]
        total = self._create_state("sum", shape, "float32")
        samples = self._create_state("samples", [], "float32")
        x = input
        if weight is not None:
            x = layers.elementwise_mul(input, weight)
        bsum = layers.reduce_sum(x) if self._REDUCE_DIM is None \
            else layers.reduce_sum(x, dim=self._REDUCE_DIM)
        bn = layers.reduce_sum(weight) if weight is not None else \
            layers.reduce_sum(
                layers.fill_constant_batch_size_like(
                    input, [-1], "float32", 1.0))
        for state, batch in ((total, bsum), (samples, bn)):
            self.helper.append_op(
                type="sum", inputs={"X": [state.name, batch.name]},
                outputs={"Out": [state.name]}, infer_shape=False)
        self._sum, self._samples = total, samples

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        s = _host(scope.find_var(self._sum.name))
        n = float(_host(scope.find_var(self._samples.name)))
        out = s / max(n, 1.0)
        return float(out) if out.ndim == 0 else out


class ColumnSumEvaluator(SumEvaluator):
    """Per-column accumulated mean (reference ColumnSumEvaluator,
    Evaluator.cpp:273-360; config api column_sum_evaluator).
    ``col_idx``: report one column, or None for the full vector."""

    _NAME = "column_sum_evaluator"
    _REDUCE_DIM = 0

    def __init__(self, input, weight=None, col_idx=None, **kwargs):
        super().__init__(input, weight=weight, **kwargs)
        self.col_idx = col_idx

    def eval(self, executor=None, scope=None):
        out = super().eval(executor, scope)
        return float(out[self.col_idx]) if self.col_idx is not None \
            else out


# ---- printer evaluators ---------------------------------------------
# The reference's debugging surface (Evaluator.cpp:1018-1357): each
# prints its subject per batch. Temporaries never materialize in a
# Scope, so printers attach a print op INSIDE the step: its line appears
# at each run, rather than at eval() time.

class _Printer(Evaluator):
    def eval(self, executor=None, scope=None):
        return None


class ValuePrinter(_Printer):
    """Print layer outputs (value_printer_evaluator)."""

    def __init__(self, *inputs, **kwargs):
        super().__init__("value_printer", **kwargs)
        for v in inputs:
            layers.Print(v, message="value_printer %s" % v.name)


class GradientPrinter(_Printer):
    """Print a variable's gradient (gradient_printer_evaluator).
    Construct AFTER optimizer.minimize so the @GRAD vars exist."""

    def __init__(self, *inputs, **kwargs):
        super().__init__("gradient_printer", **kwargs)
        block = self.helper.main_program.global_block()
        for v in inputs:
            # multi-consumer vars carry per-consumer contributions in
            # name@GRAD, name@GRAD@1, ... with the TRUE sum in
            # name@GRAD@SUM (core/backward.py) — print the sum if the
            # var has one
            gname = v.name + "@GRAD"
            gsum = gname + "@SUM"
            if block.has_var(gsum):
                gname = gsum
            elif not block.has_var(gname):
                raise ValueError(
                    "no gradient recorded for %r — construct "
                    "GradientPrinter after minimize()" % v.name)
            layers.Print(block.var(gname),
                         message="gradient_printer %s" % gname)


class MaxIdPrinter(_Printer):
    """Print per-row argmax ids (maxid_printer_evaluator)."""

    def __init__(self, input, **kwargs):
        super().__init__("maxid_printer", **kwargs)
        ids = layers.argmax(input, axis=-1)
        layers.Print(ids, message="maxid_printer %s" % input.name)


class MaxFramePrinter(_Printer):
    """Print, per sequence, the frame (time step) with the max value
    (maxframe_printer_evaluator)."""

    def __init__(self, input, **kwargs):
        super().__init__("maxframe_printer", **kwargs)
        score = layers.reduce_max(input, dim=-1)
        frame = layers.argmax(score, axis=-1)
        layers.Print(frame, message="maxframe_printer %s" % input.name)


class SeqTextPrinter(_Printer):
    """Print generated id sequences (seq_text_printer_evaluator). The
    reference maps ids through a dict file on the host; here ids print
    in-step and ``to_text(ids, vocab)`` does the host-side join."""

    def __init__(self, input, **kwargs):
        super().__init__("seq_text_printer", **kwargs)
        layers.Print(input, message="seq_text_printer %s" % input.name)

    @staticmethod
    def to_text(ids, vocab, eos_id=1):
        out = []
        for row in np.asarray(ids):
            toks = []
            for t in row:
                if t == eos_id:
                    break
                toks.append(vocab[int(t)] if int(t) < len(vocab)
                            else "<unk>")
            out.append(" ".join(toks))
        return out


class ClassificationErrorPrinter(_Printer):
    """Print per-sample 0/1 classification error
    (classification_error_printer_evaluator)."""

    def __init__(self, input, label, **kwargs):
        super().__init__("classification_error_printer", **kwargs)
        pred = layers.argmax(input, axis=-1)
        lbl = layers.reshape(label, [-1])
        err = layers.cast(
            layers.control_flow.equal(pred, lbl), "float32")
        err = layers.scale(err, scale=-1.0, bias=1.0)
        layers.Print(err, message="classification_error_printer")
