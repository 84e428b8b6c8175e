"""Evaluation / metrics — streaming accumulators that merge across
workers: a copy, numpy only, of ``deeplearning4j_tpu/evaluation/
evaluation.py``.

ref: ``org.nd4j.evaluation.classification.{Evaluation, ROC, ROCBinary,
ROCMultiClass, EvaluationBinary, ConfusionMatrix, EvaluationCalibration}``
and ``regression.RegressionEvaluation``: streaming ``eval(labels,
predictions)`` accumulation; ``merge(other)`` for distributed
evaluation; accuracy/precision/recall/f1 with per-class and macro
averages. Inputs are host arrays: the networks' ``evaluate`` pulls the
predictions from the card in chunks before they come here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ConfusionMatrix:
    """ref: org.nd4j.evaluation.classification.ConfusionMatrix."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def grow(self, n: int):
        if n > self.num_classes:
            m = np.zeros((n, n), np.int64)
            m[:self.num_classes, :self.num_classes] = self.matrix
            self.matrix = m
            self.num_classes = n

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        hi = int(max(actual.max(initial=0), predicted.max(initial=0))) + 1
        self.grow(hi)
        idx = actual.astype(np.int64) * self.num_classes + predicted.astype(np.int64)
        counts = np.bincount(idx, minlength=self.num_classes ** 2)
        self.matrix += counts.reshape(self.num_classes, self.num_classes)

    def getCount(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def merge(self, other: "ConfusionMatrix"):
        self.matrix += other.matrix


class Evaluation:
    """Multi-class classification metrics (ref: Evaluation)."""

    def __init__(self, num_classes: int = None, labels: List[str] = None):
        self.num_classes = num_classes or (len(labels) if labels else None)
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None
        self._examples = 0

    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [N, C] probabilities/one-hot, or [N] ints;
        time series [N, C, T] are flattened over time with mask applied
        (reference semantics)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:  # [N, C, T] -> [N*T, C] with mask [N, T]
            n, c, t = labels.shape
            labels = labels.transpose(0, 2, 1).reshape(-1, c)
            predictions = predictions.transpose(0, 2, 1).reshape(-1, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        elif mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        actual = labels.argmax(1) if labels.ndim == 2 else labels.astype(np.int64)
        pred = predictions.argmax(1) if predictions.ndim == 2 else predictions.astype(np.int64)
        n_cls = labels.shape[1] if labels.ndim == 2 else int(max(actual.max(), pred.max())) + 1
        self._ensure(n_cls)
        self.confusion.add(actual, pred)
        self.num_classes = self.confusion.num_classes  # may have grown (int labels)
        self._examples += len(actual)

    # -- metrics --
    def _tp(self, c): return self.confusion.matrix[c, c]
    def _fp(self, c): return self.confusion.matrix[:, c].sum() - self._tp(c)
    def _fn(self, c): return self.confusion.matrix[c, :].sum() - self._tp(c)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        return float(np.trace(m) / max(m.sum(), 1))

    def precision(self, cls: int = None) -> float:
        if cls is not None:
            tp, fp = self._tp(cls), self._fp(cls)
            return float(tp / max(tp + fp, 1))
        vals = [self.precision(c) for c in range(self.num_classes)
                if (self.confusion.matrix[:, c].sum() + self.confusion.matrix[c, :].sum()) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: int = None) -> float:
        if cls is not None:
            tp, fn = self._tp(cls), self._fn(cls)
            return float(tp / max(tp + fn, 1))
        vals = [self.recall(c) for c in range(self.num_classes)
                if (self.confusion.matrix[:, c].sum() + self.confusion.matrix[c, :].sum()) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: int = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return float(2 * p * r / max(p + r, 1e-12))
        # reference macro-F1 = mean of per-class F1 (NOT F1 of macro P/R)
        vals = [self.f1(c) for c in range(self.num_classes)
                if (self.confusion.matrix[:, c].sum()
                    + self.confusion.matrix[c, :].sum()) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def falsePositiveRate(self, cls: int) -> float:
        fp = self._fp(cls)
        tn = self.confusion.matrix.sum() - self._tp(cls) - self._fp(cls) - self._fn(cls)
        return float(fp / max(fp + tn, 1))

    def matthewsCorrelation(self, cls: int) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self.confusion.matrix.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0

    def merge(self, other: "Evaluation"):
        """Distributed-eval merge (ref: IEvaluation.merge, used by Spark)."""
        if other.confusion is None:
            return
        self._ensure(other.num_classes)
        self.confusion.grow(other.confusion.num_classes)
        other_m = other.confusion.matrix
        self.confusion.matrix[:other_m.shape[0], :other_m.shape[1]] += other_m
        self.num_classes = self.confusion.num_classes
        self._examples += other._examples

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Examples:        {self._examples}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "=================================================================",
        ]
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output independent binary metrics (ref: EvaluationBinary)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        preds = (np.asarray(predictions) >= self.threshold).astype(np.int64)
        lab = (labels >= 0.5).astype(np.int64)
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        w = np.ones_like(lab) if mask is None else np.asarray(mask).astype(np.int64)
        self.tp += ((preds == 1) & (lab == 1) & (w > 0)).sum(0)
        self.fp += ((preds == 1) & (lab == 0) & (w > 0)).sum(0)
        self.tn += ((preds == 0) & (lab == 0) & (w > 0)).sum(0)
        self.fn += ((preds == 0) & (lab == 1) & (w > 0)).sum(0)

    def accuracy(self, output: int = None) -> float:
        tp, fp, tn, fn = self.tp, self.fp, self.tn, self.fn
        if output is not None:
            tp, fp, tn, fn = tp[output], fp[output], tn[output], fn[output]
        else:
            tp, fp, tn, fn = tp.sum(), fp.sum(), tn.sum(), fn.sum()
        return float((tp + tn) / max(tp + tn + fp + fn, 1))

    def precision(self, output: int) -> float:
        return float(self.tp[output] / max(self.tp[output] + self.fp[output], 1))

    def recall(self, output: int) -> float:
        return float(self.tp[output] / max(self.tp[output] + self.fn[output], 1))

    def merge(self, other: "EvaluationBinary"):
        if other.tp is None:
            return
        if self.tp is None:
            self.tp, self.fp = other.tp.copy(), other.fp.copy()
            self.tn, self.fn = other.tn.copy(), other.fn.copy()
        else:
            self.tp += other.tp
            self.fp += other.fp
            self.tn += other.tn
            self.fn += other.fn


class ROC:
    """Binary ROC/AUC (ref: ROC).

    ``threshold_steps > 0``: histogram approximation at fixed thresholds
    (constant memory — the reference's default 30 steps / our 100).
    ``threshold_steps = 0``: EXACT mode — every (probability, label) pair
    is retained and the AUC is computed over all distinct thresholds
    (ref: "exact" ROC introduced in DL4J 0.9.1, thresholdSteps=0)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.exact = threshold_steps == 0
        self.tp = np.zeros(max(threshold_steps, 0) + 1, np.int64)
        self.fp = np.zeros(max(threshold_steps, 0) + 1, np.int64)
        self.pos = 0
        self.neg = 0
        self._probs: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions):
        labels = np.asarray(labels).reshape(-1)
        probs = np.asarray(predictions).reshape(-1)
        pos = labels >= 0.5
        self.pos += int(pos.sum())
        self.neg += int((~pos).sum())
        if self.exact:
            self._probs.append(probs.astype(np.float64))
            self._labels.append(pos)
            return
        thresholds = np.linspace(0.0, 1.0, self.steps + 1)
        for i, t in enumerate(thresholds):
            sel = probs >= t
            self.tp[i] += int((sel & pos).sum())
            self.fp[i] += int((sel & ~pos).sum())

    def _sorted_cumulative(self):
        """(p desc, cumulative tp, cumulative fp) over all retained pairs —
        shared by the exact ROC and PR curves."""
        p = np.concatenate(self._probs) if self._probs else np.zeros(0)
        y = np.concatenate(self._labels) if self._labels else np.zeros(0, bool)
        order = np.argsort(-p, kind="mergesort")
        y = y[order]
        p = p[order]
        return p, np.cumsum(y), np.cumsum(~y)

    def _exact_curve(self):
        p, tp, fp = self._sorted_cumulative()
        # curve points only where the threshold actually changes
        distinct = np.r_[np.where(np.diff(p))[0], p.size - 1] \
            if p.size else np.zeros(0, np.intp)
        tpr = np.r_[0.0, tp[distinct] / max(self.pos, 1)]
        fpr = np.r_[0.0, fp[distinct] / max(self.neg, 1)]
        return fpr, tpr

    def getRocCurve(self):
        """(fpr, tpr) arrays, exact or stepped."""
        if self.exact:
            return self._exact_curve()
        tpr = self.tp / max(self.pos, 1)
        fpr = self.fp / max(self.neg, 1)
        order = np.argsort(fpr)
        return fpr[order], tpr[order]

    def calculateAUC(self) -> float:
        fpr, tpr = self.getRocCurve()
        return float(abs(np.trapezoid(tpr, fpr)))

    def calculateAUCPR(self) -> float:
        """Area under the precision-recall curve (exact mode only gives the
        exact value; stepped mode approximates)."""
        if self.exact:
            _, tp, fp = self._sorted_cumulative()
            prec = tp / np.maximum(tp + fp, 1)
            rec = tp / max(self.pos, 1)
            if prec.size:   # anchor the curve at recall 0
                prec = np.r_[prec[0], prec]
                rec = np.r_[0.0, rec]
            return float(abs(np.trapezoid(prec, rec)))
        tpr = self.tp / max(self.pos, 1)
        sel = self.tp + self.fp
        # empty selection = precision 1 by convention (not 0 — the 0 anchor
        # grossly underestimates AUCPR for separable data)
        prec = np.where(sel > 0, self.tp / np.maximum(sel, 1), 1.0)
        order = np.argsort(tpr)
        return float(abs(np.trapezoid(prec[order], tpr[order])))

    def merge(self, other: "ROC"):
        if self.exact != other.exact or self.steps != other.steps:
            raise ValueError(
                f"cannot merge ROC(threshold_steps={self.steps}) with "
                f"ROC(threshold_steps={other.steps}): histograms are not "
                f"convertible between modes")
        self.tp += other.tp
        self.fp += other.fp
        self.pos += other.pos
        self.neg += other.neg
        self._probs.extend(other._probs)
        self._labels.extend(other._labels)


class ROCBinary:
    """Per-output-column binary ROC for multi-label problems
    (ref: org.nd4j.evaluation.classification.ROCBinary)."""

    def __init__(self, threshold_steps: int = 0):
        self.steps = threshold_steps
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
        if preds.ndim == 1:
            preds = preds[:, None]
        if labels.shape[1] != preds.shape[1]:
            raise ValueError(
                f"ROCBinary: {labels.shape[1]} label columns vs "
                f"{preds.shape[1]} prediction columns (multi-label eval "
                f"needs one probability per label output)")
        if not self._rocs:
            self._rocs = [ROC(self.steps) for _ in range(labels.shape[1])]
        for c, roc in enumerate(self._rocs):
            roc.eval(labels[:, c], preds[:, c])

    def numLabels(self) -> int:
        return len(self._rocs)

    def calculateAUC(self, output: int) -> float:
        return self._rocs[output].calculateAUC()

    def calculateAverageAUC(self) -> float:
        if not self._rocs:
            return float("nan")
        return float(np.mean([r.calculateAUC() for r in self._rocs]))

    def merge(self, other: "ROCBinary"):
        if self._rocs and other._rocs and \
                len(self._rocs) != len(other._rocs):
            raise ValueError(
                f"cannot merge ROCBinary with {len(self._rocs)} outputs "
                f"into one with {len(other._rocs)}")
        if not self._rocs:
            # deep copy: aliasing the other accumulator's ROCs would let a
            # later eval() on self corrupt other's counts
            import copy
            self._rocs = copy.deepcopy(other._rocs)
        else:
            for a, b in zip(self._rocs, other._rocs):
                a.merge(b)


class EvaluationCalibration:
    """Probability-calibration diagnostics (ref:
    org.nd4j.evaluation.classification.EvaluationCalibration): the
    reliability diagram (mean predicted probability vs observed frequency
    per bin), per-class prediction-probability histograms, and the
    residual-|p - y| histogram."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 10):
        self.rel_bins = reliability_bins
        self.hist_bins = histogram_bins
        self._rel_counts = np.zeros(reliability_bins, np.int64)
        self._rel_prob_sum = np.zeros(reliability_bins, np.float64)
        self._rel_pos = np.zeros(reliability_bins, np.int64)
        self._resid_counts = np.zeros(histogram_bins, np.int64)
        self._prob_counts: Optional[np.ndarray] = None   # [C, bins]

    def eval(self, labels, predictions):
        y = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        if p.ndim == 1:
            p = p[:, None]
        if y.shape != p.shape:
            raise ValueError(
                f"EvaluationCalibration: labels {y.shape} vs predictions "
                f"{p.shape} (one probability per label output required)")
        C = y.shape[1]
        if self._prob_counts is None:
            self._prob_counts = np.zeros((C, self.hist_bins), np.int64)
        # reliability over every (class, example) probability
        flat_p = p.reshape(-1)
        flat_y = y.reshape(-1)
        bins = np.clip((flat_p * self.rel_bins).astype(int), 0,
                       self.rel_bins - 1)
        np.add.at(self._rel_counts, bins, 1)
        np.add.at(self._rel_prob_sum, bins, flat_p)
        np.add.at(self._rel_pos, bins, (flat_y >= 0.5).astype(np.int64))
        # residual histogram |p - y|
        resid = np.abs(flat_p - flat_y)
        rbins = np.clip((resid * self.hist_bins).astype(int), 0,
                        self.hist_bins - 1)
        np.add.at(self._resid_counts, rbins, 1)
        # per-class probability histograms
        for c in range(C):
            cb = np.clip((p[:, c] * self.hist_bins).astype(int), 0,
                         self.hist_bins - 1)
            np.add.at(self._prob_counts[c], cb, 1)

    def getReliabilityInfo(self):
        """(mean predicted prob, observed positive fraction, count) per bin
        — the reliability diagram's x, y, and weights."""
        cnt = np.maximum(self._rel_counts, 1)
        return (self._rel_prob_sum / cnt,
                self._rel_pos / cnt,
                self._rel_counts.copy())

    def expectedCalibrationError(self) -> float:
        mean_p, frac_pos, counts = self.getReliabilityInfo()
        total = max(counts.sum(), 1)
        return float(np.sum(counts / total * np.abs(mean_p - frac_pos)))

    def getResidualPlot(self):
        return self._resid_counts.copy()

    def getProbabilityHistogram(self, class_idx: int):
        return self._prob_counts[class_idx].copy()

    def merge(self, other: "EvaluationCalibration"):
        self._rel_counts += other._rel_counts
        self._rel_prob_sum += other._rel_prob_sum
        self._rel_pos += other._rel_pos
        self._resid_counts += other._resid_counts
        if self._prob_counts is None:
            self._prob_counts = None if other._prob_counts is None \
                else other._prob_counts.copy()
        elif other._prob_counts is not None:
            self._prob_counts += other._prob_counts


class ROCMultiClass:
    """One-vs-all ROC per class (ref: ROCMultiClass)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        for c in range(labels.shape[1]):
            self.rocs.setdefault(c, ROC(self.steps)).eval(labels[:, c], preds[:, c])

    def calculateAUC(self, cls: int) -> float:
        return self.rocs[cls].calculateAUC()


class RegressionEvaluation:
    """Per-column regression metrics (ref: RegressionEvaluation): MSE, MAE,
    RMSE, RSE, PC (Pearson), R²."""

    def __init__(self, n_columns: int = None):
        self.n = n_columns
        self._init_done = False

    def _ensure(self, n):
        if not self._init_done:
            self.n = self.n or n
            z = lambda: np.zeros(self.n, np.float64)
            self.sum_sq_err = z()
            self.sum_abs_err = z()
            self.sum_label = z()
            self.sum_label_sq = z()
            self.sum_pred = z()
            self.sum_pred_sq = z()
            self.sum_label_pred = z()
            self.count = 0
            self._init_done = True

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(predictions, np.float64)
        if labels.ndim == 1:
            labels, preds = labels[:, None], preds[:, None]
        self._ensure(labels.shape[1])
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, preds = labels[keep], preds[keep]
        err = preds - labels
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred_sq += (preds ** 2).sum(0)
        self.sum_label_pred += (labels * preds).sum(0)
        self.count += labels.shape[0]

    def meanSquaredError(self, col: int = 0) -> float:
        return float(self.sum_sq_err[col] / max(self.count, 1))

    def meanAbsoluteError(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / max(self.count, 1))

    def rootMeanSquaredError(self, col: int = 0) -> float:
        return float(np.sqrt(self.meanSquaredError(col)))

    def pearsonCorrelation(self, col: int = 0) -> float:
        n = self.count
        num = n * self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col]
        den = np.sqrt(max(n * self.sum_label_sq[col] - self.sum_label[col] ** 2, 0)) * \
            np.sqrt(max(n * self.sum_pred_sq[col] - self.sum_pred[col] ** 2, 0))
        return float(num / den) if den > 0 else 0.0

    def rSquared(self, col: int = 0) -> float:
        mean_label = self.sum_label[col] / max(self.count, 1)
        ss_tot = self.sum_label_sq[col] - self.count * mean_label ** 2
        return float(1.0 - self.sum_sq_err[col] / ss_tot) if ss_tot > 0 else 0.0

    def merge(self, other: "RegressionEvaluation"):
        if not getattr(other, "_init_done", False):
            return
        if not self._init_done:
            self.__dict__.update({k: (v.copy() if isinstance(v, np.ndarray) else v)
                                  for k, v in other.__dict__.items()})
            return
        for k in ("sum_sq_err", "sum_abs_err", "sum_label", "sum_label_sq",
                  "sum_pred", "sum_pred_sq", "sum_label_pred"):
            setattr(self, k, getattr(self, k) + getattr(other, k))
        self.count += other.count

    def stats(self) -> str:
        cols = range(self.n)
        return "\n".join(
            f"col {c}: MSE={self.meanSquaredError(c):.6f} "
            f"MAE={self.meanAbsoluteError(c):.6f} "
            f"RMSE={self.rootMeanSquaredError(c):.6f} "
            f"R2={self.rSquared(c):.4f}" for c in cols)
