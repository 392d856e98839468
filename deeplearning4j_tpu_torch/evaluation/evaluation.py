"""Evaluation metrics.

Analogs of the reference's eval package (deeplearning4j-nn/.../eval/):
``Evaluation`` (accuracy incl. top-N, precision/recall/F1/fBeta/
gMeasure/MCC with macro/micro averaging, false positive/negative/alarm
rates, per-class stats table + confusion matrix — Evaluation.java:88),
``RegressionEvaluation``, ``ROC``/``ROCBinary`` (AUC via exact
thresholding + RocCurve/PrecisionRecallCurve exports),
``EvaluationBinary``, ``EvaluationCalibration`` (ReliabilityDiagram/
Histogram exports). Curve objects live in evaluation/curves.py.

A copy of the JAX package's ``evaluation/evaluation.py`` (numpy only):
accumulation happens on the host in numpy; the model's forward pass that
produces the predictions runs on the model's device, and ``evaluate``
brings each batch's predictions to the host once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Evaluation:
    """Multi-class classification metrics over one-hot or index labels.

    Reference surface: Evaluation.java — accuracy, precision/recall/F1
    (per-class, macro, micro), top-N accuracy (Evaluation.java:96,1287),
    fBeta/gMeasure (:1119,:1225), Matthews correlation (:52,1306),
    false positive/negative/alarm rates (:1093), per-class stats table.

    ``top_n``: scores a row correct when the true class is within the
    top N predicted probabilities (<=1: standard accuracy; only applies
    to the probability form of ``eval``, like the reference).
    ``binary_positive_class``: for 2-class problems the no-arg
    precision/recall/f1 report this class only (reference default 1);
    pass None to macro-average instead.
    """

    def __init__(self, num_classes: Optional[int] = None,
                 label_names: Optional[List[str]] = None,
                 top_n: int = 1,
                 binary_positive_class: Optional[int] = 1):
        self.num_classes = num_classes
        self.label_names = label_names
        self.top_n = max(int(top_n), 1)
        self.binary_positive_class = binary_positive_class
        self._confusion: Optional[np.ndarray] = None
        self._top_n_correct = 0
        self._top_n_total = 0

    def _ensure(self, n: int):
        if self._confusion is None:
            self.num_classes = self.num_classes or n
            self._confusion = np.zeros((self.num_classes, self.num_classes),
                                       dtype=np.int64)

    def eval(self, labels, predictions, mask=None):
        """labels: one-hot (N, C) or int (N,); predictions: prob (N, C).
        Time-series (N, T, C) flattens with optional (N, T) mask — same
        as the reference's evalTimeSeries."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if predictions.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
            labels = labels.reshape(-1, labels.shape[-1]) if labels.ndim == 3 \
                else labels.reshape(-1)
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                labels = labels[m]
                predictions = predictions[m]
        pred_idx = np.argmax(predictions, axis=-1)
        if labels.ndim == 2:
            true_idx = np.argmax(labels, axis=-1)
        else:
            true_idx = labels.astype(np.int64)
        self._ensure(predictions.shape[-1])
        np.add.at(self._confusion, (true_idx, pred_idx), 1)
        if self.top_n > 1 and predictions.ndim == 2 \
                and predictions.shape[-1] > 1:
            # correct when < topN entries score strictly higher than the
            # true class (reference: Evaluation.java:502-518)
            true_scores = predictions[np.arange(len(true_idx)), true_idx]
            greater = (predictions > true_scores[:, None]).sum(axis=-1)
            self._top_n_correct += int((greater < self.top_n).sum())
            self._top_n_total += len(true_idx)

    # ---- per-class counts (reference: Evaluation.java:1410-1460) -------
    def _tp(self):
        return np.diag(self._confusion).astype(np.float64)

    def _fp(self):
        c = self._confusion
        return c.sum(axis=0).astype(np.float64) - self._tp()

    def _fn(self):
        c = self._confusion
        return c.sum(axis=1).astype(np.float64) - self._tp()

    def _tn(self):
        return float(self._confusion.sum()) - self._tp() - self._fp() \
            - self._fn()

    def true_positives(self) -> Dict[int, int]:
        return {i: int(v) for i, v in enumerate(self._tp())}

    def false_positives(self) -> Dict[int, int]:
        return {i: int(v) for i, v in enumerate(self._fp())}

    def false_negatives(self) -> Dict[int, int]:
        return {i: int(v) for i, v in enumerate(self._fn())}

    def true_negatives(self) -> Dict[int, int]:
        return {i: int(v) for i, v in enumerate(self._tn())}

    def _is_binary_mode(self) -> bool:
        return (self.binary_positive_class is not None
                and self.num_classes == 2)

    # ---- metrics --------------------------------------------------------
    def accuracy(self) -> float:
        c = self._confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def top_n_accuracy(self) -> float:
        """Reference: Evaluation.java:1287 (topNAccuracy). Equal to
        ``accuracy()`` when top_n <= 1."""
        if self.top_n <= 1:
            return self.accuracy()
        if self._top_n_total == 0:
            return 0.0
        return self._top_n_correct / self._top_n_total

    def _per_class_precision(self) -> np.ndarray:
        denom = self._tp() + self._fp()
        return np.divide(self._tp(), denom, out=np.zeros_like(denom),
                         where=denom > 0)

    def _per_class_recall(self) -> np.ndarray:
        denom = self._tp() + self._fn()
        return np.divide(self._tp(), denom, out=np.zeros_like(denom),
                         where=denom > 0)

    def precision(self, cls: Optional[int] = None,
                  averaging: Optional[str] = None) -> float:
        """Per-class, or binary-positive-class / averaged when cls is
        None. ``averaging=None`` (the default) means: positive class
        only for 2-class problems, else macro. An explicit
        "macro"/"micro" is always honored (the reference's
        EvaluationAveraging overloads ignore binaryPositiveClass).
        Macro averaging excludes never-predicted classes (the
        reference's averagePrecisionNumClassesExcluded handling)."""
        prec = self._per_class_precision()
        if cls is not None:
            return float(prec[cls])
        if averaging is None:
            if self._is_binary_mode():
                return float(prec[self.binary_positive_class])
            averaging = "macro"
        if averaging == "micro":
            tp, fp = self._tp().sum(), self._fp().sum()
            return float(tp / (tp + fp)) if tp + fp > 0 else 0.0
        predicted = (self._tp() + self._fp()) > 0
        return float(prec[predicted].mean()) if predicted.any() else 0.0

    def recall(self, cls: Optional[int] = None,
               averaging: Optional[str] = None) -> float:
        """Same cls/averaging contract as ``precision``. Macro averaging
        excludes classes with no actual examples."""
        rec = self._per_class_recall()
        if cls is not None:
            return float(rec[cls])
        if averaging is None:
            if self._is_binary_mode():
                return float(rec[self.binary_positive_class])
            averaging = "macro"
        if averaging == "micro":
            tp, fn = self._tp().sum(), self._fn().sum()
            return float(tp / (tp + fn)) if tp + fn > 0 else 0.0
        present = (self._tp() + self._fn()) > 0
        return float(rec[present].mean()) if present.any() else 0.0

    def f1(self, cls: Optional[int] = None,
           averaging: Optional[str] = None) -> float:
        return self.f_beta(1.0, cls, averaging)

    def f_beta(self, beta: float, cls: Optional[int] = None,
               averaging: Optional[str] = None) -> float:
        """F_beta = (1+β²)·P·R / (β²·P + R) — reference:
        Evaluation.java:1119 / EvaluationUtils.fBeta. Macro averages
        the per-class F_beta values; micro computes F_beta of the
        micro P/R."""
        if cls is None:
            if averaging is None and self._is_binary_mode():
                cls = self.binary_positive_class
            elif averaging != "micro":
                # macro: per-class P/R arrays computed ONCE, vectorized
                # (per-class f_beta calls would redo the O(n²) confusion
                # reductions n times over)
                p = self._per_class_precision()
                r = self._per_class_recall()
                denom = beta * beta * p + r
                f = np.divide((1 + beta * beta) * p * r, denom,
                              out=np.zeros_like(p), where=denom > 0)
                return float(f.mean()) if len(f) else 0.0
        p = self.precision(cls, averaging)
        r = self.recall(cls, averaging)
        denom = beta * beta * p + r
        return float((1 + beta * beta) * p * r / denom) if denom > 0 \
            else 0.0

    def g_measure(self, cls: Optional[int] = None,
                  averaging: Optional[str] = None) -> float:
        """G = sqrt(precision · recall) — reference:
        Evaluation.java:1225 / EvaluationUtils.gMeasure."""
        if cls is None:
            if averaging is None and self._is_binary_mode():
                cls = self.binary_positive_class
            elif averaging != "micro":
                g = np.sqrt(self._per_class_precision()
                            * self._per_class_recall())
                return float(g.mean()) if len(g) else 0.0
        p = self.precision(cls, averaging)
        r = self.recall(cls, averaging)
        return float(np.sqrt(p * r))

    def _per_class_mcc(self) -> np.ndarray:
        tp, fp, fn, tn = self._tp(), self._fp(), self._fn(), self._tn()
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        num = tp * tn - fp * fn
        return np.divide(num, denom, out=np.zeros_like(num),
                         where=denom > 0)

    def matthews_correlation(self, cls: Optional[int] = None,
                             averaging: Optional[str] = None) -> float:
        """Binary MCC per class (one-vs-all), macro/micro averaged when
        cls is None — reference: Evaluation.java:1306
        (MCC = (TP·TN-FP·FN)/sqrt((TP+FP)(TP+FN)(TN+FP)(TN+FN)); NOT
        the multiclass R_k statistic, same caveat as the reference)."""
        if cls is None and averaging is None and self._is_binary_mode():
            cls = self.binary_positive_class
        if cls is not None:
            return float(self._per_class_mcc()[cls])
        if averaging == "micro":
            tp, fp = self._tp().sum(), self._fp().sum()
            fn, tn = self._fn().sum(), self._tn().sum()
            denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp)
                            * (tn + fn))
            return float((tp * tn - fp * fn) / denom) if denom > 0 \
                else 0.0
        mcc = self._per_class_mcc()
        return float(mcc.mean()) if len(mcc) else 0.0

    def false_positive_rate(self, cls: Optional[int] = None) -> float:
        """FPR = FP/(FP+TN); macro-averaged (or binary positive class)
        when cls is None — reference: Evaluation.java falsePositiveRate."""
        fp, tn = self._fp(), self._tn()
        denom = fp + tn
        rates = np.divide(fp, denom, out=np.zeros_like(fp),
                          where=denom > 0)
        if cls is not None:
            return float(rates[cls])
        if self._is_binary_mode():
            return float(rates[self.binary_positive_class])
        return float(rates.mean()) if len(rates) else 0.0

    def false_negative_rate(self, cls: Optional[int] = None) -> float:
        """FNR = FN/(FN+TP) — reference: Evaluation.java:1046."""
        fn, tp = self._fn(), self._tp()
        denom = fn + tp
        rates = np.divide(fn, denom, out=np.zeros_like(fn),
                          where=denom > 0)
        if cls is not None:
            return float(rates[cls])
        if self._is_binary_mode():
            return float(rates[self.binary_positive_class])
        return float(rates.mean()) if len(rates) else 0.0

    def false_alarm_rate(self) -> float:
        """FAR = (FPR + FNR) / 2 — reference: Evaluation.java:1093."""
        return (self.false_positive_rate() + self.false_negative_rate()) \
            / 2.0

    def confusion_matrix(self) -> np.ndarray:
        return self._confusion

    # ---- report ---------------------------------------------------------
    def _label(self, i: int) -> str:
        if self.label_names is not None and i < len(self.label_names):
            return self.label_names[i]
        return str(i)

    def stats(self, suppress_warnings: bool = False) -> str:
        """Multi-line classification report: confusion lines, macro
        scores, and a per-class statistics table (reference:
        Evaluation.java:571 stats())."""
        c = self._confusion
        if c is None:
            return "Evaluation: no data"
        n = self.num_classes
        lines: List[str] = []
        for a in range(n):
            for p in range(n):
                if c[a, p] and a != p:
                    lines.append(
                        f"Predictions labeled as {self._label(a)} "
                        f"classified by model as {self._label(p)}: "
                        f"{int(c[a, p])} times")
        tp, fp, fn, tn = self._tp(), self._fp(), self._fn(), self._tn()
        if not suppress_warnings:
            # mirrors the reference's warningHelper: never-predicted
            # classes are excluded from macro precision; classes with no
            # actual examples from macro recall
            never_pred = [self._label(i) for i in range(n)
                          if tp[i] == 0 and fp[i] == 0]
            if never_pred:
                lines.append(
                    f"Warning: {len(never_pred)} class(es) were never "
                    f"predicted by the model and were excluded from "
                    f"average precision: {never_pred}")
            no_actual = [self._label(i) for i in range(n)
                         if tp[i] == 0 and fn[i] == 0]
            if no_actual:
                lines.append(
                    f"Warning: {len(no_actual)} class(es) had no "
                    f"examples and were excluded from average recall: "
                    f"{no_actual}")
        lines += [
            "========================Evaluation Metrics========================",
            f" # of classes:    {n}",
            f" Accuracy:        {self.accuracy():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top {self.top_n} Accuracy:  "
                         f"{self.top_n_accuracy():.4f}")
        lines += [
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self._is_binary_mode():
            lines.append(
                f"Precision, recall & F1: reported for positive class "
                f"(class {self.binary_positive_class}) only")
        else:
            lines.append(
                f"Precision, recall & F1: macro-averaged (equally "
                f"weighted avg. of {n} classes)")
        lines.append(
            "=======================Per-class Statistics=======================")
        lines.append(f"{'Class':<12}{'TP':>7}{'FP':>7}{'FN':>7}{'TN':>9}"
                     f"{'Precision':>11}{'Recall':>9}{'F1':>9}{'MCC':>9}")
        # vectorized once — per-row metric calls would redo O(n²)
        # confusion reductions n times over
        prec = self._per_class_precision()
        rec = self._per_class_recall()
        pr = prec + rec
        f1s = np.divide(2 * prec * rec, pr, out=np.zeros_like(pr),
                        where=pr > 0)
        mcc = self._per_class_mcc()
        for i in range(n):
            lines.append(
                f"{self._label(i):<12}{int(tp[i]):>7}{int(fp[i]):>7}"
                f"{int(fn[i]):>7}{int(tn[i]):>9}"
                f"{prec[i]:>11.4f}{rec[i]:>9.4f}"
                f"{f1s[i]:>9.4f}{mcc[i]:>9.4f}")
        lines.append(
            "==================================================================")
        return "\n".join(lines)


class RegressionEvaluation:
    """Column-wise MSE/MAE/RMSE/R²/correlation (reference:
    RegressionEvaluation.java)."""

    def __init__(self, num_columns: Optional[int] = None):
        self.n = 0
        self._sum_sq = None
        self._sum_abs = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_lp = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[m], predictions[m]
        if self._sum_sq is None:
            c = labels.shape[-1]
            self._sum_sq = np.zeros(c)
            self._sum_abs = np.zeros(c)
            self._sum_label = np.zeros(c)
            self._sum_label_sq = np.zeros(c)
            self._sum_pred = np.zeros(c)
            self._sum_pred_sq = np.zeros(c)
            self._sum_lp = np.zeros(c)
        err = predictions - labels
        self.n += labels.shape[0]
        self._sum_sq += (err ** 2).sum(axis=0)
        self._sum_abs += np.abs(err).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label_sq += (labels ** 2).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_pred_sq += (predictions ** 2).sum(axis=0)
        self._sum_lp += (labels * predictions).sum(axis=0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_sq[col] / max(self.n, 1))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs[col] / max(self.n, 1))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self._sum_label_sq[col] - self._sum_label[col] ** 2 / self.n
        ss_res = self._sum_sq[col]
        return float(1.0 - ss_res / max(ss_tot, 1e-12))

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        cov = self._sum_lp[col] - self._sum_label[col] * self._sum_pred[col] / n
        vl = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        vp = self._sum_pred_sq[col] - self._sum_pred[col] ** 2 / n
        return float(cov / max(np.sqrt(vl * vp), 1e-12))

    def average_mean_squared_error(self) -> float:
        return float(self._sum_sq.mean() / max(self.n, 1))


class ROC:
    """Binary ROC/AUC + precision-recall (exact, threshold-free — the
    reference's ROC.java with thresholdSteps=0 'exact' mode)."""

    def __init__(self):
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[-1] == 2:
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        self._labels.append(labels)
        self._scores.append(predictions)

    def calculate_auc(self) -> float:
        """AUC over the tie-collapsed threshold points (so the scalar
        agrees with get_roc_curve().calculate_auc(): a cut inside a
        tie group is not a realizable threshold, and per-sample cumsums
        would make the result depend on eval() insertion order)."""
        _, tp, fp, pos, neg, _ = self._threshold_counts()
        tpr = tp / pos if pos > 0 else np.zeros_like(tp)
        fpr = fp / neg if neg > 0 else np.zeros_like(fp)
        return float(np.trapezoid(np.concatenate([[0.0], tpr]),
                                  np.concatenate([[0.0], fpr])))

    def calculate_auprc(self) -> float:
        """AUPRC over the same tie-collapsed points, with the
        (recall=0, precision=1) anchor (reference: ROC.java exact
        mode)."""
        _, tp, fp, pos, neg, _ = self._threshold_counts()
        pred_pos = tp + fp
        prec = np.divide(tp, pred_pos, out=np.ones_like(tp),
                         where=pred_pos > 0)
        rec = tp / pos if pos > 0 else np.zeros_like(tp)
        return float(np.trapezoid(np.concatenate([[1.0], prec]),
                                  np.concatenate([[0.0], rec])))

    # ---- curve exports (reference: ROC.getRocCurve /
    # getPrecisionRecallCurve over eval/curves/*.java) -------------------
    def _threshold_counts(self):
        """Distinct score thresholds (descending) with cumulative
        TP/FP counts when classifying score >= threshold as positive.
        Tied scores collapse to one point — a cut inside a tie group is
        not a realizable threshold."""
        if not self._labels:
            z = np.zeros(0, np.float64)
            return z, z, z, 0.0, 0.0, 0
        y = np.concatenate(self._labels).astype(np.float64)
        s = np.concatenate(self._scores).astype(np.float64)
        order = np.argsort(-s, kind="mergesort")
        y, s = y[order], s[order]
        y = (y > 0.5).astype(np.float64)
        # last index of each tie group (s is descending)
        idx = np.append(np.nonzero(np.diff(s))[0], len(s) - 1)
        tp = np.cumsum(y)[idx]
        fp = np.cumsum(1.0 - y)[idx]
        thr = s[idx]
        return thr, tp, fp, float(tp[-1]) if len(tp) else 0.0, \
            float(fp[-1]) if len(fp) else 0.0, len(s)

    def get_roc_curve(self):
        """Exact ROC curve export (reference: ROC.getRocCurve →
        RocCurve.java). Starts at (0,0) with a threshold above every
        score; ends at (1,1) at the minimum score."""
        from deeplearning4j_tpu_torch.evaluation.curves import RocCurve
        thr, tp, fp, pos, neg, _ = self._threshold_counts()
        tpr = tp / pos if pos > 0 else np.zeros_like(tp)
        fpr = fp / neg if neg > 0 else np.zeros_like(fp)
        top = max(1.0, float(thr[0])) if len(thr) else 1.0
        return RocCurve(np.concatenate([[top], thr]),
                        np.concatenate([[0.0], fpr]),
                        np.concatenate([[0.0], tpr]))

    def get_precision_recall_curve(self):
        """Exact PR curve export, thresholds ascending (reference:
        ROC.getPrecisionRecallCurve → PrecisionRecallCurve.java). The
        synthetic (recall=0, precision=1) anchor sits at a threshold
        above every score, like the reference's first point."""
        from deeplearning4j_tpu_torch.evaluation.curves import (
            PrecisionRecallCurve)
        thr, tp, fp, pos, neg, total = self._threshold_counts()
        pred_pos = tp + fp
        prec = np.divide(tp, pred_pos, out=np.ones_like(tp),
                         where=pred_pos > 0)
        rec = tp / pos if pos > 0 else np.zeros_like(tp)
        # ascending thresholds + anchor point at the top
        top = max(1.0, float(thr[0])) if len(thr) else 1.0
        thr_a = np.concatenate([thr[::-1], [top]])
        prec_a = np.concatenate([prec[::-1], [1.0]])
        rec_a = np.concatenate([rec[::-1], [0.0]])
        tp_a = np.concatenate([tp[::-1], [0]]).astype(np.int64)
        fp_a = np.concatenate([fp[::-1], [0]]).astype(np.int64)
        fn_a = (pos - tp_a).astype(np.int64)
        return PrecisionRecallCurve(thr_a, prec_a, rec_a, tp_a, fp_a,
                                    fn_a, total)


class ROCMultiClass:
    """One-vs-all ROC per class (reference: ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        for c in range(predictions.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(
                labels[..., c], predictions[..., c], mask)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs.values()]))

    def get_roc_curve(self, cls: int):
        """One-vs-all RocCurve for a class (reference:
        ROCMultiClass.getRocCurve)."""
        return self._rocs[cls].get_roc_curve()

    def get_precision_recall_curve(self, cls: int):
        return self._rocs[cls].get_precision_recall_curve()


class EvaluationBinary:
    """Per-output binary metrics for multi-label sigmoid outputs
    (reference: EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._tp = None
        self._fp = None
        self._tn = None
        self._fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels) > 0.5
        preds = np.asarray(predictions) > self.threshold
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            preds = preds.reshape(-1, preds.shape[-1])
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, preds = labels[m], preds[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        if self._tp is None:
            c = labels.shape[-1]
            self._tp = np.zeros(c, np.int64)
            self._fp = np.zeros(c, np.int64)
            self._tn = np.zeros(c, np.int64)
            self._fn = np.zeros(c, np.int64)
        self._tp += (labels & preds).sum(axis=0)
        self._fp += (~labels & preds).sum(axis=0)
        self._tn += (~labels & ~preds).sum(axis=0)
        self._fn += (labels & ~preds).sum(axis=0)

    def accuracy(self, col: int = 0) -> float:
        total = self._tp[col] + self._fp[col] + self._tn[col] + self._fn[col]
        return float((self._tp[col] + self._tn[col]) / max(total, 1))

    def precision(self, col: int = 0) -> float:
        d = self._tp[col] + self._fp[col]
        return float(self._tp[col] / d) if d else 0.0

    def recall(self, col: int = 0) -> float:
        d = self._tp[col] + self._fn[col]
        return float(self._tp[col] / d) if d else 0.0

    def f1(self, col: int = 0) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


class ROCBinary:
    """Per-output ROC for multi-label binary outputs
    (reference: ROCBinary.java) — one ROC per output column."""

    def __init__(self):
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(
                labels[..., c], predictions[..., c], mask)

    def calculate_auc(self, col: int = 0) -> float:
        return self._rocs[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc()
                              for r in self._rocs.values()]))

    def get_roc_curve(self, col: int = 0):
        """Per-output RocCurve (reference: ROCBinary.getRocCurve)."""
        return self._rocs[col].get_roc_curve()

    def get_precision_recall_curve(self, col: int = 0):
        return self._rocs[col].get_precision_recall_curve()


class EvaluationCalibration:
    """Reliability diagram + histograms of residuals/probabilities
    (reference: EvaluationCalibration.java)."""

    def __init__(self, reliability_bins: int = 10,
                 histogram_bins: int = 50):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._probs: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(predictions, np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        self._labels.append(labels)
        self._probs.append(preds)

    def _flat(self):
        if not self._labels:          # nothing eval'd yet: empty curves,
            z = np.zeros(0)           # not a concatenate ValueError
            return z, z
        y = np.concatenate(self._labels).reshape(-1)
        p = np.concatenate(self._probs).reshape(-1)
        return y, p

    def reliability_diagram(self):
        """Returns (bin_centers, mean_predicted, fraction_positive,
        counts) over equal-width probability bins."""
        y, p = self._flat()
        edges = np.linspace(0.0, 1.0, self.reliability_bins + 1)
        idx = np.clip(np.digitize(p, edges) - 1, 0,
                      self.reliability_bins - 1)
        centers = (edges[:-1] + edges[1:]) / 2
        mean_p = np.zeros(self.reliability_bins)
        frac_pos = np.zeros(self.reliability_bins)
        counts = np.zeros(self.reliability_bins, np.int64)
        for b in range(self.reliability_bins):
            sel = idx == b
            counts[b] = sel.sum()
            if counts[b]:
                mean_p[b] = p[sel].mean()
                frac_pos[b] = y[sel].mean()
        return centers, mean_p, frac_pos, counts

    def expected_calibration_error(self) -> float:
        _, mean_p, frac_pos, counts = self.reliability_diagram()
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(mean_p - frac_pos)))

    def residual_histogram(self):
        y, p = self._flat()
        return np.histogram(np.abs(y - p), bins=self.histogram_bins,
                            range=(0.0, 1.0))

    def probability_histogram(self):
        _, p = self._flat()
        return np.histogram(p, bins=self.histogram_bins, range=(0.0, 1.0))

    # ---- curve exports (reference: EvaluationCalibration
    # .getReliabilityDiagram / getResidualPlot / getProbabilityHistogram
    # returning eval/curves objects) -------------------------------------
    def get_reliability_diagram(self):
        """ReliabilityDiagram export (reference:
        EvaluationCalibration.getReliabilityDiagram). Empty bins are
        dropped, like the reference's count-filtered output."""
        from deeplearning4j_tpu_torch.evaluation.curves import (
            ReliabilityDiagram)
        _, mean_p, frac_pos, counts = self.reliability_diagram()
        keep = counts > 0
        return ReliabilityDiagram("Reliability Diagram",
                                  mean_p[keep], frac_pos[keep])

    def get_residual_histogram(self):
        from deeplearning4j_tpu_torch.evaluation.curves import Histogram
        counts, _edges = self.residual_histogram()
        return Histogram("Residual Plot - |label - P(class)|", 0.0, 1.0,
                         counts)

    def get_probability_histogram(self):
        from deeplearning4j_tpu_torch.evaluation.curves import Histogram
        counts, _edges = self.probability_histogram()
        return Histogram("Predicted Probabilities", 0.0, 1.0, counts)


class ConfusionMatrix:
    """Standalone confusion-matrix accumulator
    (reference: ConfusionMatrix.java). ``Evaluation`` embeds the same
    counts; this is the independently-usable variant."""

    def __init__(self, classes: Optional[List] = None):
        self.classes = list(classes) if classes is not None else None
        self._counts: Dict[tuple, int] = {}

    def add(self, actual, predicted, count: int = 1):
        self._counts[(actual, predicted)] = \
            self._counts.get((actual, predicted), 0) + count

    def add_all(self, other: "ConfusionMatrix"):
        for k, v in other._counts.items():
            self._counts[k] = self._counts.get(k, 0) + v

    def get_count(self, actual, predicted) -> int:
        return self._counts.get((actual, predicted), 0)

    def actual_total(self, actual) -> int:
        return sum(v for (a, _), v in self._counts.items() if a == actual)

    def predicted_total(self, predicted) -> int:
        return sum(v for (_, p), v in self._counts.items()
                   if p == predicted)

    def to_array(self) -> np.ndarray:
        cls = self.classes
        seen = sorted({c for k in self._counts for c in k})
        if cls is None:
            cls = seen
        else:
            # labels recorded outside the declared class list still get a
            # row/column instead of a KeyError
            cls = cls + [c for c in seen if c not in cls]
        n = len(cls)
        arr = np.zeros((n, n), np.int64)
        index = {c: i for i, c in enumerate(cls)}
        for (a, p), v in self._counts.items():
            arr[index[a], index[p]] = v
        return arr
