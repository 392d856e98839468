"""Serializable evaluation-curve exports (a copy of the JAX package's
``evaluation/curves.py``, numpy only).

Analogs of the reference's ``eval/curves`` package
(deeplearning4j-nn/.../eval/curves/): ``RocCurve`` (RocCurve.java),
``PrecisionRecallCurve`` (PrecisionRecallCurve.java),
``ReliabilityDiagram`` (ReliabilityDiagram.java) and ``Histogram``
(Histogram.java) — point-list objects the UI charts consume, with JSON
round-trip like the reference's Jackson serde (BaseCurve.java:toJson).

Produced by ``ROC.get_roc_curve()`` / ``ROC.get_precision_recall_curve()``
and ``EvaluationCalibration.get_reliability_diagram()`` /
``get_*_histogram()``; rendered by the dashboard's Evaluation tab
(ui/server.py) via ``UIServer.upload_evaluation``.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np


def _area(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under (x, y) — reference: BaseCurve.calculateArea
    (BaseCurve.java:48)."""
    if len(x) < 2:
        return 0.0
    return float(abs(np.trapezoid(y, x)))


class _JsonSerde:
    """Shared dict<->JSON surface (reference: BaseCurve.toJson /
    BaseHistogram.toJson)."""

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


class BaseCurve(_JsonSerde):
    """Common x/y + area surface (reference: BaseCurve.java)."""

    def num_points(self) -> int:
        return len(self.get_x())

    def get_x(self) -> np.ndarray:
        raise NotImplementedError

    def get_y(self) -> np.ndarray:
        raise NotImplementedError

    def calculate_area(self) -> float:
        return _area(self.get_x(), self.get_y())


class RocCurve(BaseCurve):
    """(threshold, fpr, tpr) point lists (reference: RocCurve.java:15).
    x = false positive rate, y = true positive rate."""

    def __init__(self, threshold: Sequence[float], fpr: Sequence[float],
                 tpr: Sequence[float]):
        self.threshold = np.asarray(threshold, np.float64)
        self.fpr = np.asarray(fpr, np.float64)
        self.tpr = np.asarray(tpr, np.float64)
        if not (len(self.threshold) == len(self.fpr) == len(self.tpr)):
            raise ValueError("threshold/fpr/tpr lengths differ")

    def get_x(self) -> np.ndarray:
        return self.fpr

    def get_y(self) -> np.ndarray:
        return self.tpr

    def get_threshold(self, i: int) -> float:
        return float(self.threshold[i])

    def get_true_positive_rate(self, i: int) -> float:
        return float(self.tpr[i])

    def get_false_positive_rate(self, i: int) -> float:
        return float(self.fpr[i])

    def calculate_auc(self) -> float:
        return self.calculate_area()

    @property
    def title(self) -> str:
        return f"ROC (Area={self.calculate_auc():.4f})"

    def to_dict(self) -> dict:
        return {"@type": "RocCurve",
                "threshold": self.threshold.tolist(),
                "fpr": self.fpr.tolist(), "tpr": self.tpr.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "RocCurve":
        return cls(d["threshold"], d["fpr"], d["tpr"])


class PrecisionRecallCurve(BaseCurve):
    """(threshold, precision, recall) + per-point tp/fp/fn counts
    (reference: PrecisionRecallCurve.java:18). x = recall,
    y = precision."""

    def __init__(self, threshold, precision, recall, tp_count=None,
                 fp_count=None, fn_count=None, total_count: int = 0):
        self.threshold = np.asarray(threshold, np.float64)
        self.precision = np.asarray(precision, np.float64)
        self.recall = np.asarray(recall, np.float64)
        n = len(self.threshold)
        z = np.zeros(n, np.int64)
        self.tp_count = (np.asarray(tp_count, np.int64)
                         if tp_count is not None else z.copy())
        self.fp_count = (np.asarray(fp_count, np.int64)
                         if fp_count is not None else z.copy())
        self.fn_count = (np.asarray(fn_count, np.int64)
                         if fn_count is not None else z.copy())
        self.total_count = int(total_count)
        if not (n == len(self.precision) == len(self.recall)
                == len(self.tp_count) == len(self.fp_count)
                == len(self.fn_count)):
            raise ValueError("PR-curve arrays have differing lengths")

    def get_x(self) -> np.ndarray:
        return self.recall

    def get_y(self) -> np.ndarray:
        return self.precision

    def get_threshold(self, i: int) -> float:
        return float(self.threshold[i])

    def get_precision(self, i: int) -> float:
        return float(self.precision[i])

    def get_recall(self, i: int) -> float:
        return float(self.recall[i])

    def calculate_auprc(self) -> float:
        return self.calculate_area()

    def get_point_at_threshold(self, threshold: float):
        """(threshold, precision, recall) at the smallest curve
        threshold >= the requested one (reference:
        PrecisionRecallCurve.getPointAtThreshold)."""
        idx = int(np.searchsorted(self.threshold, threshold, "left"))
        idx = min(idx, len(self.threshold) - 1)
        return (float(self.threshold[idx]), float(self.precision[idx]),
                float(self.recall[idx]))

    def get_point_at_precision(self, precision: float):
        """First point (lowest threshold) with precision >= the given
        value (reference: getPointAtPrecision)."""
        ok = np.nonzero(self.precision >= precision)[0]
        idx = int(ok[0]) if len(ok) else len(self.threshold) - 1
        return (float(self.threshold[idx]), float(self.precision[idx]),
                float(self.recall[idx]))

    def get_point_at_recall(self, recall: float):
        """Point with the HIGHEST precision among those with
        recall >= the given value (reference: getPointAtRecall)."""
        ok = np.nonzero(self.recall >= recall)[0]
        if len(ok):
            idx = int(ok[np.argmax(self.precision[ok])])
        else:
            idx = 0
        return (float(self.threshold[idx]), float(self.precision[idx]),
                float(self.recall[idx]))

    @property
    def title(self) -> str:
        return (f"Precision-Recall Curve (Area="
                f"{self.calculate_auprc():.4f})")

    def to_dict(self) -> dict:
        return {"@type": "PrecisionRecallCurve",
                "threshold": self.threshold.tolist(),
                "precision": self.precision.tolist(),
                "recall": self.recall.tolist(),
                "tpCount": self.tp_count.tolist(),
                "fpCount": self.fp_count.tolist(),
                "fnCount": self.fn_count.tolist(),
                "totalCount": self.total_count}

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionRecallCurve":
        return cls(d["threshold"], d["precision"], d["recall"],
                   d.get("tpCount"), d.get("fpCount"), d.get("fnCount"),
                   d.get("totalCount", 0))


class ReliabilityDiagram(_JsonSerde):
    """Mean-predicted vs fraction-positive per probability bin
    (reference: ReliabilityDiagram.java:14)."""

    def __init__(self, title: str, mean_predicted_value,
                 fraction_positives):
        self.title = title
        self.mean_predicted_value = np.asarray(mean_predicted_value,
                                               np.float64)
        self.fraction_positives = np.asarray(fraction_positives,
                                             np.float64)
        if len(self.mean_predicted_value) != len(self.fraction_positives):
            raise ValueError("mean_predicted/fraction_positives lengths "
                             "differ")

    def get_x(self) -> np.ndarray:
        return self.mean_predicted_value

    def get_y(self) -> np.ndarray:
        return self.fraction_positives

    def num_points(self) -> int:
        return len(self.mean_predicted_value)

    def to_dict(self) -> dict:
        return {"@type": "ReliabilityDiagram", "title": self.title,
                "meanPredictedValueX": self.mean_predicted_value.tolist(),
                "fractionPositivesY": self.fraction_positives.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "ReliabilityDiagram":
        return cls(d.get("title", ""), d["meanPredictedValueX"],
                   d["fractionPositivesY"])


class Histogram(_JsonSerde):
    """Equal-width histogram export (reference: Histogram.java:14 —
    title, lower/upper bound, bin counts)."""

    def __init__(self, title: str, lower: float, upper: float,
                 bin_counts):
        self.title = title
        self.lower = float(lower)
        self.upper = float(upper)
        self.bin_counts = np.asarray(bin_counts, np.int64)

    @property
    def n_bins(self) -> int:
        return len(self.bin_counts)

    def get_bin_lower_bounds(self) -> np.ndarray:
        return (self.lower + (self.upper - self.lower)
                * np.arange(self.n_bins) / self.n_bins)

    def get_bin_upper_bounds(self) -> np.ndarray:
        return (self.lower + (self.upper - self.lower)
                * np.arange(1, self.n_bins + 1) / self.n_bins)

    def get_bin_mid_values(self) -> np.ndarray:
        return (self.get_bin_lower_bounds()
                + self.get_bin_upper_bounds()) / 2

    def to_dict(self) -> dict:
        return {"@type": "Histogram", "title": self.title,
                "lower": self.lower, "upper": self.upper,
                "binCounts": self.bin_counts.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        return cls(d.get("title", ""), d["lower"], d["upper"],
                   d["binCounts"])


def from_json(s: str):
    """Polymorphic decode on the ``@type`` tag (reference:
    BaseCurve.fromJson dispatch)."""
    d = json.loads(s)
    t = d.get("@type")
    for cls in (RocCurve, PrecisionRecallCurve, ReliabilityDiagram,
                Histogram):
        if t == cls.__name__:
            return cls.from_dict(d)
    raise ValueError(f"unknown curve type {t!r}")
