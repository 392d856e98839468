"""Simple classification result holders (a copy of the JAX package's
``evaluation/results.py``, numpy only).

Analogs of the reference's ``nn/simple`` result APIs:
- ``RankClassificationResult`` (deeplearning4j-nn/.../nn/simple/multiclass/
  RankClassificationResult.java:1): per-row descending rank of class
  probabilities with optional string labels.
- ``BinaryClassificationResult`` (deeplearning4j-nn/.../nn/simple/binary/
  BinaryClassificationResult.java:1): thresholded binary decisions with
  optional class weights.

Pure-numpy convenience types over model ``output()`` arrays; listed in
SURVEY §2.1 row 30 (previously folded away — VERDICT missing#8).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class RankClassificationResult:
    """Ranks each row's class probabilities in descending order."""

    def __init__(self, outcome, labels: Optional[Sequence[str]] = None):
        outcome = np.asarray(outcome, np.float32)
        if outcome.ndim == 1:
            outcome = outcome[None, :]
        if outcome.ndim != 2:
            raise ValueError(
                f"only vectors and matrices are supported; got rank"
                f" {outcome.ndim}")
        n_classes = outcome.shape[1]
        self.labels: List[str] = (
            [str(i) for i in range(n_classes)] if labels is None
            else [str(l) for l in labels])
        if len(self.labels) != n_classes:
            raise ValueError(f"{len(self.labels)} labels for {n_classes}"
                             " classes")
        # descending sort, ties broken by lower index first (stable)
        self.ranked_indices = np.argsort(-outcome, axis=1,
                                         kind="stable").astype(np.int32)
        self.probabilities = outcome

    def max_outcome_for_row(self, r: int) -> str:
        return self.labels[int(self.ranked_indices[r][0])]

    def max_outcomes(self) -> List[str]:
        return [self.max_outcome_for_row(r)
                for r in range(self.ranked_indices.shape[0])]


class BinaryClassificationResult:
    """Thresholded decisions over positive-class probabilities."""

    def __init__(self, probabilities=None, decision_threshold: float = 0.5,
                 class_weights: Optional[Sequence[float]] = None):
        self.decision_threshold = float(decision_threshold)
        self.class_weights = (None if class_weights is None
                              else np.asarray(class_weights, np.float64))
        self.probabilities = (None if probabilities is None
                              else np.asarray(probabilities, np.float32))

    def decisions(self) -> np.ndarray:
        """0/1 decisions; accepts (N,) positive-class probs or (N, 2)
        softmax outputs (column 1 = positive)."""
        if self.probabilities is None:
            raise ValueError("no probabilities supplied")
        p = self.probabilities
        if p.ndim == 2:
            p = p[:, -1]
        return (p >= self.decision_threshold).astype(np.int32)
