"""Accuracy gate for int8 serving: quantized vs f32, budgeted.

From the JAX package's ``evaluation/quant_gate.py``, the result and error
types only (copies): ``GateResult`` scores a quantized head or model
against its f32 self (top-1 agreement, logit deltas, budgets) and
``QuantGateError`` carries a failed result. The generation engine's
decode-level int8 head gate (``generation/decode.py:int8_head_gate``)
returns and raises them. ``QuantGate``, ``run_quant_gate`` and
``enforce_quant_gate`` build on ``parallel/quant.py`` and are not ported
yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class GateResult:
    model: str
    n_examples: int
    n_positions: int                 # argmax comparisons (N or N*T)
    top1_agreement: float
    top1_delta: float
    max_logit_delta: float
    mean_logit_delta: float
    top1_budget: float
    logit_budget: Optional[float]
    layer_errors: Dict[str, float]
    fallback: List[str]
    passed: bool

    def summary(self) -> str:
        verdict = "PASS" if self.passed else "FAIL"
        lb = ("-" if self.logit_budget is None
              else f"{self.logit_budget:g}")
        return (f"[{verdict}] {self.model}: top1_delta "
                f"{self.top1_delta:.4f} (budget {self.top1_budget:g}) "
                f"max|dy| {self.max_logit_delta:.4f} (budget {lb}) "
                f"over {self.n_examples} examples; "
                f"fallback={self.fallback or 'none'}")


class QuantGateError(RuntimeError):
    """A quantized model failed its accuracy budget. Carries the
    ``GateResult`` so the caller (and the swap-path log) can show the
    exact deltas."""

    def __init__(self, result: GateResult):
        super().__init__(result.summary())
        self.result = result
