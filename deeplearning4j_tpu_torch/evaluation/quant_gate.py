"""Accuracy gate for int8 serving: quantized vs f32, budgeted.

The port of the JAX package's ``evaluation/quant_gate.py``. A quantized
model is only a win if it answers the same. This harness runs a
quantized build (parallel/quant.py) and the f32 reference over the same
evaluation stream and scores:

- **top-1 agreement**: the fraction of examples (or (example, timestep)
  positions for sequence outputs) whose argmax class matches f32;
  ``top1_delta = 1 - agreement`` must stay within ``top1_budget``
- **output delta**: max / mean absolute difference of the final
  (post-activation) output vector, bounded by ``logit_budget``

``enforce_quant_gate`` is the hard form: it raises ``QuantGateError`` on
a failed budget, and the FleetRouter calls it before a quantized
version's engines are built (parallel/fleet.py). The generation engine's
decode-level int8 head gate (``generation/decode.py:int8_head_gate``)
returns and raises the same result and error types.

``zoo_gate_cases()`` gives the committed pretrained zoo models with
deterministic evaluation streams, the JAX package's cases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.parallel.quant import (PrecisionPolicy,
                                                     QuantizedModel,
                                                     _calib_batches,
                                                     quantize_model)
from deeplearning4j_tpu_torch.utils.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class QuantGate:
    """Budgets + evaluation stream for one gate run. ``samples`` (an
    (N, ...) feature array, iterable of arrays, or DataSets) defaults to
    the policy's calibration stream when omitted: fine for smoke gates,
    but a real rollout should hold out separate eval data."""
    top1_budget: float = 0.02
    logit_budget: Optional[float] = 0.25
    samples: Any = dataclasses.field(default=None, repr=False,
                                     compare=False)
    batch_size: int = 64
    max_batches: int = 16


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


def run_quant_gate(model, policy: PrecisionPolicy,
                   gate: Optional[QuantGate] = None, *,
                   model_name: Optional[str] = None,
                   quantized: Optional[QuantizedModel] = None,
                   registry=None) -> GateResult:
    """Score a quantized build against its f32 self; never raises on a
    failed budget (``passed`` records it); ``enforce_quant_gate`` is the
    hard form. Pass ``quantized`` to reuse an existing build."""
    gate = gate if gate is not None else QuantGate()
    qm = quantized if quantized is not None else quantize_model(
        model, policy, registry=registry)
    eval_policy = policy if gate.samples is None else \
        dataclasses.replace(policy, samples=gate.samples,
                            calib_batch_size=gate.batch_size,
                            max_calib_batches=gate.max_batches)
    batches = _calib_batches(eval_policy)
    fwd_q = qm.build_inference_fn()
    fwd_f = model.build_inference_fn()
    mstate = model.model_state
    n_examples = n_pos = n_agree = 0
    max_d = 0.0
    sum_d = 0.0
    sum_n = 0
    for b in batches:
        x = model._as_tensor(b.features)
        y_f = fwd_f(model.params, mstate, x).float().cpu().numpy()
        y_q = fwd_q(qm.params, mstate, x).float().cpu().numpy()
        d = np.abs(y_q - y_f)
        max_d = max(max_d, float(d.max()))
        sum_d += float(d.sum())
        sum_n += d.size
        a_f = y_f.argmax(axis=-1).reshape(-1)
        a_q = y_q.argmax(axis=-1).reshape(-1)
        n_agree += int((a_f == a_q).sum())
        n_pos += a_f.size
        n_examples += int(np.shape(b.features)[0])
    agreement = n_agree / max(n_pos, 1)
    top1_delta = 1.0 - agreement
    passed = top1_delta <= gate.top1_budget and (
        gate.logit_budget is None or max_d <= gate.logit_budget)
    return GateResult(
        model=model_name or type(model).__name__,
        n_examples=n_examples, n_positions=n_pos,
        top1_agreement=agreement, top1_delta=top1_delta,
        max_logit_delta=max_d,
        mean_logit_delta=sum_d / max(sum_n, 1),
        top1_budget=gate.top1_budget, logit_budget=gate.logit_budget,
        layer_errors={n: r["error"] for n, r in qm.report.items()},
        fallback=list(qm.fallback), passed=passed)


def enforce_quant_gate(model, policy: PrecisionPolicy,
                       gate: Optional[QuantGate] = None, *,
                       model_name: Optional[str] = None,
                       registry=None) -> GateResult:
    """The hard gate: raise ``QuantGateError`` when the budget fails."""
    result = run_quant_gate(model, policy, gate, model_name=model_name,
                            registry=registry)
    if not result.passed:
        raise QuantGateError(result)
    return result


# ---- committed zoo-weight cases ------------------------------------------

def zoo_gate_cases(device: DeviceLike = None
                   ) -> List[Tuple[str, Any, np.ndarray]]:
    """(name, pretrained model, deterministic eval features) for every
    committed zoo artifact, restored on ``device`` (the card unless
    ``"cpu"``): LeNet on the digits test split and TextGenerationLSTM on
    96 one-hot character streams of 60 from ``default_rng(1234)``."""
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.zoo.models import LeNet, TextGenerationLSTM
    cases: List[Tuple[str, Any, np.ndarray]] = []

    lenet = LeNet().init_pretrained(flavor="digits", device=device)
    digits, _ = DigitsDataSetIterator.fetch(train=False)
    cases.append(("LeNet", lenet, digits.astype(np.float32)))

    textgen = TextGenerationLSTM().init_pretrained(device=device)
    vocab = textgen.layers[-1].n_out
    t = 60
    rng = np.random.default_rng(1234)
    ids = rng.integers(0, vocab, size=(96, t))
    cases.append(("TextGenerationLSTM", textgen,
                  np.eye(vocab, dtype=np.float32)[ids]))
    return cases


def run_zoo_gates(policy_kwargs: Optional[Dict[str, Any]] = None,
                  gate: Optional[QuantGate] = None,
                  device: DeviceLike = None) -> List[GateResult]:
    """Gate every committed zoo artifact (the acceptance sweep)."""
    out = []
    for name, model, feats in zoo_gate_cases(device):
        policy = PrecisionPolicy.int8(feats, **(policy_kwargs or {}))
        out.append(run_quant_gate(model, policy, gate, model_name=name))
    return out
