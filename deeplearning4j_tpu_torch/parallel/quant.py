"""Post-training int8 quantization for serving: precision policy,
feeder-driven calibration, and the quantized inference builder.

The port of the JAX package's ``parallel/quant.py``. ``ops/quantize.py``
holds the numeric primitives; this module turns a trained
MultiLayerNetwork into a quantized ``build_inference_fn`` variant the
ServingEngine commits like any other:

1. **PrecisionPolicy** names the serving precision of a model (f32, bf16
   or int8) and carries the int8 calibration recipe (method, sample
   stream, error budget).
2. **calibrate()** streams the policy's sample batches through the
   port's DeviceFeeder once, running the model's inference walk with a
   tap that reads the absmax of every quantizable layer's input. Scales
   are reduced host-side in float32 numpy, so the same sample stream
   gives the same scales and ``CalibrationResult.hash()`` in every
   process. The hash payload is built as the JAX package builds it; the
   two packages' hashes agree where their scales agree bit for bit (the
   first layer's, whose input is the raw features; later layers see
   activations that torch and XLA compute a few ulps apart).
3. **quantize_model()** quantizes per-channel symmetric int8 weights,
   probes each layer's observed quantization error against the policy
   budget (layers that blow the budget stay f32: per-layer fallback),
   and returns a QuantizedModel whose ``build_inference_fn`` replays the
   model's inference layer walk with int8 substitutions. With no layer
   quantized the walk is the f32 builder's, op for op.

Only layers whose forward IS the dense matmul (DenseLayer and
subclasses that inherit its ``apply`` unchanged: OutputLayer,
RnnOutputLayer, ...) or the plain 2D convolution (exactly
ConvolutionLayer) are candidates; everything else (LSTM, pooling,
preprocessors, ...) runs f32 unchanged, so an int8 TextGenerationLSTM
still runs its LSTMs through the ``lstm_fwd`` kernel.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.base import cast_params, compute_cast
from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.ops import quantize as qz
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves

_MODES = ("f32", "bf16", "int8")
_CALIBRATIONS = ("absmax", "percentile")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-model serving precision. ``f32``/``bf16`` need no extras;
    ``int8`` carries the calibration recipe:

    - ``calibration``: "absmax" (max over every calibration batch) or
      "percentile" (the given percentile of per-batch absmaxima; clips
      rare outliers for tighter scales)
    - ``samples``: the calibration stream: an (N, ...) feature array, an
      iterable of feature arrays, or an iterable of DataSets (a
      DataSetIterator works as-is); batches stream through DeviceFeeder
    - ``error_budget``: max per-layer relative L2 error vs f32 before
      that layer falls back to f32
    """
    mode: str = "f32"
    calibration: str = "absmax"
    percentile: float = 99.9
    calib_batch_size: int = 32
    max_calib_batches: int = 16
    error_budget: float = 0.05
    samples: Any = dataclasses.field(default=None, repr=False,
                                     compare=False)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.calibration not in _CALIBRATIONS:
            raise ValueError(f"calibration must be one of {_CALIBRATIONS},"
                             f" got {self.calibration!r}")
        if not 0 < self.percentile <= 100:
            raise ValueError("percentile must be in (0, 100]")
        if self.calib_batch_size < 1 or self.max_calib_batches < 1:
            raise ValueError("calib_batch_size and max_calib_batches "
                             "must be >= 1")

    @property
    def tag(self) -> str:
        """The precision label used in metrics and stats."""
        return self.mode

    @classmethod
    def f32(cls) -> "PrecisionPolicy":
        return cls(mode="f32")

    @classmethod
    def bf16(cls) -> "PrecisionPolicy":
        return cls(mode="bf16")

    @classmethod
    def int8(cls, samples, **kw) -> "PrecisionPolicy":
        return cls(mode="int8", samples=samples, **kw)


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Per-layer static activation scales from one calibration pass.
    ``hash()`` is the provenance key: identical sample streams give
    identical hashes (scales are reduced in host f32)."""
    method: str
    percentile: float
    n_batches: int
    amax: Dict[str, float]           # calibrated |x| bound per layer input
    scales: Dict[str, float]         # activation scale per layer

    def hash(self) -> str:
        # float.hex() round-trips exactly: the hash changes iff a scale's
        # bits change (the JAX package's payload, key for key)
        payload = {
            "method": self.method,
            "percentile": float(np.float32(self.percentile)).hex(),
            "n_batches": self.n_batches,
            "scales": {k: float(np.float32(v)).hex()
                       for k, v in sorted(self.scales.items())},
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()


class QuantizationError(ValueError):
    pass


# ---- layer classification ------------------------------------------------

def _dense_like(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    return (isinstance(layer, DenseLayer)
            and type(layer).apply is DenseLayer.apply)


def _conv_like(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.convolution import \
        ConvolutionLayer
    return type(layer) is ConvolutionLayer


def _quant_kind(layer) -> Optional[str]:
    if _dense_like(layer):
        return "dense"
    if _conv_like(layer):
        return "conv"
    return None


def _quant_apply(layer, kind: str) -> Callable:
    """The int8 substitute for one layer's f32 ``apply`` (inference only:
    no dropout, no state)."""
    if kind == "dense":
        def run(lp, x):
            y = qz.int8_dot(x, lp["W_q"], lp["w_scale"], lp["x_scale"])
            if layer.has_bias:
                y = y + lp["b"]
            return layer.activation.apply(y)
        return run
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionMode, _pair)
    s, d, p = map(_pair, (layer.stride, layer.dilation, layer.padding))
    padding = ("SAME" if layer.convolution_mode is ConvolutionMode.SAME
               else ((p[0], p[0]), (p[1], p[1])))

    def run(lp, x):
        y = qz.int8_conv(x, lp["W_q"], lp["w_scale"], lp["x_scale"],
                         window_strides=s, padding=padding,
                         rhs_dilation=d, feature_group_count=layer.groups)
        if layer.has_bias:
            y = y + lp["b"]
        return layer.activation.apply(y)
    return run


def _require_mln(model):
    if not (hasattr(model, "layers") and hasattr(model, "_forward")
            and hasattr(model, "_preprocessors")):
        raise QuantizationError(
            "int8 quantization currently supports MultiLayerNetwork "
            f"only (got {type(model).__name__}); ComputationGraph "
            "models must serve at f32/bf16")


# ---- the shared inference layer walk -------------------------------------

def _inference_walk(model, params, model_state, x, fmask,
                    qmap: Dict[str, Callable]):
    """Replays the model's ``build_inference_fn`` walk (models/
    multi_layer_network.py): ``_forward(..., train=False, upto=n-1)``,
    then the output layer with mask=fmask, substituting ``qmap``
    entries. With an empty qmap it is the f32 builder, op for op."""
    g = model.conf.global_config
    with torch.inference_mode():
        x = compute_cast(x, g.compute_dtype)
        n = len(model.layers)
        for i in range(n):
            layer = model.layers[i]
            pp = model._preprocessors.get(i)
            if pp is not None:
                x = pp.apply(x)
            last = i == n - 1
            mask = fmask if (last or isinstance(model._input_types[i],
                                                RecurrentType)) else None
            ctx = LayerContext(train=False, mask=mask)
            run = qmap.get(layer.name)
            lp = params.get(layer.name, {})
            if run is not None:
                x = run(lp, x)
                continue
            lp = cast_params(lp, g.compute_dtype)
            if not last:
                # the same (no-op at inference) weight-noise hook as
                # _forward
                lp = layer.apply_weight_noise(lp, ctx)
            x, _ = layer.apply(lp, model_state.get(layer.name, {}), x, ctx)
    return x


# ---- calibration ---------------------------------------------------------

def _calib_batches(policy: PrecisionPolicy) -> List[Any]:
    """The policy's sample stream as a bounded list of host DataSets
    (max_calib_batches x calib_batch_size)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    src = policy.samples
    if src is None:
        raise QuantizationError(
            "PrecisionPolicy(mode='int8') needs calibration samples "
            "(PrecisionPolicy.int8(samples=...))")
    out: List[Any] = []
    if isinstance(src, np.ndarray) or hasattr(src, "shape"):
        arr = np.asarray(src)
        b = min(policy.calib_batch_size, arr.shape[0])
        for i in range(0, arr.shape[0] - b + 1, b):
            out.append(DataSet(np.ascontiguousarray(arr[i:i + b])))
            if len(out) >= policy.max_calib_batches:
                break
    else:
        for item in src:
            if isinstance(item, DataSet):
                out.append(item)
            else:
                out.append(DataSet(np.asarray(item)))
            if len(out) >= policy.max_calib_batches:
                break
    if not out:
        raise QuantizationError("calibration sample stream is empty")
    return out


def _layer_by_name(model, name):
    for l in model.layers:
        if l.name == name:
            return l
    raise KeyError(name)


def _tapped_apply(layer, lp, x):
    """The layer's own f32 apply under an inference context: the
    calibration substitute runs the same math as the f32 walk."""
    y, _ = layer.apply(lp, {}, x, LayerContext(train=False))
    return y


def calibrate(model, policy: PrecisionPolicy, *, registry=None,
              tracer=None) -> CalibrationResult:
    """One pass through the DeviceFeeder over the policy's sample
    stream, collecting each quantizable layer's input absmax (one host
    fetch a batch); scales reduce host-side in f32."""
    from deeplearning4j_tpu_torch.datasets.feeder import DeviceFeeder
    _require_mln(model)
    if model.params is None:
        model.init()
    names = [l.name for l in model.layers if _quant_kind(l)]
    if not names:
        raise QuantizationError(
            f"{type(model).__name__} has no quantizable (dense/conv) "
            "layers")
    batches = _calib_batches(policy)
    params, mstate = model.params, model.model_state
    g = model.conf.global_config

    def stats(x):
        taps: Dict[str, torch.Tensor] = {}
        qmap: Dict[str, Callable] = {}
        for nm in names:
            def run(lp, h, _layer=_layer_by_name(model, nm), _nm=nm):
                taps[_nm] = h.to(torch.float32).abs().amax()
                return _tapped_apply(_layer, cast_params(
                    lp, g.compute_dtype), h)
            qmap[nm] = run
        _inference_walk(model, params, mstate, x, None, qmap)
        return torch.stack([taps[nm] for nm in names])

    per_batch: List[np.ndarray] = []
    feeder = DeviceFeeder(iter(batches), device=model.device, depth=2,
                          registry=registry, tracer=tracer,
                          session_id="quant-calib")
    for item in feeder:
        item = feeder.hand_off(item)
        per_batch.append(stats(item.features).cpu().numpy()
                         .astype(np.float32))
    m = np.stack(per_batch)                    # (n_batches, n_layers) f32
    if policy.calibration == "percentile" and m.shape[0] > 1:
        col = np.percentile(m, policy.percentile, axis=0,
                            method="linear").astype(np.float32)
    else:
        col = np.max(m, axis=0)
    amax = {n: float(col[i]) for i, n in enumerate(names)}
    scales = {n: float(qz.activation_scale(col[i]))
              for i, n in enumerate(names)}
    return CalibrationResult(method=policy.calibration,
                             percentile=policy.percentile,
                             n_batches=m.shape[0], amax=amax,
                             scales=scales)


# ---- quantization --------------------------------------------------------

@dataclasses.dataclass
class QuantizedModel:
    """A trained model plus its int8 serving artifacts: quantized params,
    calibration, per-layer error report and the quantized inference
    builder."""
    model: Any
    policy: PrecisionPolicy
    calibration: CalibrationResult
    params: Any                       # quantized params (dicts of tensors)
    report: Dict[str, Dict[str, Any]]  # layer -> {kind, error, quantized}
    fallback: List[str]               # layers kept f32 (budget exceeded)

    @property
    def quantized_layers(self) -> List[str]:
        return [n for n, r in self.report.items() if r["quantized"]]

    def calibration_hash(self) -> str:
        """Provenance key: calibration scales + the budget decisions
        baked into the forward."""
        payload = {"calibration": self.calibration.hash(),
                   "error_budget": float(
                       np.float32(self.policy.error_budget)).hex(),
                   "fallback": sorted(self.fallback)}
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()

    def build_inference_fn(self):
        """Quantized ``(params, model_state, x, fmask) -> y``: the same
        contract as the model's own build_inference_fn, against
        ``self.params`` instead of the f32 params."""
        qmap = {n: _quant_apply(_layer_by_name(self.model, n),
                                self.report[n]["kind"])
                for n in self.quantized_layers}
        model = self.model

        def fwd(params, model_state, x, fmask=None):
            return _inference_walk(model, params, model_state, x, fmask,
                                   qmap)
        return fwd


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    num = torch.linalg.vector_norm((a - b).to(torch.float32).ravel())
    den = torch.linalg.vector_norm(b.to(torch.float32).ravel()) + 1e-12
    return float(num / den)


def quantize_model(model, policy: PrecisionPolicy, *, registry=None,
                   tracer=None,
                   calibration: Optional[CalibrationResult] = None
                   ) -> QuantizedModel:
    """Calibrate (unless a result is supplied), quantize per-channel int8
    weights, and probe each candidate layer's quantization error on the
    first calibration batch: the probe walks the net once, feeding every
    layer the activations produced by the already-quantized prefix, so
    each accept/fallback decision sees realistic (error-carrying)
    inputs."""
    _require_mln(model)
    if policy.mode != "int8":
        raise QuantizationError(
            f"quantize_model needs an int8 policy, got {policy.mode!r}")
    if model.params is None:
        model.init()
    calib = calibration if calibration is not None else calibrate(
        model, policy, registry=registry, tracer=tracer)
    params, mstate = model.params, model.model_state
    dev = model.device
    probe = np.asarray(_calib_batches(policy)[0].features)

    g = model.conf.global_config
    n = len(model.layers)
    params_q: Dict[str, Any] = {}
    report: Dict[str, Dict[str, Any]] = {}
    fallback: List[str] = []
    with torch.inference_mode():
        x = compute_cast(torch.as_tensor(probe, device=dev),
                         g.compute_dtype)
        for i in range(n):
            layer = model.layers[i]
            pp = model._preprocessors.get(i)
            if pp is not None:
                x = pp.apply(x)
            last = i == n - 1
            ctx = LayerContext(train=False)        # the probe is unmasked
            lp = params.get(layer.name, {})
            kind = _quant_kind(layer)
            if kind is None or layer.name not in calib.scales:
                params_q[layer.name] = lp
                x, _ = layer.apply(
                    lp if last else cast_params(lp, g.compute_dtype),
                    mstate.get(layer.name, {}), x, ctx)
                continue
            w = lp["W"].detach().to("cpu", torch.float32).numpy()
            w_q, w_scale = qz.quantize_weight(w)
            lq = {"W_q": torch.as_tensor(w_q, device=dev),
                  "w_scale": torch.as_tensor(w_scale, device=dev),
                  "x_scale": torch.as_tensor(
                      np.float32(calib.scales[layer.name]), device=dev)}
            if layer.has_bias and "b" in lp:
                lq["b"] = lp["b"].detach().to(torch.float32).clone()
            y_f, _ = layer.apply(lp, mstate.get(layer.name, {}), x, ctx)
            y_q = _quant_apply(layer, kind)(lq, x)
            err = _rel_l2(y_q, y_f)
            ok = err <= policy.error_budget
            report[layer.name] = {"kind": kind, "error": err,
                                  "quantized": ok}
            if ok:
                params_q[layer.name] = lq
                x = y_q
            else:
                params_q[layer.name] = lp
                fallback.append(layer.name)
                x = y_f
    return QuantizedModel(model=model, policy=policy, calibration=calib,
                          params=params_q, report=report,
                          fallback=fallback)


def params_nbytes(params) -> int:
    """Total bytes of a committed params tree: the params-resident term
    of the serving $/req proxy (int8 entries are ~1/4 of f32)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
