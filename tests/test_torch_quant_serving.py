"""Int8 serving in the port on the CPU: ``ServingEngine(precision=...)``,
the accuracy gate and the fleet's int8 pools (the JAX package's
``tests/test_quantize.py`` engine, gate and zoo cases, run on the
port), plus the committed zoo models served at int8 beside the JAX
package's own int8 engine.

- An int8 engine serves warm, labels its metrics ``precision="int8"``,
  sets ``dl4j_quant_layer_error``, reports its calibration hash in
  ``stats()["quant"]``, keeps fewer resident bytes than f32, accepts the
  mode string, refuses ``swap_params``, and a ComputationGraph raises
  ``QuantizationError``.
- The engine's answers equal the ``QuantizedModel``'s direct walk at the
  bucket shape, bitwise (the port's padded-bucket contract).
- The gate passes and fails by its budgets; in the fleet it blocks a
  swap (the old version goes on answering bitwise, and
  ``dl4j_fleet_quant_gate_total`` counts both outcomes) and is skipped
  for f32 pools. (``run_zoo_gates`` on the committed LeNet and
  TextGenerationLSTM is held against JAX's gate in test_torch_quant.py,
  beside the calibrations it shares.)
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.evaluation.quant_gate import (
    QuantGate, QuantGateError, enforce_quant_gate, run_quant_gate)
from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
from deeplearning4j_tpu_torch.parallel.quant import (PrecisionPolicy,
                                                     QuantizationError,
                                                     params_nbytes,
                                                     quantize_model)
from deeplearning4j_tpu_torch.parallel.serving import ServingEngine

N_IN = 6


def _model(seed: int = 3, width: int = 16, n_out: int = 4):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=width))
            .layer(OutputLayer(n_out=n_out, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _calib(n: int = 64, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, N_IN)).astype(np.float32)


def _engine(model, **kw):
    kw.setdefault("batch_limit", 4)
    kw.setdefault("feature_shape", (N_IN,))
    kw.setdefault("registry", MetricsRegistry())
    return ServingEngine(model, **kw)


def _at_bucket(fn, x, bucket):
    pad = np.concatenate([x, np.repeat(x[-1:], bucket - len(x), 0)])
    return fn(torch.from_numpy(pad)).numpy()[:len(x)]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_int8_serves_warm_with_labelled_metrics():
    m = _model()
    reg = MetricsRegistry()
    with _engine(m, registry=reg, precision=PrecisionPolicy.int8(_calib()),
                 session_id="q8") as eng:
        x = _calib(3, seed=5)
        y = eng.output(x)
        assert np.mean(y.argmax(-1) == m.output(x).numpy().argmax(-1)) \
            >= 0.9
        eng.assert_warm()
        st = eng.stats()
        assert st["precision"] == "int8"
        assert st["quant"]["layers"] and st["quant"]["fallback"] == []
        assert st["quant"]["calibration"] == \
            eng.quantized.calibration_hash()
        assert st["params_resident_bytes"] == eng.params_resident_bytes
    text = reg.render()
    assert 'dl4j_serving_precision{' in text
    assert 'precision="int8"' in text
    assert "dl4j_quant_layer_error{" in text
    assert 'quantized="true"' in text


def test_int8_answers_are_the_quantized_walk_at_the_bucket():
    m = _model()
    with _engine(m, precision=PrecisionPolicy.int8(_calib())) as eng:
        qm = eng.quantized
        fwd = qm.build_inference_fn()
        walk = lambda x: fwd(qm.params, m.model_state, x)
        rng = np.random.default_rng(7)
        for n in (1, 2, 3, 4, 7):
            x = rng.normal(size=(n, N_IN)).astype(np.float32)
            got = eng.output(x)
            want = np.concatenate([
                _at_bucket(walk, x[i:i + 4], eng.bucket_of(len(x[i:i + 4])))
                for i in range(0, n, 4)])
            assert np.array_equal(got, want), n


def test_int8_resident_bytes_below_f32():
    m = _model()
    with _engine(m, precision=PrecisionPolicy.int8(_calib())) as e8, \
            _engine(m) as ef:
        assert e8.params_resident_bytes < ef.params_resident_bytes
        assert e8.params_resident_bytes == params_nbytes(
            e8.quantized.params)
        assert ef.stats()["precision"] == "f32"
        assert "quant" not in ef.stats()


def test_precision_string_accepted():
    with _engine(_model(), precision="bf16", feature_shape=None) as eng:
        assert eng.precision == "bf16" and eng.policy.mode == "bf16"
    with pytest.raises(QuantizationError, match="samples"):
        _engine(_model(), precision="int8")
    with pytest.raises(ValueError, match="mode"):
        _engine(_model(), precision="fp8")


def test_int8_engine_refuses_param_swap():
    m = _model()
    with _engine(m, precision=PrecisionPolicy.int8(_calib())) as eng:
        with pytest.raises(ValueError, match="int8 engines"):
            eng.swap_params(m.params)


def test_computation_graph_raises_quantization_error():
    from test_torch_fit_loop import _graph_pair
    cg, _ = _graph_pair()
    with pytest.raises(QuantizationError, match="ComputationGraph"):
        ServingEngine(cg, batch_limit=2, warmup=False,
                      precision=PrecisionPolicy.int8(np.zeros((4, 3))))


# ---------------------------------------------------------------------------
# the gate and the fleet
# ---------------------------------------------------------------------------

def test_gate_pass_and_fail_shapes():
    m = _model()
    pol = PrecisionPolicy.int8(_calib())
    ok = run_quant_gate(m, pol, QuantGate(top1_budget=0.5))
    assert ok.passed and ok.n_examples > 0
    assert "PASS" in ok.summary()
    with pytest.raises(QuantGateError) as ei:
        enforce_quant_gate(m, pol, QuantGate(top1_budget=-1.0))
    assert not ei.value.result.passed
    assert "FAIL" in str(ei.value)


def test_fleet_gate_blocks_swap_keeps_serving():
    feats = _calib()
    router = FleetRouter(session_id="quant-gate-t", registry=MetricsRegistry(),
                         window_s=10.0)
    try:
        pool = router.add_pool(
            "m", _model(), version="v1",
            precision=PrecisionPolicy.int8(feats),
            quant_gate=QuantGate(top1_budget=0.5, samples=feats),
            feature_shape=(N_IN,), batch_limit=4)
        assert pool.gate_results and pool.gate_results[-1].passed
        st = router.stats()["pools"]["m"]
        assert st["engines"][0]["precision"] == "int8"
        assert "PASS" in st["quant_gate"]
        y1 = router.output(feats[:2], model="m")
        # an impossible budget: the swap raises before any engine exists
        # and v1 keeps answering
        pool.quant_gate = QuantGate(top1_budget=0.0, logit_budget=1e-9,
                                    samples=feats)
        with pytest.raises(QuantGateError):
            router.swap("m", _model(seed=8), "v2")
        assert pool.active_version == "v1"
        assert np.array_equal(router.output(feats[:2], model="m"), y1)
        text = router.registry.render()
        assert 'dl4j_fleet_quant_gate_total{model="m",' \
               'outcome="fail"} 1.0' in text
        assert 'outcome="pass"} 1.0' in text
    finally:
        router.shutdown()


def test_fleet_gate_admits_a_passing_swap():
    feats = _calib()
    router = FleetRouter(session_id="quant-gate-ok",
                         registry=MetricsRegistry(), window_s=10.0)
    try:
        pool = router.add_pool(
            "m", _model(), precision=PrecisionPolicy.int8(feats),
            quant_gate=QuantGate(top1_budget=0.5, samples=feats),
            feature_shape=(N_IN,), batch_limit=4)
        router.swap("m", _model(seed=8), "v2")
        assert pool.active_version == "v2" and len(pool.gate_results) == 2
        router.rollback("m")
        assert pool.active_version == "v1"
    finally:
        router.shutdown()


def test_gate_skipped_for_f32_pool():
    router = FleetRouter(session_id="quant-gate-f32",
                         registry=MetricsRegistry(), window_s=10.0)
    try:
        pool = router.add_pool(
            "m", _model(), quant_gate=QuantGate(top1_budget=-1.0),
            feature_shape=(N_IN,), batch_limit=4)
        assert pool.gate_results == []      # gate not applicable
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# the committed zoo models
# ---------------------------------------------------------------------------

def test_zoo_models_served_at_int8_as_jax_serves_them():
    """The committed LeNet behind an int8 engine in each package, on the
    same digits: top-1 equal on >= 99% of rows, and every probability
    within the step bound of the quantized head (test_torch_quant)."""
    import jax  # noqa: F401
    from deeplearning4j_tpu.evaluation.quant_gate import \
        zoo_gate_cases as jcases
    from deeplearning4j_tpu.parallel import quant as JP
    from deeplearning4j_tpu.parallel.serving import \
        ServingEngine as JEngine
    from deeplearning4j_tpu_torch.evaluation.quant_gate import \
        zoo_gate_cases as tcases
    from test_torch_quant import _step_bound
    _, jm, x = jcases()[0]
    _, tm, _ = tcases(device="cpu")[0]
    je = JEngine(jm, batch_limit=32, feature_shape=x.shape[1:],
                 precision=JP.PrecisionPolicy.int8(x),
                 registry=__import__(
                     "deeplearning4j_tpu.observe.registry",
                     fromlist=["MetricsRegistry"]).MetricsRegistry())
    try:
        with _engine(tm, batch_limit=32, feature_shape=x.shape[1:],
                     precision=PrecisionPolicy.int8(x)) as te:
            yt = te.output(x[:96])
            yj = np.asarray(je.output(x[:96]))
            assert np.mean(yt.argmax(-1) == yj.argmax(-1)) >= 0.99
            assert np.abs(yt - yj).max() <= _step_bound(te.quantized)
            assert te.stats()["quant"]["fallback"] == \
                je.stats()["quant"]["fallback"]
    finally:
        je.shutdown()
