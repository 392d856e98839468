"""Int8 quantization of the port against the JAX package on the CPU: the
int8 products, calibration and ``quantize_model``.

- ``int8_conv`` and ``int8_dot`` are bitwise the JAX package's for the
  same f32 input, int8 weights and scales: at LeNet's shapes, a grouped,
  a dilated and a SAME-strided conv, and a contraction of K = 4608 (past
  the f32 route's exact width of 1040, so the chunked int32 sum is
  exercised).
- Calibration of the committed LeNet and TextGenerationLSTM (both
  packages load the same zips and the same digits / one-hot streams):
  LeNet's first layer's scale is bitwise JAX's (its input is the raw
  features); every other layer, the TextGenerationLSTM's head included,
  sees activations that torch and XLA compute a few ulps apart, so its
  scale is held within relative 1e-6. The hash payload is built like
  JAX's: identical ``CalibrationResult`` contents hash the same in both
  packages.
- ``quantize_model`` picks the same quantized and fallback layers as JAX
  (at the default budget and at a tight one), the all-fallback build is
  bitwise the port's f32 output, and the int8 outputs agree with JAX's
  int8 outputs on top-1 (>= 99%) and within ``INT8_STEPS`` quantization
  steps of the output layer (see ``_step_bound``).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import quantize as TQ
from deeplearning4j_tpu_torch.parallel import quant as TP

# the int8 outputs of the two packages may differ where an activation
# lies on a rounding boundary and the f32 pre-activations differ by an
# ulp: one flip moves the output layer's int32 accumulator by at most
# |w_q| <= 127, i.e. its pre-activation by x_scale * max|W|. The bound
# allows this many such steps, halved by the softmax (whose Jacobian's
# rows sum to at most 1/2 in absolute value).
INT8_STEPS = 4
SCALE_REL = 1e-6


def _jq():
    import jax  # noqa: F401
    from deeplearning4j_tpu.ops import quantize as jq
    return jq


# ---------------------------------------------------------------------------
# numeric primitives
# ---------------------------------------------------------------------------

def test_weight_round_trip_within_half_step():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    q, s = TQ.quantize_weight(w)
    assert q.dtype == np.int8 and s.shape == (7,)
    assert np.all(np.abs(q.astype(np.float32) * s - w) <= s / 2 + 1e-7)


def test_dead_channel_gets_identity_scale():
    w = np.zeros((4, 3), np.float32)
    w[:, 1] = 0.5
    q, s = TQ.quantize_weight(w)
    assert s[0] == 1.0 and s[2] == 1.0 and np.all(q[:, 0] == 0)


def test_activation_scale_degenerate():
    assert TQ.activation_scale(0.0) == np.float32(1.0)
    assert TQ.activation_scale(float("nan")) == np.float32(1.0)
    assert TQ.activation_scale(127.0) == np.float32(1.0)


def test_int8_dot_matches_dequant_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    w = rng.normal(size=(9, 4)).astype(np.float32)
    wq, ws = TQ.quantize_weight(w)
    xs = TQ.activation_scale(np.abs(x).max())
    got = TQ.int8_dot(torch.from_numpy(x), torch.from_numpy(wq),
                      torch.from_numpy(ws), torch.tensor(xs)).numpy()
    xq = np.clip(np.rint(x / xs), -127, 127)
    want = (xq @ wq.astype(np.float64)) * (np.float64(xs) * ws)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


CONV_CASES = {
    # (x shape NHWC, w shape HWIO, strides, padding, dilation, groups)
    "lenet_layer_0": ((4, 28, 28, 1), (5, 5, 1, 20), (1, 1),
                      ((0, 0), (0, 0)), (1, 1), 1),
    "lenet_layer_2": ((4, 12, 12, 20), (5, 5, 20, 50), (1, 1),
                      ((0, 0), (0, 0)), (1, 1), 1),
    "grouped_same_strided": ((2, 9, 9, 8), (3, 3, 4, 6), (2, 2), "SAME",
                             (1, 1), 2),
    "dilated_padded": ((2, 11, 11, 4), (3, 3, 4, 5), (1, 1),
                       ((2, 2), (1, 1)), (2, 2), 1),
    "k4608": ((2, 6, 6, 512), (3, 3, 512, 8), (1, 1), "SAME", (1, 1), 1),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_is_bitwise_jax(case):
    import jax.numpy as jnp
    jq = _jq()
    xs_, ws_, s, pad, d, g = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=xs_).astype(np.float32)
    w = rng.normal(size=ws_).astype(np.float32)
    wq, wsc = TQ.quantize_weight(w)
    xsc = TQ.activation_scale(np.abs(x).max() * 0.5)   # saturates some
    want = np.asarray(jq.int8_conv(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wsc), jnp.asarray(xsc),
        window_strides=s, padding=[tuple(p) for p in pad]
        if not isinstance(pad, str) else pad, rhs_dilation=d,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g))
    got = TQ.int8_conv(torch.from_numpy(x), torch.from_numpy(wq),
                       torch.from_numpy(wsc), torch.tensor(xsc),
                       window_strides=s, padding=pad, rhs_dilation=d,
                       feature_group_count=g).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("k,n_out", [(800, 500), (500, 10), (256, 77),
                                     (4608, 13)])
def test_int8_dot_is_bitwise_jax(k, n_out):
    import jax.numpy as jnp
    jq = _jq()
    rng = np.random.default_rng(k)
    x = rng.normal(size=(6, 3, k)).astype(np.float32)
    w = rng.normal(size=(k, n_out)).astype(np.float32)
    wq, wsc = TQ.quantize_weight(w)
    xsc = TQ.activation_scale(np.abs(x).max())
    want = np.asarray(jq.int8_dot(jnp.asarray(x), jnp.asarray(wq),
                                  jnp.asarray(wsc), jnp.asarray(xsc)))
    got = TQ.int8_dot(torch.from_numpy(x), torch.from_numpy(wq),
                      torch.from_numpy(wsc), torch.tensor(xsc)).numpy()
    assert np.array_equal(got, want)


def test_int8_accumulator_past_the_exact_width_is_the_int64_product():
    """K = 4608 > INT8_EXACT_K: the chunked route's int32 sum is the
    exact integer product."""
    g = torch.Generator().manual_seed(4)
    a = torch.randint(-127, 128, (9, 4608), generator=g).float()
    b = torch.randint(-127, 128, (4608, 5), generator=g).float()
    b[:, 0] = 127
    a[0] = 127
    got = TQ._int_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())


# ---------------------------------------------------------------------------
# calibration and quantize_model on the committed zoo models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zoo():
    """name -> (JAX model, port model, features) of the gate's cases."""
    import jax  # noqa: F401
    from deeplearning4j_tpu.evaluation.quant_gate import \
        zoo_gate_cases as jcases
    from deeplearning4j_tpu_torch.evaluation.quant_gate import \
        zoo_gate_cases as tcases
    out = {}
    for (name, jm, jx), (tname, tm, tx) in zip(jcases(),
                                               tcases(device="cpu")):
        assert name == tname and np.array_equal(jx, tx)
        out[name] = (jm, tm, tx)
    return out


@pytest.fixture(scope="module")
def calibrated(zoo):
    from deeplearning4j_tpu.parallel import quant as JP
    out = {}
    for name, (jm, tm, x) in zoo.items():
        jp, tp = JP.PrecisionPolicy.int8(x), TP.PrecisionPolicy.int8(x)
        out[name] = (JP.calibrate(jm, jp), TP.calibrate(tm, tp))
    return out


ZOO = ["LeNet", "TextGenerationLSTM"]


@pytest.fixture(scope="module")
def quantized(zoo, calibrated):
    """name -> (JAX QuantizedModel, port QuantizedModel) at the default
    budget, from the shared calibrations."""
    from deeplearning4j_tpu.parallel import quant as JP
    out = {}
    for name, (jm, tm, x) in zoo.items():
        jc, tc = calibrated[name]
        out[name] = (JP.quantize_model(jm, JP.PrecisionPolicy.int8(x),
                                       calibration=jc),
                     TP.quantize_model(tm, TP.PrecisionPolicy.int8(x),
                                       calibration=tc))
    return out


@pytest.mark.parametrize("name", ZOO)
def test_calibration_scales_match_jax(calibrated, zoo, name):
    jc, tc = calibrated[name]
    tm = zoo[name][1]
    assert list(tc.scales) == list(jc.scales)
    assert tc.n_batches == jc.n_batches
    if TP._quant_kind(tm.layers[0]):
        # its input is the raw features: the absmax is exact in both
        first = tm.layers[0].name
        assert np.float32(tc.scales[first]) == np.float32(jc.scales[first])
        assert np.float32(tc.amax[first]) == np.float32(jc.amax[first])
    for k in jc.scales:
        a, b = np.float32(jc.scales[k]), np.float32(tc.scales[k])
        assert abs(a - b) <= SCALE_REL * abs(a), (k, a, b)


@pytest.mark.parametrize("name", ZOO)
def test_hash_equal_for_identical_contents(calibrated, name):
    jc, tc = calibrated[name]
    same = TP.CalibrationResult(method=jc.method, percentile=jc.percentile,
                                n_batches=jc.n_batches, amax=dict(jc.amax),
                                scales=dict(jc.scales))
    assert same.hash() == jc.hash()
    if all(np.float32(jc.scales[k]) == np.float32(tc.scales[k])
           for k in jc.scales):
        assert tc.hash() == jc.hash()
    else:
        assert tc.hash() != jc.hash()


@pytest.mark.parametrize("name", ZOO)
def test_same_stream_twice_same_hash(calibrated, zoo, name):
    tm, x = zoo[name][1], zoo[name][2]
    again = TP.calibrate(tm, TP.PrecisionPolicy.int8(x))
    assert again.hash() == calibrated[name][1].hash()
    assert again.scales == calibrated[name][1].scales


def test_percentile_tighter_than_absmax(zoo):
    tm, x = zoo["LeNet"][1], zoo["LeNet"][2]
    a = TP.calibrate(tm, TP.PrecisionPolicy.int8(x))
    p = TP.calibrate(tm, TP.PrecisionPolicy.int8(x, calibration="percentile",
                                                 percentile=50.0))
    assert all(p.amax[k] <= a.amax[k] for k in a.amax)
    assert any(p.amax[k] < a.amax[k] for k in a.amax)
    assert p.hash() != a.hash()


def test_int8_without_samples_raises(zoo):
    with pytest.raises(TP.QuantizationError, match="samples"):
        TP.calibrate(zoo["LeNet"][1], TP.PrecisionPolicy(mode="int8"))
    with pytest.raises(TP.QuantizationError, match="int8 policy"):
        TP.quantize_model(zoo["LeNet"][1], TP.PrecisionPolicy.bf16())


def _step_bound(qm) -> float:
    """INT8_STEPS quantization steps of the output layer's accumulator,
    through the softmax."""
    out = qm.model.layers[-1].name
    lp = qm.params[out]
    step = float(lp["x_scale"]) * float(
        (lp["W_q"].float().abs() * lp["w_scale"]).max())
    return 0.5 * INT8_STEPS * step


@pytest.mark.parametrize("name,budget", [("LeNet", 0.05),
                                         ("LeNet", 0.012),
                                         ("TextGenerationLSTM", 0.05)])
def test_quantize_model_matches_jax(calibrated, zoo, quantized, name,
                                    budget):
    """The default budget, and for LeNet a tight one that sends layer_2
    (error 0.0148) back to f32."""
    from deeplearning4j_tpu.parallel import quant as JP
    jm, tm, x = zoo[name]
    jc, tc = calibrated[name]
    if budget == 0.05:
        jq, tq = quantized[name]
    else:
        jq = JP.quantize_model(jm, JP.PrecisionPolicy.int8(
            x, error_budget=budget), calibration=jc)
        tq = TP.quantize_model(tm, TP.PrecisionPolicy.int8(
            x, error_budget=budget), calibration=tc)
        assert tq.fallback == ["layer_2"]
    assert tq.quantized_layers == jq.quantized_layers
    assert tq.fallback == jq.fallback
    for k, r in jq.report.items():
        assert tq.report[k]["kind"] == r["kind"]
        # the probe's error is itself a small difference of two outputs,
        # and an activation on a rounding boundary can flip: 1e-3 of it
        assert abs(tq.report[k]["error"] - r["error"]) <= 1e-3 * r["error"]
    xs = x[:96]
    yj = np.asarray(jq.build_inference_fn()(
        jq.params, jm.train_state.model_state, xs, None))
    yt = tq.build_inference_fn()(tq.params, tm.model_state,
                                 torch.from_numpy(xs)).numpy()
    assert np.mean(yj.argmax(-1) == yt.argmax(-1)) >= 0.99
    if tq.quantized_layers and tq.quantized_layers[-1] == tm.layers[-1].name:
        assert np.abs(yj - yt).max() <= _step_bound(tq)
    assert TP.params_nbytes(tq.params) <= TP.params_nbytes(tm.params)


@pytest.mark.parametrize("name", ZOO)
def test_all_fallback_is_bitwise_f32(calibrated, zoo, name):
    tm, x = zoo[name][1], zoo[name][2]
    qm = TP.quantize_model(tm, TP.PrecisionPolicy.int8(x, error_budget=-1.0),
                           calibration=calibrated[name][1])
    assert qm.quantized_layers == [] and sorted(qm.fallback) == \
        sorted(qm.report)
    xs = torch.from_numpy(x[:40])
    y_q = qm.build_inference_fn()(qm.params, tm.model_state, xs)
    assert torch.equal(y_q, tm.output(xs))


def test_calibration_hash_tracks_fallback(calibrated, zoo):
    tm, x = zoo["LeNet"][1], zoo["LeNet"][2]
    c = calibrated["LeNet"][1]
    a = TP.quantize_model(tm, TP.PrecisionPolicy.int8(x), calibration=c)
    b = TP.quantize_model(tm, TP.PrecisionPolicy.int8(x, error_budget=-1.0),
                          calibration=c)
    assert a.calibration_hash() != b.calibration_hash()


def test_lstm_layers_stay_f32(calibrated, zoo):
    """Only the dense head of the TextGenerationLSTM quantizes: its LSTMs
    run f32 (through lstm_fwd on the card)."""
    tm, x = zoo["TextGenerationLSTM"][1], zoo["TextGenerationLSTM"][2]
    qm = TP.quantize_model(tm, TP.PrecisionPolicy.int8(x),
                           calibration=calibrated["TextGenerationLSTM"][1])
    assert qm.quantized_layers == [tm.layers[-1].name]
    for l in tm.layers[:-1]:
        assert qm.params[l.name] is tm.params[l.name]


def test_jax_int8_params_carry_into_the_port(zoo, quantized):
    """The JAX package's quantized params (W_q int8, w_scale, x_scale)
    through ``params_from_jax``: the port's walk on them gives JAX's
    int8 outputs within the step bound."""
    import jax
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    jm, tm, x = zoo["LeNet"]
    jq, tq = quantized["LeNet"]
    p_np = jax.tree_util.tree_map(np.asarray, jq.params)
    params, _ = params_from_jax(p_np, {})
    for name in jq.quantized_layers:
        assert params[name]["W_q"].dtype == torch.int8
        assert torch.equal(params[name]["W_q"], tq.params[name]["W_q"])
    xs = x[:64]
    yj = np.asarray(jq.build_inference_fn()(
        jq.params, jm.train_state.model_state, xs, None))
    yt = tq.build_inference_fn()(params, tm.model_state,
                                 torch.from_numpy(xs)).numpy()
    assert np.abs(yt - yj).max() <= _step_bound(tq)


def test_committed_zoo_models_pass_gate_as_in_jax(zoo, quantized):
    """``run_zoo_gates`` passes on the committed LeNet and
    TextGenerationLSTM with JAX's verdicts, example counts, fallbacks and
    layer sets; LeNet runs its int8 convolutions."""
    from deeplearning4j_tpu.evaluation.quant_gate import run_quant_gate
    from deeplearning4j_tpu.parallel import quant as JP
    from deeplearning4j_tpu_torch.evaluation.quant_gate import run_zoo_gates
    got = run_zoo_gates(device="cpu")
    assert [r.model for r in got] == ZOO
    for g in got:
        jm, _, x = zoo[g.model]
        w = run_quant_gate(jm, JP.PrecisionPolicy.int8(x),
                           quantized=quantized[g.model][0],
                           model_name=g.model)
        assert g.passed and w.passed, (g.summary(), w.summary())
        assert g.n_examples == w.n_examples > 0
        assert g.n_positions == w.n_positions
        assert g.fallback == w.fallback == []
        assert sorted(g.layer_errors) == sorted(w.layer_errors)
        assert abs(g.top1_agreement - w.top1_agreement) <= 0.01
        assert abs(g.max_logit_delta - w.max_logit_delta) <= 0.01
    assert set(got[0].layer_errors) == {"layer_0", "layer_2", "layer_4",
                                        "layer_5"}
    assert TP._quant_kind(zoo["LeNet"][1].layers[0]) == "conv"
