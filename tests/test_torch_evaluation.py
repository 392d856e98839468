"""The port's evaluation classes and ``evaluate``/``evaluate_regression``
against the JAX package's on the same predictions (CPU).

Every class of ``evaluation/evaluation.py``, ``curves.py`` and
``results.py`` is fed the same numpy labels, predictions and masks in
both packages; every public method that takes no argument, or class or
column indices, is called on both and the answers compared: counts and
other integers exactly, rates within 1e-7 (the copies run the same numpy
code, so they agree bitwise today), strings exactly, curves by their
dicts and through a JSON round trip. ``evaluate`` and
``evaluate_regression`` run a small ``MultiLayerNetwork`` with the JAX
model's weights in both packages over one iterator (outputs within
1e-5, so argmax and counts agree exactly on these inputs).
"""

import inspect
import itertools

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.evaluation import curves as jcurves
from deeplearning4j_tpu.evaluation import evaluation as jeval
from deeplearning4j_tpu.evaluation import results as jresults
from deeplearning4j_tpu_torch.evaluation import curves as tcurves
from deeplearning4j_tpu_torch.evaluation import evaluation as teval
from deeplearning4j_tpu_torch.evaluation import results as tresults

RATE_TOL = 1e-7
# index arguments tried for methods that take one
INDEX_ARGS = {"cls": (0, 1, 2), "col": (0, 2), "actual": (0, 2),
              "predicted": (1, 2), "r": (0, 3), "i": (0, 2),
              "threshold": (0.3, 0.7), "precision": (0.5,), "recall": (0.5,),
              "beta": (0.5, 2.0)}
# methods that feed data or need a peer object
FEEDERS = {"eval", "add", "add_all", "from_json", "from_dict"}


def _same(got, want, what):
    if hasattr(want, "to_dict"):
        assert type(got).__name__ == type(want).__name__, what
        _same(got.to_dict(), want.to_dict(), what)
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=RATE_TOL,
                                       atol=RATE_TOL, err_msg=what)
    elif isinstance(want, (bool, int, np.integer, str)) or want is None:
        assert got == want, what
    elif isinstance(want, (float, np.floating)):
        if np.isnan(want):
            assert np.isnan(got), what
        else:
            assert got == pytest.approx(want, rel=RATE_TOL,
                                        abs=RATE_TOL), what
    else:
        raise TypeError(f"{what}: cannot compare {type(want).__name__}")


def _answers(obj):
    """{(method, args): answer} of every public query method."""
    out = {}
    for name, fn in inspect.getmembers(obj, callable):
        if name.startswith("_") or name in FEEDERS or inspect.isclass(fn):
            continue
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.default is inspect.Parameter.empty
                  and p.kind is p.POSITIONAL_OR_KEYWORD]
        if all(p.name in INDEX_ARGS for p in params):
            calls = list(itertools.product(*(INDEX_ARGS[p.name]
                                              for p in params)))
        else:
            raise AssertionError(f"{type(obj).__name__}.{name}: no "
                                 "arguments known for it")
        for args in calls:
            out[(name, args)] = fn(*args)
    return out


def _compare(tobj, jobj):
    got, want = _answers(tobj), _answers(jobj)
    assert set(got) == set(want) and want
    for key in want:
        _same(got[key], want[key], f"{type(jobj).__name__}.{key}")


def _data(rng, n=120, c=5, seq=False):
    logits = rng.normal(0, 1.5, (n, c))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return labels, probs.astype(np.float32), mask


def _pair(name, *args, **kw):
    return getattr(teval, name)(*args, **kw), getattr(jeval, name)(*args,
                                                                   **kw)


@pytest.mark.parametrize("kw", [{}, dict(top_n=3), dict(num_classes=5,
                                label_names=list("abcde"))])
def test_evaluation_matches_jax(kw):
    rng = np.random.default_rng(0)
    t, j = _pair("Evaluation", **kw)
    for masked in (False, True):
        labels, probs, mask = _data(rng)
        m = mask if masked else None
        t.eval(labels, probs, mask=m)
        j.eval(labels, probs, mask=m)
    # index labels as well as one-hot
    labels, probs, _ = _data(rng)
    t.eval(labels.argmax(-1), probs)
    j.eval(labels.argmax(-1), probs)
    _compare(t, j)


def test_binary_evaluation_matches_jax():
    rng = np.random.default_rng(1)
    for pos in (1, None):
        t, j = _pair("Evaluation", binary_positive_class=pos)
        labels, probs, mask = _data(rng, c=2)
        t.eval(labels, probs, mask=mask)
        j.eval(labels, probs, mask=mask)
        _compare(t, j)


def test_regression_evaluation_matches_jax():
    rng = np.random.default_rng(2)
    t, j = _pair("RegressionEvaluation")
    for masked in (False, True):
        y = rng.normal(0, 2, (50, 3)).astype(np.float32)
        p = (y + rng.normal(0, 0.5, y.shape)).astype(np.float32)
        m = (rng.uniform(size=50) > 0.3).astype(np.float32) if masked \
            else None
        t.eval(y, p, mask=m)
        j.eval(y, p, mask=m)
    _compare(t, j)


@pytest.mark.parametrize("name", ["ROC", "ROCMultiClass", "ROCBinary",
                                  "EvaluationBinary",
                                  "EvaluationCalibration"])
def test_roc_binary_and_calibration_match_jax(name):
    rng = np.random.default_rng(3)
    t, j = _pair(name)
    for masked in (False, True):
        labels, probs, mask = _data(rng, c=3)
        if name == "ROC":
            labels, probs = labels[:, 1], probs[:, 1]
        elif name in ("ROCBinary", "EvaluationBinary"):
            labels = (rng.uniform(size=probs.shape) > 0.5).astype(
                np.float32)
        m = mask if masked else None
        t.eval(labels, probs, mask=m)
        j.eval(labels, probs, mask=m)
    _compare(t, j)


def test_confusion_matrix_and_results_match_jax():
    rng = np.random.default_rng(4)
    t, j = _pair("ConfusionMatrix", [0, 1, 2, 3])
    for a, p in rng.integers(0, 4, (40, 2)):
        t.add(int(a), int(p))
        j.add(int(a), int(p))
    t2, j2 = _pair("ConfusionMatrix", [0, 1, 2, 3])
    t2.add(1, 2, count=3)
    j2.add(1, 2, count=3)
    t.add_all(t2)
    j.add_all(j2)
    _compare(t, j)
    probs = rng.uniform(size=(6, 4)).astype(np.float32)
    _compare(tresults.RankClassificationResult(probs, list("wxyz")),
             jresults.RankClassificationResult(probs, list("wxyz")))
    _compare(tresults.BinaryClassificationResult(probs[:, 0], 0.4),
             jresults.BinaryClassificationResult(probs[:, 0], 0.4))


def test_curves_and_json_round_trip_match_jax():
    """Each curve kind from both packages: the same points, areas and
    JSON; the port reads the JAX package's JSON back and vice versa."""
    rng = np.random.default_rng(5)
    t, j = _pair("ROC")
    y = (rng.uniform(size=200) > 0.6).astype(np.float32)
    p = np.clip(y * 0.3 + rng.uniform(size=200) * 0.7, 0, 1)
    t.eval(y, p)
    j.eval(y, p)
    tc, jc = _pair("EvaluationCalibration")
    labels, probs, _ = _data(rng, c=3)
    tc.eval(labels, probs)
    jc.eval(labels, probs)
    pairs = [(t.get_roc_curve(), j.get_roc_curve()),
             (t.get_precision_recall_curve(), j.get_precision_recall_curve()),
             (tc.get_reliability_diagram(), jc.get_reliability_diagram()),
             (tc.get_residual_histogram(), jc.get_residual_histogram()),
             (tc.get_probability_histogram(), jc.get_probability_histogram())]
    for got, want in pairs:
        _compare(got, want)
        assert got.to_json() == want.to_json()
        back = tcurves.from_json(want.to_json())
        assert type(back).__name__ == type(want).__name__
        _same(back, want, type(want).__name__)
        _same(jcurves.from_json(got.to_json()), want, type(want).__name__)


def _dense_pair(loss, act, n_out):
    """A Dense(6) + OutputLayer MultiLayerNetwork in both packages, the
    port's with the JAX model's weights."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serialization import \
        params_from_jax
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jconf = (NeuralNetConfiguration.Builder().seed(3).list()
             .layer(DenseLayer(n_out=6, activation=Activation.TANH))
             .layer(OutputLayer(n_out=n_out, loss=LossFunction[loss],
                                activation=Activation[act]))
             .set_input_type(InputType.feed_forward(4)).build())
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    ts = jax.device_get(jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    return tm, jm


def test_evaluate_matches_jax():
    from deeplearning4j_tpu.datasets.dataset import \
        ArrayDataSetIterator as JIt
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    tm, jm = _dense_pair("MCXENT", "SOFTMAX", 3)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (70, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 70)]
    m = (rng.uniform(size=70) > 0.25).astype(np.float32)
    it = ArrayDataSetIterator(DataSet(x, y, None, m), 16)
    jit = JIt(JDS(x, y, None, m), 16)
    got = tm.evaluate(it, teval.Evaluation(top_n=2))
    want = jm.evaluate(jit, jeval.Evaluation(top_n=2))
    # Evaluation masks only time series (N, T, C); 2-D rows all count,
    # in both packages
    assert got.confusion_matrix().sum() == 70
    _compare(got, want)
    # a single DataSet, and a second pass over the (reset) iterator
    _compare(tm.evaluate(DataSet(x, y)), jm.evaluate(JDS(x, y)))
    _compare(tm.evaluate(it), jm.evaluate(jit))


def test_evaluate_regression_matches_jax():
    from deeplearning4j_tpu.datasets.dataset import \
        ArrayDataSetIterator as JIt
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    tm, jm = _dense_pair("MSE", "IDENTITY", 2)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (45, 4)).astype(np.float32)
    y = rng.normal(0, 1, (45, 2)).astype(np.float32)
    got = tm.evaluate_regression(ArrayDataSetIterator(DataSet(x, y), 10))
    want = jm.evaluate_regression(JIt(JDS(x, y), 10))
    assert got.n == want.n == 45
    for name, args in _answers(want):
        g, w = getattr(got, name)(*args), getattr(want, name)(*args)
        # the forward agrees within 1e-5, so the sums do too
        assert g == pytest.approx(w, rel=1e-5, abs=1e-6), (name, args)
