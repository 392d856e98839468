"""The port's early stopping (earlystopping/) against the JAX package's on
the CPU.

The same trainer configuration runs in both packages on a narrow
MultiLayerNetwork with the same carried weights and the same batches:
max epochs, score improvement, best score, max time, the invalid-score
(NaN) and max-score guards, every N epochs with the last model saved,
and each score calculator (data-set loss, classification accuracy,
regression MSE, a custom callable). Both pick the same best epoch,
termination reason and details; the per-epoch held-out scores agree
within 1e-5 relative (accuracy exactly). Both savers round-trip: the
in-memory saver's clone and the local file saver's zip give back the
saved parameters bitwise, in each package.
"""

import numpy as np
import pytest

import deeplearning4j_tpu.earlystopping as JE
import deeplearning4j_tpu_torch.earlystopping as TE
from deeplearning4j_tpu.datasets.dataset import \
    ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from test_torch_telemetry import batches, mln_pair

REL = 1e-5


def run_both(build, nan_row=None, n=32):
    """``build(E, train, test)`` -> (configuration, extra trainer args)
    for each package's module ``E``; both results and models."""
    tm, jm = mln_pair()
    x, y = batches("mln", n)
    if nan_row is not None:
        x[nan_row, 0] = np.nan
    xt, yt = batches("mln", 24, seed=9)
    out = []
    for E, m, It, DS in ((TE, tm, ArrayDataSetIterator, DataSet),
                         (JE, jm, JArrayIt, JDataSet)):
        cfg = build(E, It(DS(xt, yt), 8))
        out.append(E.EarlyStoppingTrainer(cfg, m, It(DS(x, y), 8)).fit())
    return out


def assert_same(tr, jr, exact=False):
    assert tr.termination_reason.value == jr.termination_reason.value
    assert tr.termination_details == jr.termination_details
    assert tr.best_model_epoch == jr.best_model_epoch
    assert tr.total_epochs == jr.total_epochs
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, s in jr.score_vs_epoch.items():
        if exact:
            assert tr.score_vs_epoch[e] == s
        else:
            assert tr.score_vs_epoch[e] == pytest.approx(s, rel=REL)


def loss_calc(E, test):
    return E.DataSetLossCalculator(test)


CASES = {
    "max_epochs": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test))
        .epoch_termination_conditions(E.MaxEpochsTerminationCondition(3))),
    "score_improvement": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test))
        .epoch_termination_conditions(
            E.MaxEpochsTerminationCondition(6),
            E.ScoreImprovementEpochsTerminationCondition(1, 10.0))),
    "best_score": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test))
        .epoch_termination_conditions(
            E.MaxEpochsTerminationCondition(6),
            E.BestScoreEpochTerminationCondition(10.0))),
    "max_time": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test))
        .epoch_termination_conditions(E.MaxEpochsTerminationCondition(3))
        .iteration_termination_conditions(
            E.MaxTimeIterationTerminationCondition(0.0))),
    "max_score": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test))
        .epoch_termination_conditions(E.MaxEpochsTerminationCondition(3))
        .iteration_termination_conditions(
            E.MaxScoreIterationTerminationCondition(0.5))),
    "every_2_save_last": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test)).evaluate_every_n_epochs(2)
        .save_last_model(True)
        .epoch_termination_conditions(E.MaxEpochsTerminationCondition(4))),
    "no_calculator": lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .epoch_termination_conditions(E.MaxEpochsTerminationCondition(2))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax(case):
    tr, jr = run_both(lambda E, test: CASES[case](E, test).build())
    assert_same(tr, jr)
    if case == "max_time":
        assert tr.termination_reason is \
            TE.TerminationReason.ITERATION_TERMINATION_CONDITION


def test_invalid_score_stops_on_a_nan_batch():
    tr, jr = run_both(lambda E, test: (
        E.EarlyStoppingConfiguration.Builder()
        .score_calculator(loss_calc(E, test))
        .epoch_termination_conditions(E.MaxEpochsTerminationCondition(3))
        .iteration_termination_conditions(
            E.InvalidScoreIterationTerminationCondition()).build()),
        nan_row=12)
    assert_same(tr, jr)
    assert "InvalidScore" in tr.termination_details


@pytest.mark.parametrize("calc", ["accuracy", "mse", "custom"])
def test_each_score_calculator(calc):
    def build(E, test):
        c = {"accuracy": lambda: E.ClassificationScoreCalculator(
                 "accuracy", test),
             "mse": lambda: E.RegressionScoreCalculator(
                 "mean_squared_error", test),
             "custom": lambda: E.CustomScoreCalculator(
                 lambda m: m.score(next(iter(test))), minimize=True)}[calc]()
        return (E.EarlyStoppingConfiguration.Builder().score_calculator(c)
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(3)).build())
    tr, jr = run_both(build)
    assert_same(tr, jr, exact=calc == "accuracy")


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_savers_round_trip(saver, tmp_path):
    import jax
    tm, jm = mln_pair()
    for E, m in ((TE, tm), (JE, jm)):
        s = (E.InMemoryModelSaver() if saver == "memory"
             else E.LocalFileModelSaver(str(tmp_path / E.__name__)))
        s.save_best_model(m, 0.5)
        s.save_latest_model(m, 0.7)
        for back in (s.get_best_model(), s.get_latest_model()):
            if E is TE:
                assert back.device == m.device
                for ln, lp in m.params.items():
                    for k, v in lp.items():
                        assert back.params[ln][k].equal(v)
            else:
                want = jax.device_get(m.train_state.params)
                got = jax.device_get(back.train_state.params)
                for ln, lp in want.items():
                    for k, v in lp.items():
                        np.testing.assert_array_equal(got[ln][k], v)
