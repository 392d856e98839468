"""The port's training listeners (optimize/listeners.py and the fit loop's
listener hooks) against the JAX package's on the CPU.

A narrow MultiLayerNetwork in both packages (the same configuration and
carried weights) is fitted on the same numpy-seeded batches with each of
the eight listeners attached; each gives the same observable record:
the scores collected (within 1e-5 relative, the f32 bound of a step),
the iterations at which it fires (exact), the checkpoint file names
(exact), the evaluations' accuracy (exact), and the parameter/update
report's columns (exact) and values (1e-4 relative, 1e-7 absolute). The
JAX package restores a port CheckpointListener zip with the same
parameters. Listeners fire in registration order; a monitored model's
score listeners read the telemetry's flushed loss and never sync.
"""

import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import \
    ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.optimize import listeners as JL
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.optimize import listeners as TL
from test_torch_telemetry import batches, mln_pair

REL = 1e-5


def fit_both(make, epochs=2, n=48, b=8, k=1):
    """(port listener, JAX listener, port model, JAX model) after
    ``epochs`` iterator epochs with ``make(module)``'s listener."""
    tm, jm = mln_pair()
    x, y = batches("mln", n)
    tl, jl = make(TL), make(JL)
    tm.set_listeners(tl)
    jm.set_listeners(jl)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), b), epochs=epochs, k_steps=k)
    jm.fit(JArrayIt(JDataSet(x, y), b), epochs=epochs, k_steps=k)
    return tl, jl, tm, jm


@pytest.mark.parametrize("k", [1, 3])
def test_score_iteration_listener(k):
    tl, jl, _, _ = fit_both(lambda L: L.ScoreIterationListener(2), k=k)
    assert len(tl.scores) == len(jl.scores) > 0
    np.testing.assert_allclose(tl.scores, jl.scores, rtol=REL)


def test_collect_scores_iteration_listener():
    tl, jl, _, _ = fit_both(lambda L: L.CollectScoresIterationListener(1))
    assert [i for i, _ in tl.scores] == [i for i, _ in jl.scores] == list(
        range(1, 13))
    np.testing.assert_allclose([s for _, s in tl.scores],
                               [s for _, s in jl.scores], rtol=REL)


def test_performance_listener_reports_the_same_windows():
    tl, jl, _, _ = fit_both(lambda L: L.PerformanceListener(
        frequency=3, report_score=True))
    assert [r["iteration"] for r in tl.history] == [
        r["iteration"] for r in jl.history] == [3, 6, 9, 12]
    for got, want in zip(tl.history, jl.history):
        assert set(got) == set(want)
        assert got["score"] == pytest.approx(want["score"], rel=REL)
        assert got["samples_per_sec"] > 0 and got["batches_per_sec"] > 0


def test_time_and_sleepy_listeners_run_in_both(caplog):
    def make(L):
        return [L.TimeIterationListener(12, frequency=4),
                L.SleepyTrainingListener(timer_iteration_ms=1.0,
                                         time_mode="connected")]
    tm, jm = mln_pair()
    x, y = batches("mln", 32)
    tl, jl = make(TL), make(JL)
    tm.set_listeners(*tl)
    jm.set_listeners(*jl)
    with caplog.at_level("INFO"):
        tm.fit(ArrayDataSetIterator(DataSet(x, y), 8))
        jm.fit(JArrayIt(JDataSet(x, y), 8))
    eta = [r.getMessage().split(",")[0] for r in caplog.records
           if "ETA" in r.getMessage()]
    assert eta == ["iteration 4/12"] * 2
    assert set(tl[1]._last) == set(jl[1]._last) == {"it"}


def test_evaluative_listener():
    x, y = batches("mln", 40, seed=5)
    tl, jl, _, _ = fit_both(lambda L: L.EvaluativeListener(
        (ArrayDataSetIterator if L is TL else JArrayIt)(
            (DataSet if L is TL else JDataSet)(x, y), 10)))
    assert [e for e, _ in tl.evaluations] == [e for e, _ in jl.evaluations] \
        == [0, 1]
    for (_, te), (_, je) in zip(tl.evaluations, jl.evaluations):
        assert te.accuracy() == je.accuracy()


def test_checkpoint_listener_names_and_jax_restores_the_zip(tmp_path):
    from deeplearning4j_tpu.models.serialization import \
        restore_multi_layer_network

    def make(L):
        return L.CheckpointListener(str(tmp_path / L.__name__),
                                    every_n_epochs=1, every_n_iterations=5,
                                    keep_last=3)
    tl, jl, tm, _ = fit_both(make)
    names = lambda d: sorted(os.listdir(d))
    assert names(tl.dir) == names(jl.dir) == [
        "checkpoint_epoch_0.zip", "checkpoint_epoch_1.zip",
        "checkpoint_iter_10.zip"]
    back = restore_multi_layer_network(
        os.path.join(tl.dir, "checkpoint_epoch_1.zip"), load_updater=True)
    for ln, lp in jax.device_get(back.train_state.params).items():
        for key, v in lp.items():
            np.testing.assert_array_equal(
                np.asarray(v), tm.params[ln][key].numpy())
    assert int(back.train_state.iteration) == tm.iteration == 12


def test_param_and_gradient_listener_writes_the_same_table(tmp_path):
    def make(L):
        return L.ParamAndGradientIterationListener(
            iterations=2, output_to_console=False,
            file=str(tmp_path / f"{L.__name__}.tsv"))
    tl, jl, _, _ = fit_both(make, epochs=1)
    rows = [open(l.file).read().splitlines() for l in (tl, jl)]
    assert len(rows[0]) == len(rows[1]) == 4       # header + 3 reports
    assert rows[0][0] == rows[1][0]
    for got, want in zip(rows[0][1:], rows[1][1:]):
        g = np.array(got.split("\t"), np.float64)
        w = np.array(want.split("\t"), np.float64)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)


def test_listeners_fire_in_order_and_monitored_scores_come_from_the_ring():
    from deeplearning4j_tpu_torch.observe.telemetry import TelemetryCollector
    events = []

    class Rec(TL.TrainingListener):
        def __init__(self, name):
            self.name = name

        def on_epoch_start(self, model, epoch):
            events.append((self.name, "start", epoch))

        def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                           batch_size):
            events.append((self.name, "iter", iteration))

        def on_epoch_end(self, model, epoch):
            events.append((self.name, "end", epoch))

    tm, _ = mln_pair()
    x, y = batches("mln", 16)
    tc = TelemetryCollector(flush_interval=2)
    score = TL.ScoreIterationListener(1)
    tm.set_telemetry(tc)
    tm.set_listeners(Rec("A"), Rec("B"))
    tm.add_listeners(score)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 4))
    assert events == [("A", "start", 0), ("B", "start", 0),
                      ("A", "iter", 1), ("B", "iter", 1),
                      ("A", "iter", 2), ("B", "iter", 2),
                      ("A", "iter", 3), ("B", "iter", 3),
                      ("A", "iter", 4), ("B", "iter", 4),
                      ("A", "end", 0), ("B", "end", 0)]
    # nothing is flushed before step 2: the score listener skips step 1,
    # then reads the loss the last flush decoded
    assert score.scores == [tc.history[1]["loss"], tc.history[1]["loss"],
                            tc.history[3]["loss"]]
