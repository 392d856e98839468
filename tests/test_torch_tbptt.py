"""Truncated BPTT of ``MultiLayerNetwork`` against the JAX package on the
CPU.

The JAX model and the port model are built from one configuration JSON
with the same weights and optimizer state (``params_from_jax``,
``opt_state_from_jax``), and each fits the same batch: the per-segment
losses (the JAX step wrapped to record them; the port's
``last_segment_losses``) within rel 1e-5, and the parameters after the
batch within 1e-4 of each array's largest (ROADMAP's f32 defaults). Cases:
T divisible by the segment length, a ragged tail, features and labels
masks, a features mask alone (the labels fall back to it), 2-D labels
behind a ``LastTimeStep``, ``SimpleRnn`` and ``GravesLSTM`` cores, and the
bf16 carries' dtype. Then the cases of the JAX package's
``tests/test_memory_legacy_tbptt.py::TestTbptt`` on the port, and the
committed ``lstm_v1.zip`` (a TBPTT configuration, segment length 6)
restored in both packages and fitted for three batches.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import \
    UciSequenceDataSetIterator
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    flatten_paths, opt_state_from_jax, params_from_jax, restore_model)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.zoo.models import WEIGHTS_DIR

REPO = WEIGHTS_DIR.parents[2]
N, F, H, C = 4, 3, 8, 5
FWD_REL, TREE_REL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_tree(got, want, rel, what):
    flat_g, flat_w = flatten_paths(got), flatten_paths(want)
    assert set(flat_g) == set(flat_w), what
    for k, v in flat_w.items():
        v = np.asarray(v, np.float32)
        g = flat_g[k].detach().float().cpu().numpy()
        err = np.abs(g - v).max()
        assert err <= rel * max(np.abs(v).max(), 1e-6), (what, k, err)


def _jax_conf(kind, t, k, compute="float32"):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import output as O
    from deeplearning4j_tpu.nn.layers import recurrent as R
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize.updaters import Adam
    b = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(2e-2))
         .gradient_normalization("clip_value", 5.0)
         .compute_dtype(compute).list())
    head = O.RnnOutputLayer(n_out=C, loss=LossFunction.MCXENT,
                            activation=Activation.SOFTMAX)
    if kind == "simple_rnn":
        b = b.layer(R.SimpleRnn(n_out=H)).layer(R.LSTM(n_out=H))
    elif kind == "graves":
        b = b.layer(R.GravesLSTM(n_out=H)).layer(R.LSTM(n_out=H))
    elif kind == "labels2d":
        b = b.layer(R.LSTM(n_out=H)).layer(R.LastTimeStep(
            inner=R.LSTM(n_out=H)))
        head = O.OutputLayer(n_out=C, loss=LossFunction.MCXENT,
                             activation=Activation.SOFTMAX)
    else:
        b = b.layer(R.LSTM(n_out=H)).layer(R.LSTM(n_out=H))
    return (b.layer(head).set_input_type(InputType.recurrent(F, t))
            .backprop_type("tbptt").tbptt_fwd_length(k)
            .tbptt_back_length(k).build())


def _pair(jconf):
    """(JAX model, port model) with the same configuration, weights and
    optimizer state; the JAX model's TBPTT step records its losses."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    ts = _np(jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    return jm, tm, _record_segments(jm)


def _record_segments(jm):
    inner = jm._build_tbptt_step()
    losses = []

    def step(*args):
        out = inner(*args)
        losses.append(float(out[1]))
        return out
    jm._tbptt_step = step
    return losses


def _data(kind, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, t, F)).astype(np.float32)
    if kind == "labels2d":
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, N)]
    else:
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (N, t))]
    m = np.ones((N, t), np.float32)
    m[1, t - 3:] = 0.0
    m[3, t // 2:] = 0.0
    return x, y, m


CASES = {
    # kind, T, k, features mask, labels mask
    "divisible": ("lstm", 12, 4, False, False),
    "ragged_tail": ("lstm", 10, 4, False, False),
    "masks": ("lstm", 10, 4, True, True),
    "features_mask_only": ("lstm", 10, 4, True, False),
    "labels2d": ("labels2d", 10, 4, True, False),
    "simple_rnn": ("simple_rnn", 11, 4, True, True),
    "graves": ("graves", 9, 4, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tbptt_fit_matches_jax_segment_by_segment(case):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    kind, t, k, use_fm, use_lm = CASES[case]
    jm, tm, jlosses = _pair(_jax_conf(kind, t, k))
    x, y, m = _data(kind, t)
    fm = m if use_fm else None
    lm = m if use_lm else None
    for batch in range(2):
        del jlosses[:]
        jm.fit(JDataSet(x, y, fm, lm))
        tm.fit(DataSet(x, y, fm, lm))
        got = [float(v) for v in tm.last_segment_losses]
        assert len(got) == len(jlosses) == -(-t // k)
        np.testing.assert_allclose(got, jlosses, rtol=FWD_REL,
                                   err_msg=f"batch {batch}")
    assert tm.iteration == int(jm.train_state.iteration) == 2 * -(-t // k)
    assert tm.score() == pytest.approx(jlosses[-1], rel=FWD_REL)
    _close_tree(tm.params, _np(jm.train_state.params), TREE_REL, "params")


def test_tbptt_carries_in_bf16_compute_are_bf16():
    jconf = _jax_conf("simple_rnn", 10, 4, compute="bfloat16")
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    carries = tm._zero_carries(N)
    assert carries["layer_0"].dtype == torch.bfloat16
    assert all(c.dtype == torch.bfloat16 for c in carries["layer_1"])
    seen = []
    step = tm._build_tbptt_step()

    def spy(ts, f, l, fm, lm, gen, carries):
        seen.append(carries)
        return step(ts, f, l, fm, lm, gen, carries)
    tm._tbptt_step = spy
    x, y, m = _data("simple_rnn", 10)
    tm.fit(DataSet(x, y, m, m))
    assert len(seen) == 3
    for carries in seen[1:]:
        assert carries["layer_0"].dtype == torch.bfloat16
        assert all(c.dtype == torch.bfloat16 and not c.requires_grad
                   for c in carries["layer_1"])
    assert all(np.isfinite(float(v)) for v in tm.last_segment_losses)


def test_tbptt_tail_labels_mask_is_the_padded_features_mask():
    """The ragged tail's labels mask falls back to the padded features
    mask, never to ones."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        _pad_tbptt_tail
    f = torch.ones(2, 3, 4)
    l = torch.ones(2, 3, 5)
    fm = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    pf, pl, pfm, plm = _pad_tbptt_tail(f, l, fm, None, 5, True)
    assert pf.shape == (2, 5, 4) and pl.shape == (2, 5, 5)
    assert torch.equal(plm, pfm)
    assert torch.equal(pfm, torch.tensor([[1.0, 1, 0, 0, 0],
                                          [1.0, 0, 0, 0, 0]]))
    _, _, pfm, plm = _pad_tbptt_tail(f, l, None, None, 5, True)
    assert torch.equal(pfm[:, :3], torch.ones(2, 3))
    assert torch.equal(pfm[:, 3:], torch.zeros(2, 2)) and plm is pfm
    _, l2, _, lm2 = _pad_tbptt_tail(f, l[:, 0], fm, l[:, 0, :1], 5, False)
    assert l2.shape == (2, 5) and lm2.shape == (2, 1)


# ---- the JAX package's TestTbptt cases, on the port ---------------------

def _uci_conf(tbptt, cell="LSTM", k=20):
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import recurrent as R
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    b = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(5e-3))
         .list()
         .layer(getattr(R, cell)(n_out=12, activation=Activation.TANH))
         .layer(RnnOutputLayer(n_out=6, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
         .set_input_type(InputType.recurrent(1, 60)))
    if tbptt:
        b = b.backprop_type("tbptt").tbptt_fwd_length(k).tbptt_back_length(k)
    return b.build()


def test_tbptt_chunks_per_batch():
    model = MultiLayerNetwork(_uci_conf(True), device="cpu").init()
    it = UciSequenceDataSetIterator(32)
    batches = sum(1 for _ in it)
    it.reset()
    model.fit(it, epochs=1)
    # 60-step sequences / 20-step truncation = 3 optimizer steps a batch
    assert model.iteration == 3 * batches
    assert model.last_feeder is None       # TBPTT takes the unfed path


def test_tbptt_learns():
    model = MultiLayerNetwork(_uci_conf(True), device="cpu").init()
    it = UciSequenceDataSetIterator(32)
    model.fit(it, epochs=3)
    assert model.evaluate(it).accuracy() > 0.30   # 6 classes, chance 0.167


def test_tbptt_simple_rnn():
    model = MultiLayerNetwork(_uci_conf(True, cell="SimpleRnn"),
                              device="cpu").init()
    model.fit(UciSequenceDataSetIterator(16), epochs=1)
    assert np.isfinite(model.score())


def test_tbptt_ragged_tail_trains():
    """T 60 with k 25: segments 25/25/10, the padded tail included."""
    model = MultiLayerNetwork(_uci_conf(True, k=25), device="cpu").init()
    it = UciSequenceDataSetIterator(32)
    batches = sum(1 for _ in it)
    it.reset()
    model.fit(it, epochs=1)
    assert model.iteration == 3 * batches
    assert np.isfinite(model.score())


def test_tbptt_tail_actually_updates_params():
    """The tail segment's step moves the parameters: the whole batch
    against the same batch cut before its tail."""
    ds = next(iter(UciSequenceDataSetIterator(32)))
    full = MultiLayerNetwork(_uci_conf(True, k=25), device="cpu").init()
    full._fit_batch(ds)
    assert full.iteration == 3
    cut = MultiLayerNetwork(_uci_conf(True, k=25), device="cpu").init()
    cut._fit_batch(DataSet(np.asarray(ds.features)[:, :50],
                           np.asarray(ds.labels)[:, :50]))
    assert cut.iteration == 2
    assert any(not torch.allclose(a, b) for a, b in zip(
        flatten_paths(full.params).values(),
        flatten_paths(cut.params).values()))


def test_standard_backprop_unaffected():
    model = MultiLayerNetwork(_uci_conf(False), device="cpu").init()
    it = UciSequenceDataSetIterator(32)
    batches = sum(1 for _ in it)
    it.reset()
    model.fit(it, epochs=1)
    assert model.iteration == batches


def test_uci_sequences_match_jax():
    from deeplearning4j_tpu.datasets.fetchers import \
        UciSequenceDataSetIterator as JUci
    for train in (True, False):
        a, b = list(JUci(16, train=train)), list(
            UciSequenceDataSetIterator(16, train=train))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x.features),
                                          np.asarray(y.features))
            np.testing.assert_array_equal(np.asarray(x.labels),
                                          np.asarray(y.labels))


# ---- the committed TBPTT fixture ----------------------------------------

def test_lstm_v1_fits_like_jax():
    """lstm_v1.zip (TBPTT, segment length 6) restored with its Adam state
    in both packages, then three batches of T 15 (segments 6, 6, 3):
    parameters and updater state after each batch."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.serialization import \
        restore_model as jax_restore
    path = str(REPO / "tests" / "resources" / "regression" / "lstm_v1.zip")
    jm = jax_restore(path, load_updater=True)
    tm = restore_model(path, device="cpu", load_updater=True)
    assert tm.conf.backprop_type == "tbptt" and \
        tm.conf.tbptt_fwd_length == 6
    jlosses = _record_segments(jm)
    rng = np.random.default_rng(5)
    for batch in range(3):
        x = rng.normal(size=(5, 15, 2)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (5, 15))]
        del jlosses[:]
        jm.fit(JDataSet(x, y))
        tm.fit(DataSet(x, y))
        np.testing.assert_allclose([float(v) for v in
                                    tm.last_segment_losses], jlosses,
                                   rtol=FWD_REL)
        _close_tree(tm.params, _np(jm.train_state.params), TREE_REL,
                    f"params after batch {batch}")
    assert tm.iteration == int(jm.train_state.iteration) == 9
    from deeplearning4j_tpu.models.serialization import _flatten_with_paths
    want = _flatten_with_paths(_np(jm.train_state.opt_state))
    got = flatten_paths(tm.opt_state)
    assert set(got) == set(want)
    for key, v in want.items():
        g = got[key].float().numpy()
        assert np.abs(g - v).max() <= TREE_REL * max(np.abs(v).max(),
                                                     1e-12), key


def test_tbptt_configuration_round_trips_with_jax():
    from deeplearning4j_tpu.nn.config import \
        MultiLayerConfiguration as JConf
    jconf = _jax_conf("lstm", 10, 4)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.backprop_type == "tbptt" and conf.tbptt_fwd_length == 4
    assert json.loads(JConf.from_json(conf.to_json()).to_json()) == \
        json.loads(jconf.to_json())


def test_back_length_differing_from_fwd_warns():
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    b = NeuralNetConfiguration.Builder().list().tbptt_fwd_length(8)
    with pytest.warns(UserWarning, match="back length is ignored"):
        b.tbptt_back_length(4)
