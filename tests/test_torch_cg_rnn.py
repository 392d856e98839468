"""Recurrent ``ComputationGraph``s of the port against the JAX package on
the CPU: features masks through the walk (the repair: a features mask
alone bounds the loss, reaches every recurrent layer and
``LastTimeStepVertex``, and goes through ``output(mask=)`` and
``evaluate``), truncated BPTT and stored-state streaming — the cases of
the JAX package's ``tests/test_cg_rnn.py``, each held against the JAX
package where it gives a number.

Both graphs are built from one configuration JSON and carry the same
weights and optimizer state (``params_from_jax``, ``opt_state_from_jax``).
Bounds (ROADMAP's f32 defaults): outputs and losses rel 1e-5 (of the
largest magnitude for arrays), gradients and parameters after fitting
1e-4 of each array's largest.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    _ensure_registry, flatten_paths, opt_state_from_jax, params_from_jax)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optimize import solver


@pytest.fixture(autouse=True)
def _no_crash_dumps(monkeypatch):
    """Some fits here raise on purpose: keep the flight recorders' default
    post-mortem dumps (both packages') out of the temporary directory."""
    monkeypatch.setenv("DL4J_CRASH_DUMPS", "0")


F, H, C = 3, 5, 2
FWD_REL, TREE_REL = 1e-5, 1e-4
RNG = np.random.default_rng(2720)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel, what=""):
    got = (got.detach().float().cpu().numpy()
           if isinstance(got, torch.Tensor) else np.asarray(got))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), (what, err)


def _close_tree(got, want, rel, what):
    flat_g, flat_w = flatten_paths(got), flatten_paths(_np(want))
    assert set(flat_g) == set(flat_w), what
    for k, v in flat_w.items():
        _close(flat_g[k], v, rel, f"{what} {k}")


def _J():
    """The JAX package's builder pieces."""
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.graph import vertices
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import feedforward, output, recurrent
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize import updaters
    return dict(B=NeuralNetConfiguration.Builder, V=vertices, I=InputType,
                R=recurrent, O=output, FF=feedforward, A=Activation,
                L=LossFunction, U=updaters)


def _jax_graph(seed=1, tbptt=False, k=4, layers="lstm_rnn", updater=None):
    j = _J()
    R, O, A, L = j["R"], j["O"], j["A"], j["L"]
    g = (j["B"]().seed(seed).updater(updater or j["U"].Adam(5e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(j["I"].recurrent(F)))
    if layers == "lstm_rnn":
        g.add_layer("lstm", R.LSTM(n_out=H, activation=A.TANH), "in")
        g.add_layer("rnn", R.SimpleRnn(n_out=H, activation=A.TANH), "lstm")
        last = "rnn"
    elif layers == "probe":
        g.add_layer("lstm", R.LSTM(n_out=8), "in")
        last = "lstm"
    elif layers == "bidirectional":
        g.add_layer("bi", R.Bidirectional(fwd=R.LSTM(n_out=H),
                                          mode="concat"), "in")
        g.add_layer("g", R.GravesLSTM(n_out=H), "bi")
        last = "g"
    elif layers == "last_step":
        g.add_layer("lstm", R.LSTM(n_out=H), "in")
        g.add_vertex("last", j["V"].LastTimeStepVertex(), "lstm")
        g.add_layer("out", O.OutputLayer(n_out=C, loss=L.MCXENT,
                                         activation=A.SOFTMAX), "last")
        g.set_outputs("out")
        return j, g
    elif layers == "mask_zero":
        g.add_layer("mz", R.MaskZeroLayer(inner=R.LSTM(n_out=H),
                                          mask_value=-999.0), "in")
        last = "mz"
    g.add_layer("out", O.RnnOutputLayer(n_out=C, loss=L.MCXENT,
                                        activation=A.SOFTMAX), last)
    g.set_outputs("out")
    if tbptt:
        g.backprop_type("tbptt").tbptt_fwd_length(k)
    return j, g


def _pair(g):
    """(JAX graph, port graph) from one configuration JSON, with the same
    weights and optimizer state; the JAX graph's TBPTT step records its
    segment losses into the returned list."""
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JCG
    _ensure_registry()
    jconf = g.build()
    jm = JCG(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    tm = ComputationGraph(conf, device="cpu").init()
    ts = _np(jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    inner = jm._build_tbptt_step()
    losses = []

    def step(*args):
        out = inner(*args)
        losses.append(float(out[1]))
        return out
    jm._tbptt_step = step
    return jm, tm, losses


def seq_labels(n, t):
    return np.eye(C, dtype=np.float32)[RNG.integers(0, C, (n, t))]


def _seq(n, t, f=F):
    return RNG.normal(size=(n, t, f)).astype(np.float32)


def _jds(x, y, fm=None, lm=None):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    return JDataSet(x, y, fm, lm)


def _jax_loss_and_grads(jm, x, y, fm, lm):
    ts = jm.train_state
    tup = lambda a: None if a is None else (jnp.asarray(a),)
    return jax.value_and_grad(lambda p: jm._loss(
        p, ts.model_state, (jnp.asarray(x),), (jnp.asarray(y),), tup(fm),
        tup(lm), None, ts.iteration)[0])(ts.params)


def _port_loss_and_grads(tm, x, y, fm, lm):
    loss, _, grads = solver.value_and_grad(
        tm._loss, tm.train_state, *tm._step_args(DataSet(x, y, fm, lm)))
    return loss, grads


# ---- the repair: features masks through the graph -------------------------

def _probe_data(n=4, t=10):
    x = _seq(n, t)
    y = seq_labels(n, t)
    m = np.ones((n, t), np.float32)
    m[:, t - 4:] = 0.0
    return x, y, m


@pytest.mark.parametrize("masks", ["features_and_labels", "labels_only",
                                   "features_only"])
def test_probe_graph_train_loss_and_gradients_match_jax(masks):
    """in -> LSTM(8) -> RnnOutputLayer(2), T 10, the last 4 ticks masked:
    with a features mask alone the loss is bounded by it, as in the JAX
    package (before the repair the port scored the padded ticks)."""
    jm, tm, _ = _pair(_jax_graph(layers="probe")[1])
    x, y, m = _probe_data()
    fm = None if masks == "labels_only" else m
    lm = None if masks == "features_only" else m
    jloss, jgrads = _jax_loss_and_grads(jm, x, y, fm, lm)
    loss, grads = _port_loss_and_grads(tm, x, y, fm, lm)
    assert float(loss) == pytest.approx(float(jloss), rel=FWD_REL)
    _close_tree(grads, jgrads, TREE_REL, "grads")
    unmasked, _ = _port_loss_and_grads(tm, x, y, None, None)
    assert float(unmasked) != pytest.approx(float(loss), rel=1e-3)


def test_bidirectional_graph_with_a_ragged_mask_matches_jax():
    jm, tm, _ = _pair(_jax_graph(layers="bidirectional")[1])
    n, t = 4, 9
    x, y = _seq(n, t), seq_labels(n, t)
    m = np.ones((n, t), np.float32)
    m[0, 5:] = 0.0
    m[2, 7:] = 0.0
    m[3, 1:] = 0.0
    jloss, jgrads = _jax_loss_and_grads(jm, x, y, m, None)
    loss, grads = _port_loss_and_grads(tm, x, y, m, None)
    assert float(loss) == pytest.approx(float(jloss), rel=FWD_REL)
    _close_tree(grads, jgrads, TREE_REL, "grads")
    _close(tm.output(x, mask=m), jm.output(x, mask=jnp.asarray(m)),
           FWD_REL, "output(mask=)")
    _close(tm.output(x), jm.output(x), FWD_REL, "output")


def test_last_time_step_vertex_takes_the_mask():
    jm, tm, _ = _pair(_jax_graph(layers="last_step")[1])
    n, t = 3, 6
    x = _seq(n, t)
    m = np.ones((n, t), np.float32)
    m[0, 2:] = 0.0
    m[1, 5:] = 0.0
    y = np.eye(C, dtype=np.float32)[RNG.integers(0, C, n)]
    _close(tm.output(x, mask=m), jm.output(x, mask=jnp.asarray(m)),
           FWD_REL, "output")
    jloss, jgrads = _jax_loss_and_grads(jm, x, y, m, None)
    loss, grads = _port_loss_and_grads(tm, x, y, m, None)
    assert float(loss) == pytest.approx(float(jloss), rel=FWD_REL)
    _close_tree(grads, jgrads, TREE_REL, "grads")


def test_evaluate_with_a_features_mask_matches_jax():
    jm, tm, _ = _pair(_jax_graph(layers="probe")[1])
    x, y, m = _probe_data(n=6)
    got = tm.evaluate(DataSet(x, y, m))
    want = jm.evaluate(_jds(x, y, m))
    assert got.accuracy() == pytest.approx(want.accuracy(), abs=0)
    np.testing.assert_array_equal(np.asarray(got.confusion_matrix()),
                                  np.asarray(want.confusion_matrix()))
    # the masked steps are left out of the counts
    assert np.asarray(got.confusion_matrix()).sum() == int(m.sum())


def test_build_inference_fn_passes_the_mask():
    jm, tm, _ = _pair(_jax_graph(layers="bidirectional")[1])
    x, _, m = _probe_data()
    fwd = tm.build_inference_fn()
    _close(fwd(tm.params, tm.model_state, torch.tensor(x),
               torch.tensor(m)),
           jm.build_inference_fn()(jm.train_state.params,
                                   jm.train_state.model_state,
                                   jnp.asarray(x), jnp.asarray(m)),
           FWD_REL, "fwd")
    _close(fwd(tm.params, tm.model_state, torch.tensor(x)),
           jm.output(x), FWD_REL, "fwd without a mask")


def test_compute_loss_keeps_the_masked_score_unlike_jax_graphs():
    """Known reference behaviour: the JAX graph's compute_loss passes no
    masks, so it scores padded steps; the port's (like both packages'
    MultiLayerNetwork) is bounded by the masks."""
    jm, tm, _ = _pair(_jax_graph(layers="probe")[1])
    x, y, m = _probe_data()
    masked, _ = _jax_loss_and_grads(jm, x, y, m, None)
    unmasked, _ = _jax_loss_and_grads(jm, x, y, None, None)
    assert float(tm.compute_loss(DataSet(x, y, m))) == pytest.approx(
        float(masked), rel=FWD_REL)
    assert float(jm.compute_loss(_jds(x, y, m))) == pytest.approx(
        float(unmasked), rel=FWD_REL)
    assert float(masked) != pytest.approx(float(unmasked), rel=1e-3)


# ---- the JAX package's tests/test_cg_rnn.py cases ------------------------

def _mln_pair(seed, tbptt=False, k=4):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    j = _J()
    R, O, A, L = j["R"], j["O"], j["A"], j["L"]
    b = (j["B"]().seed(seed).updater(j["U"].Adam(5e-3)).list()
         .layer(R.LSTM(n_out=H, activation=A.TANH))
         .layer(R.SimpleRnn(n_out=H, activation=A.TANH))
         .layer(O.RnnOutputLayer(n_out=C, loss=L.MCXENT,
                                 activation=A.SOFTMAX)))
    if tbptt:
        b = b.backprop_type("tbptt").tbptt_fwd_length(k)
    jconf = b.set_input_type(j["I"].recurrent(F)).build()
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    ts = _np(jm.train_state)
    params_from_jax(ts.params, ts.model_state, model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    return jm, tm


def _graph_from_mln(tm, tbptt=False, k=4, seed=1):
    """The port graph of the same architecture carrying the port MLN's
    parameters (layer order matches node order)."""
    jm, cg, _ = _pair(_jax_graph(seed=seed, tbptt=tbptt, k=k)[1])
    names = dict(zip(["lstm", "rnn", "out"], tm.layer_names))
    cg.set_params({a: {k_: v.clone() for k_, v in tm.params[b].items()}
                   for a, b in names.items()})
    return cg


def test_rnn_time_step_matches_full_sequence_forward():
    jm, cg, _ = _pair(_jax_graph()[1])
    n, t = 4, 6
    x = _seq(n, t)
    full = cg.output(x)
    _close(full, jm.output(x), FWD_REL, "output")
    cg.rnn_clear_previous_state()
    jm.rnn_clear_previous_state()
    streamed = torch.stack([cg.rnn_time_step(x[:, s]) for s in range(t)], 1)
    jstream = np.stack([np.asarray(jm.rnn_time_step(x[:, s]))
                        for s in range(t)], 1)
    _close(streamed, full.numpy(), 1e-5, "streamed vs full")
    _close(streamed, jstream, FWD_REL, "streamed vs JAX")


def test_rnn_time_step_chunked_multi_step():
    jm, cg, _ = _pair(_jax_graph()[1])
    n, t = 3, 8
    x = _seq(n, t)
    full = cg.output(x)
    cg.rnn_clear_previous_state()
    a, b = cg.rnn_time_step(x[:, :5]), cg.rnn_time_step(x[:, 5:])
    _close(torch.cat([a, b], 1), full.numpy(), 1e-5, "chunked")
    ja, jb = jm.rnn_time_step(x[:, :5]), jm.rnn_time_step(x[:, 5:])
    _close(b, jb, FWD_REL, "second chunk vs JAX")


def test_rnn_time_step_state_is_stored_and_clearable():
    jm, cg, _ = _pair(_jax_graph()[1])
    x = RNG.normal(size=(2, F)).astype(np.float32)
    o1 = cg.rnn_time_step(x)
    assert cg.rnn_get_previous_state() is not None
    o2 = cg.rnn_time_step(x)
    assert not torch.allclose(o1, o2)          # the state advanced
    _close(o2, [jm.rnn_time_step(x), jm.rnn_time_step(x)][1], FWD_REL,
           "second step vs JAX")
    cg.rnn_clear_previous_state()
    _close(cg.rnn_time_step(x), o1.numpy(), 0.0, "after clear")
    st = cg.rnn_get_previous_state()
    assert set(st) == {"lstm", "rnn"} and isinstance(st["lstm"], tuple)
    o4 = cg.rnn_time_step(x)
    cg.rnn_set_previous_state(st)
    _close(cg.rnn_time_step(x), o4.numpy(), 0.0, "after set")
    # a new batch size starts from zero state
    x3 = np.concatenate([x, x[:1]])
    cg.rnn_clear_previous_state()
    fresh = cg.rnn_time_step(x3)
    cg.rnn_time_step(x)
    _close(cg.rnn_time_step(x3), fresh.numpy(), 0.0, "batch size change")


def test_rnn_time_step_matches_mln():
    jmln, mln = _mln_pair(seed=7)
    cg = _graph_from_mln(mln, seed=7)
    n, t = 3, 5
    x = _seq(n, t)
    _close(cg.output(x), mln.output(x).numpy(), 1e-6, "output")
    out, _ = mln.rnn_time_step(x)
    cg.rnn_clear_previous_state()
    _close(cg.rnn_time_step(x), out.numpy(), 1e-6, "rnn_time_step")
    jout, _ = jmln.rnn_time_step(x)
    _close(out, jout, FWD_REL, "MLN vs JAX")


def test_rnn_time_step_rejects_bidirectional():
    jm, cg, _ = _pair(_jax_graph(layers="bidirectional")[1])
    with pytest.raises(ValueError, match="bidirectional"):
        cg.rnn_time_step(RNG.normal(size=(2, F)).astype(np.float32))
    with pytest.raises(ValueError, match="bidirectional"):
        jm.rnn_time_step(RNG.normal(size=(2, F)).astype(np.float32))


def test_tbptt_bidirectional_warns_on_both_model_types():
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              Bidirectional)
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    n, t = 2, 8
    x, y = _seq(n, t), seq_labels(n, t)
    g = (NeuralNetConfiguration.Builder().seed(3).updater(Sgd(0.1))
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(F)))
    g.add_layer("lstm", LSTM(n_out=H), "in")
    g.add_layer("bi", Bidirectional(fwd=LSTM(n_out=H)), "lstm")
    g.add_layer("out", RnnOutputLayer(n_out=C), "bi")
    g.set_outputs("out")
    g.backprop_type("tbptt").tbptt_fwd_length(4)
    cg = ComputationGraph(g.build(), device="cpu").init()
    with pytest.warns(UserWarning, match="bidirectional layer 'bi'"):
        cg.fit(DataSet(x, y))
    assert cg.iteration == 2
    mln = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(3).updater(Sgd(0.1)).list()
        .layer(LSTM(n_out=H)).layer(Bidirectional(fwd=LSTM(n_out=H)))
        .layer(RnnOutputLayer(n_out=C))
        .backprop_type("tbptt").tbptt_fwd_length(4)
        .set_input_type(InputType.recurrent(F)).build(), device="cpu").init()
    with pytest.warns(UserWarning, match="bidirectional layer"):
        mln.fit(DataSet(x, y))
    assert mln.iteration == 2


def test_tbptt_fit_trains_graph():
    jm, cg, jlosses = _pair(_jax_graph(tbptt=True, k=4)[1])
    n, t = 8, 12
    x, y = _seq(n, t), seq_labels(n, t)
    ds = DataSet(x, y)
    s0 = cg.score(ds)
    assert s0 == pytest.approx(float(jm.score(_jds(x, y))), rel=FWD_REL)
    for i in range(15):
        cg.fit(ds)
        if i < 2:
            jm.fit(_jds(x, y))
            np.testing.assert_allclose(
                [float(v) for v in cg.last_segment_losses], jlosses[-3:],
                rtol=FWD_REL)
            if i == 1:
                _close_tree(cg.params, jm.train_state.params, TREE_REL,
                            "params after two batches")
    assert cg.score(ds) < s0
    # 12 timesteps / k 4: 3 segments a fit call
    assert cg.iteration == 45


def test_tbptt_ragged_tail_and_masking():
    jm, cg, jlosses = _pair(_jax_graph(tbptt=True, k=5)[1])
    n, t = 4, 7                              # 5 + a ragged 2
    x, y = _seq(n, t), seq_labels(n, t)
    mask = np.ones((n, t), np.float32)
    mask[:, 6:] = 0.0
    mask[1, 3:] = 0.0
    ds = DataSet(x, y, mask, mask)
    s0 = cg.score(ds)
    for i in range(12):
        cg.fit(ds)
        if i < 2:
            jm.fit(_jds(x, y, mask, mask))
            np.testing.assert_allclose(
                [float(v) for v in cg.last_segment_losses], jlosses[-2:],
                rtol=FWD_REL)
    assert np.isfinite(cg.score(ds)) and cg.score(ds) < s0
    # a features mask alone: the tail's labels fall back to it
    jm2, cg2, jl2 = _pair(_jax_graph(tbptt=True, k=5)[1])
    cg2.fit(DataSet(x, y, mask))
    jm2.fit(_jds(x, y, mask))
    np.testing.assert_allclose([float(v) for v in cg2.last_segment_losses],
                               jl2, rtol=FWD_REL)
    _close_tree(cg2.params, jm2.train_state.params, TREE_REL, "params")


def test_tbptt_matches_mln_losses():
    """Same parameters, same data: the graph's TBPTT segment losses equal
    the MLN's step for step (and the JAX MLN's)."""
    jmln, mln = _mln_pair(seed=11, tbptt=True, k=3)
    cg = _graph_from_mln(mln, tbptt=True, k=3, seed=11)
    cg.opt_state = cg._tx.init(cg.params)
    n, t = 4, 9
    x, y = _seq(n, t), seq_labels(n, t)
    ds = DataSet(x, y)
    for _ in range(4):
        mln.fit(ds)
        cg.fit(ds)
        np.testing.assert_allclose(
            [float(v) for v in cg.last_segment_losses],
            [float(v) for v in mln.last_segment_losses], rtol=1e-6)
    jmln.fit(_jds(x, y))
    assert float(jmln._last_loss) == pytest.approx(
        float(_mln_pair(seed=11, tbptt=True, k=3)[1].fit(ds)._last_loss),
        rel=FWD_REL)


def test_wrapped_recurrent_carries_state():
    """A MaskZeroLayer-wrapped LSTM carries its state across
    rnn_time_step calls and TBPTT segments (the wrapper hands state to
    its core)."""
    jm, cg, _ = _pair(_jax_graph(layers="mask_zero", tbptt=True, k=3)[1])
    assert [nm for nm, _, _ in cg._recurrent_carry_nodes()] == ["mz"]
    n, t = 3, 6
    x = _seq(n, t)
    full = cg.output(x)
    _close(full, jm.output(x), FWD_REL, "output")
    cg.rnn_clear_previous_state()
    streamed = torch.stack([cg.rnn_time_step(x[:, s]) for s in range(t)], 1)
    _close(streamed, full.numpy(), 1e-5, "streamed")
    y = seq_labels(n, t)
    jm.fit(_jds(x, y))
    cg.fit(DataSet(x, y))
    assert cg.iteration == 2
    _close_tree(cg.params, jm.train_state.params, TREE_REL, "params")


def test_tbptt_multi_input_static_side_input():
    """A 2-D (static) side input goes whole into every segment."""
    j = _J()
    R, O, A, L, V = j["R"], j["O"], j["A"], j["L"], j["V"]
    g = (j["B"]().seed(5).updater(j["U"].Adam(5e-3)).graph_builder()
         .add_inputs("seq", "static")
         .set_input_types(j["I"].recurrent(F), j["I"].feed_forward(2)))
    g.add_layer("lstm", R.LSTM(n_out=H, activation=A.TANH), "seq")
    g.add_layer("emb", j["FF"].DenseLayer(n_out=H, activation=A.TANH),
                "static")
    g.add_vertex("rep", V.DuplicateToTimeSeriesVertex(), "emb", "seq")
    g.add_vertex("merge", V.MergeVertex(), "lstm", "rep")
    g.add_layer("out", O.RnnOutputLayer(n_out=C, loss=L.MCXENT,
                                        activation=A.SOFTMAX), "merge")
    g.set_outputs("out")
    g.backprop_type("tbptt").tbptt_fwd_length(4)
    jm, cg, jlosses = _pair(g)
    n, t = 4, 10                              # segments 4, 4, 2
    xs, xst, y = _seq(n, t), RNG.normal(size=(n, 2)).astype(
        np.float32), seq_labels(n, t)
    from deeplearning4j_tpu.datasets.dataset import \
        MultiDataSet as JMultiDataSet
    mds = MultiDataSet([xs, xst], [y])
    s0 = cg.score(mds)
    for i in range(10):
        cg.fit(mds)
        if i < 2:
            jm.fit(JMultiDataSet([xs, xst], [y]))
            np.testing.assert_allclose(
                [float(v) for v in cg.last_segment_losses], jlosses[-3:],
                rtol=FWD_REL)
    assert cg.iteration == 30
    assert cg.score(mds) < s0


def test_tbptt_refuses_unequal_sequence_lengths():
    j = _J()
    R, O = j["R"], j["O"]
    g = (j["B"]().seed(5).graph_builder().add_inputs("a", "b")
         .set_input_types(j["I"].recurrent(F), j["I"].recurrent(F)))
    g.add_vertex("m", j["V"].MergeVertex(), "a", "b")
    g.add_layer("lstm", R.LSTM(n_out=H), "m")
    g.add_layer("out", O.RnnOutputLayer(n_out=C), "lstm")
    g.set_outputs("out")
    g.backprop_type("tbptt").tbptt_fwd_length(4)
    _, cg, _ = _pair(g)
    with pytest.raises(ValueError, match="equal sequence lengths"):
        cg.fit(MultiDataSet([_seq(2, 6), _seq(2, 7)], [seq_labels(2, 6)]))


def test_graph_builder_tbptt_methods_and_aliases():
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    b = NeuralNetConfiguration.Builder().graph_builder()
    with pytest.raises(ValueError, match="unknown backprop type"):
        b.backprop_type("sideways")
    _, g = _jax_graph(tbptt=True, k=6)
    conf = ComputationGraphConfiguration.from_json(g.build().to_json())
    assert (conf.backprop_type, conf.tbptt_fwd_length) == ("tbptt", 6)
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    b = (NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(F))
         .add_layer("l", LSTM(n_out=H), "in")
         .add_layer("out", RnnOutputLayer(n_out=C), "l").set_outputs("out")
         .backprop_type("TRUNCATED_BPTT").tbptt_fwd_length(5)
         .tbptt_back_length(3))
    with pytest.warns(UserWarning, match="tbptt_back_length"):
        conf = b.build()
    assert conf.backprop_type == "tbptt" and conf.tbptt_fwd_length == 5


def test_recurrent_vertices_round_trip_zips_both_ways(tmp_path):
    """A graph with every recurrent vertex (and MergeVertex) saved by one
    package and restored by the other gives the same outputs."""
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JCG
    from deeplearning4j_tpu.models.serialization import \
        restore_model as jax_restore
    from deeplearning4j_tpu.models.serialization import save_model as jax_save
    from deeplearning4j_tpu_torch.models.serialization import (restore_model,
                                                               save_model)
    j = _J()
    R, O, V = j["R"], j["O"], j["V"]
    g = (j["B"]().seed(4).graph_builder().add_inputs("seq", "static")
         .set_input_types(j["I"].recurrent(F), j["I"].feed_forward(2)))
    g.add_vertex("rev", V.ReverseTimeSeriesVertex(), "seq")
    g.add_vertex("rep", V.DuplicateToTimeSeriesVertex(), "static", "seq")
    g.add_vertex("merge", V.MergeVertex(), "rev", "rep")
    g.add_layer("lstm", R.LSTM(n_out=H), "merge")
    g.add_vertex("last", V.LastTimeStepVertex(), "lstm")
    g.add_layer("out", O.OutputLayer(n_out=C), "last")
    g.set_outputs("out")
    jm = JCG(g.build()).init()
    xs, xst = _seq(3, 6), RNG.normal(size=(3, 2)).astype(np.float32)
    m = np.ones((3, 6), np.float32)
    m[1, 4:] = 0.0
    want = np.asarray(jm.output(xs, xst, mask=jnp.asarray(m)))
    a = str(tmp_path / "jax.zip")
    jax_save(jm, a)
    tm = restore_model(a, device="cpu")
    _close(tm.output(xs, xst, mask=m), want, FWD_REL, "jax zip in the port")
    b = str(tmp_path / "port.zip")
    save_model(tm, b)
    np.testing.assert_array_equal(
        np.asarray(jax_restore(b).output(xs, xst, mask=jnp.asarray(m))),
        want)
