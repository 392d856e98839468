"""The LSTM slice against the JAX package on the CPU: a narrow
``MultiLayerNetwork`` (2×LSTM(8) + RnnOutputLayer(5), T=6, with a
features mask) built from the JAX model's ``configuration.json`` and
weights — output, loss, gradients, and parameters plus Adam state after 3
``fit`` steps with value clipping at 5; the ``lstm_v1`` regression
fixture; the committed ``textgen_lstm.zip`` at full width (scoring,
cross-entropy, greedy decoding); and checkpoints with updater state in
both directions (clip+Adam on the LSTM stack; every newly ported updater,
and a schedule's count, on a small dense stack).

The JAX model runs its default ``lax.scan`` recurrence, the port the
plain versions of its fused kernels (the CPU path of the wrappers).
Bounds (ROADMAP's f32 defaults): outputs and loss rel 1e-5; gradients,
post-step parameters and Adam moments 1e-4 of each array's largest
magnitude. The fixture is held to its committed outputs within 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    flatten_paths, opt_state_from_jax, params_from_jax, restore_model,
    restore_multi_layer_network, save_model)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize import solver
from deeplearning4j_tpu_torch.zoo.models import WEIGHTS_DIR

REPO = WEIGHTS_DIR.parents[2]
N, T, F, H, V = 4, 6, 3, 8, 5
FWD_REL, TREE_REL = 1e-5, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_tree(got, want, rel, what):
    for ln, lp in want.items():
        for k, v in lp.items():
            v = np.asarray(v)
            g = got[ln][k].detach().float().cpu().numpy()
            err = np.abs(g - v).max()
            assert err <= rel * max(np.abs(v).max(), 1e-6), \
                (what, ln, k, err, np.abs(v).max())


def _jax_conf(clip=True):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize.updaters import Adam
    b = NeuralNetConfiguration.Builder().seed(7).updater(Adam(2e-2))
    if clip:
        b = b.gradient_normalization("clip_value", 5.0)
    return (b.list()
            .layer(LSTM(n_out=H)).layer(LSTM(n_out=H))
            .layer(RnnOutputLayer(n_out=V, loss=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(F, T)).build())


def _pair(seed=0, clip=True):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    jconf = _jax_conf(clip)
    jm = JMLN(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    tm = MultiLayerNetwork(conf, device="cpu").init()
    ts = jm.train_state
    params_from_jax(_np_tree(ts.params), _np_tree(ts.model_state), "cpu",
                    model=tm)
    opt_state_from_jax(_np_tree(ts.opt_state), tm)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, T, F)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (N, T))]
    m = np.ones((N, T), np.float32)
    m[1, 4:] = 0.0
    m[3, 2:] = 0.0
    return jm, tm, x, y, m


def _jax_ds(x, y, m=None):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    return JDataSet(x, y, m)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=what)


def test_configuration_round_trips_with_jax():
    from deeplearning4j_tpu.nn.config import \
        MultiLayerConfiguration as JConf
    jconf = _jax_conf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    back = JConf.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert [l.n_in for l in conf.layers] == [F, H, H]


@pytest.mark.parametrize("masked", [False, True])
def test_output_loss_and_gradients_match_jax(masked):
    import jax.numpy as jnp
    jm, tm, x, y, m = _pair()
    fm = m if masked else None
    _close(tm.output(x, mask=fm), jm.output(x, mask=fm), FWD_REL, "output")
    jloss = float(jm.compute_loss(_jax_ds(x, y, fm)))
    assert float(tm.compute_loss(DataSet(x, y, fm))) == pytest.approx(
        jloss, rel=FWD_REL)
    ts = jm.train_state
    jgrads = jax.grad(lambda p: jm._loss(
        p, ts.model_state, jnp.asarray(x), jnp.asarray(y),
        None if fm is None else jnp.asarray(fm), None, None,
        ts.iteration)[0])(ts.params)
    loss, _, grads = solver.value_and_grad(
        tm._loss, tm.train_state, *tm._step_args(DataSet(x, y, fm)))
    assert float(loss) == pytest.approx(jloss, rel=FWD_REL)
    _close_tree(grads, _np_tree(jgrads), TREE_REL, "grads")


def test_three_adam_clip_steps_match_jax():
    jm, tm, x, y, m = _pair(seed=1)
    for _ in range(3):
        jm.fit(_jax_ds(x, y, m))
        tm.fit(DataSet(x, y, m))
        assert tm.score() == pytest.approx(float(jm.score()), rel=FWD_REL)
    ts = jm.train_state
    _close_tree(tm.params, _np_tree(ts.params), TREE_REL, "params")
    _close_tree(tm.model_state, _np_tree(ts.model_state), TREE_REL, "state")
    want = _flat_jax(ts.opt_state)
    got = flatten_paths(tm.opt_state)
    assert set(got) == set(want)
    assert int(got["#1/#0/.count"]) == 3 == tm.iteration
    for k, v in want.items():
        g = got[k].float().numpy()
        assert np.abs(g - v).max() <= TREE_REL * max(np.abs(v).max(),
                                                     1e-12), k


def _flat_jax(tree):
    from deeplearning4j_tpu.models.serialization import _flatten_with_paths
    return _flatten_with_paths(tree)


def test_k_step_call_equals_k_fits():
    _, a, x, y, m = _pair(seed=2)
    _, b, _, _, _ = _pair(seed=2)
    for _ in range(2):
        a.fit(DataSet(x, y, m))
    k = lambda t: torch.from_numpy(np.stack([t, t]))
    b.train_state, losses = b._build_scan_train_step()(
        b.train_state, k(x), k(y), k(m), None)
    assert losses.shape == (2,) and b.iteration == 2
    _close_tree(b.params, {ln: {kk: v.numpy() for kk, v in lp.items()}
                           for ln, lp in a.params.items()}, 1e-6, "params")


def test_lstm_v1_fixture_matches_expected_outputs():
    res = REPO / "tests" / "resources" / "regression"
    exp = json.loads((res / "expected_outputs.json").read_text())["lstm_v1"]
    model = restore_model(str(res / "lstm_v1.zip"), device="cpu",
                          load_updater=True)
    assert isinstance(model, MultiLayerNetwork)
    assert model.conf.backprop_type == "tbptt"
    assert "#0/.count" in flatten_paths(model.opt_state)
    out = model.output(np.asarray(exp["input"], np.float32))
    _close(out, exp["output"], 1e-5, "lstm_v1")


def test_updater_checkpoints_carry_across_both_ways(tmp_path):
    """JAX → port → JAX with clip+Adam state: after each restore, one more
    step gives the same params as the other package's model continuing."""
    from deeplearning4j_tpu.models.serialization import \
        restore_multi_layer_network as jax_restore
    from deeplearning4j_tpu.models.serialization import save_model as jax_save
    jm, _, x, y, m = _pair(seed=3)
    jds, tds = _jax_ds(x, y, m), DataSet(x, y, m)
    jm.fit(jds)
    a = str(tmp_path / "jax.zip")
    jax_save(jm, a, save_updater=True)
    tm = restore_multi_layer_network(a, device="cpu", load_updater=True)
    assert tm.iteration == 1 and int(tm.opt_state["#1"]["#0"][".count"]) == 1
    # the LSTMs' last carries a fit leaves in the state are not restored,
    # as the JAX package does not restore them
    assert tm.model_state == {"layer_0": {}, "layer_1": {}, "layer_2": {}}
    without = restore_model(a, device="cpu")
    assert int(without.opt_state["#1"]["#0"][".count"]) == 0
    jm.fit(jds)
    tm.fit(tds)
    _close_tree(tm.params, _np_tree(jm.train_state.params), TREE_REL, "p")

    b = str(tmp_path / "port.zip")
    save_model(tm, b, save_updater=True)
    back = jax_restore(b, load_updater=True)
    assert int(back.train_state.iteration) == 2
    back.fit(jds)
    tm.fit(tds)
    _close_tree(tm.params, _np_tree(back.train_state.params), TREE_REL,
                "params")


def _dense_jax_model(updater):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    conf = (NeuralNetConfiguration.Builder().seed(11).updater(updater)
            .list()
            .layer(DenseLayer(n_out=6, activation=Activation.TANH))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return JMLN(conf).init()


@pytest.mark.parametrize("name", ["AdamW", "RmsProp", "AdaGrad", "Nadam",
                                  "AMSGrad", "AdaMax", "AdaDelta",
                                  "Sgd-schedule"])
def test_new_updater_checkpoints_carry_across_both_ways(tmp_path, name):
    """JAX → port → JAX with each newly ported updater's state (and a
    schedule's count): after each restore, one more step gives the same
    params as the other package's model continuing."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.serialization import \
        restore_multi_layer_network as jax_restore
    from deeplearning4j_tpu.models.serialization import save_model as jax_save
    from deeplearning4j_tpu.optimize import updaters as jup
    from deeplearning4j_tpu.optimize.schedules import ExponentialSchedule
    upd = (jup.Sgd(ExponentialSchedule(0.1, 0.5)) if name == "Sgd-schedule"
           else getattr(jup, name)(learning_rate=1e-2)
           if name != "AdaDelta" else jup.AdaDelta())
    jm = _dense_jax_model(upd)
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (10, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    jds, tds = JDataSet(x, y), DataSet(x, y)
    jm.fit(jds)
    a = str(tmp_path / "jax.zip")
    jax_save(jm, a, save_updater=True)
    tm = restore_multi_layer_network(a, device="cpu", load_updater=True)
    assert type(tm.conf.global_config.updater).__name__ == upd.__class__.\
        __name__
    want = _flat_jax(jax.device_get(jm.train_state.opt_state))
    got = flatten_paths(tm.opt_state)
    assert set(got) == set(want) and want
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    jm.fit(jds)
    tm.fit(tds)
    _close_tree(tm.params, _np_tree(jm.train_state.params), TREE_REL, "p")
    b = str(tmp_path / "port.zip")
    save_model(tm, b, save_updater=True)
    back = jax_restore(b, load_updater=True)
    assert int(back.train_state.iteration) == 2
    back.fit(jds)
    tm.fit(tds)
    _close_tree(tm.params, _np_tree(back.train_state.params), TREE_REL,
                "params")
    want = _flat_jax(jax.device_get(back.train_state.opt_state))
    got = flatten_paths(tm.opt_state)
    for k, v in want.items():
        g = got[k].float().numpy()
        assert np.abs(g - v).max() <= TREE_REL * max(np.abs(v).max(),
                                                     1e-12), k


def test_opt_state_from_jax_rejects_name_mismatches():
    jm, tm, _, _, _ = _pair()
    st = _np_tree(jm.train_state.opt_state)
    with pytest.raises(KeyError):
        opt_state_from_jax(st[1], tm)
    with pytest.raises(KeyError):
        opt_state_from_jax((st[0], (st[1][0]._replace(mu={}), st[1][1])), tm)


# ---- the slice at full width: the committed char-level model -----------

@pytest.fixture(scope="module")
def textgen():
    from deeplearning4j_tpu.zoo.models import TextGenerationLSTM as JText
    from deeplearning4j_tpu_torch.generation.decode import Vocab
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    vocab = Vocab.load()
    corpus = (REPO / "tests" / "resources" / "pretrained" /
              "corpus.txt").read_text(encoding="utf-8")[:4096]
    ids = np.array(vocab.encode(corpus), np.int64)
    return (JText().init_pretrained(),
            TextGenerationLSTM().init_pretrained(device="cpu"), ids)


def _windows(ids, t=60):
    starts = np.arange(0, len(ids) - t - 1, t)
    eye = np.eye(77, dtype=np.float32)
    return (eye[np.stack([ids[s:s + t] for s in starts])],
            np.stack([ids[s + 1:s + t + 1] for s in starts]))


def test_textgen_scores_like_jax(textgen):
    jm, tm, ids = textgen
    x, y = _windows(ids)
    _close(tm.output(x[:4]), jm.output(x[:4]), FWD_REL, "probs")
    probs = tm.output(x).numpy()
    n, t = y.shape
    p_true = probs[np.arange(n)[:, None], np.arange(t)[None, :], y]
    xent = -np.mean(np.log(np.maximum(p_true, 1e-9)))
    assert xent < 2.5, xent


def test_textgen_greedy_ids_match_jax(textgen):
    from deeplearning4j_tpu.generation.decode import \
        reference_decode as jax_decode
    from deeplearning4j_tpu_torch.generation.decode import reference_decode
    jm, tm, ids = textgen
    prompt = ids[:20].tolist()
    assert reference_decode(tm, prompt, 40) == jax_decode(jm, prompt, 40)


def test_rnn_time_step_whole_prompt_equals_token_by_token(textgen):
    _, tm, ids = textgen
    x = np.eye(77, dtype=np.float32)[ids[:20]][None]
    whole, c_whole = tm.rnn_time_step(x)
    carries = None
    for s in range(20):
        last, carries = tm.rnn_time_step(x[:, s], carries)
    _close(last[:, 0], whole[:, -1].numpy(), 1e-6, "last output")
    for name, (h, c) in c_whole.items():
        _close(carries[name][0], h.numpy(), 1e-6, name)
        _close(carries[name][1], c.numpy(), 1e-6, name)
    assert set(c_whole) == {"layer_0", "layer_1"}
