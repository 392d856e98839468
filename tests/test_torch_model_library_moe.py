"""The mixture-of-experts layer against the JAX package on the CPU: the
router (``route_top_k``), the expert FFN (``moe_ffn``), the
``MixtureOfExperts`` layer, and its auxiliary loss in both model types'
training loss.

Bounds: the dispatch tensor is a 0/1 tensor and equal exactly; combine
weights, aux and z losses within 1e-6 (f32 softmax of the same logits);
the FFN output within 1e-4 of its largest magnitude (three einsums in
another summation order); losses rel 1e-5, gradients and parameters
after N steps 1e-4 of each array's largest (ROADMAP's f32 defaults).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.parallel import moe as TM

from test_torch_model_library import _close, _grad_of, _np, pair

ROUTE_TOL, FFN_REL = 1e-6, 1e-4


def _logits(t, e, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(t, e)).astype(np.float32) * 2.0


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 3), (2, 40), (3, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_route_top_k_matches_jax(k, capacity, masked):
    from deeplearning4j_tpu.parallel import moe as JM
    t, e = 40, 6
    lg = _logits(t, e, seed=k * 10 + capacity)
    lg[3] = lg[4]                        # a tie between two tokens' rows
    lg[5, :2] = lg[5, :2].max()          # a tie between two experts
    tm = None
    if masked:
        tm = (np.arange(t) % 5 != 2).astype(np.float32)
    jd, jc, ja, jz = JM.route_top_k(jnp.asarray(lg), k, capacity,
                                    None if tm is None else jnp.asarray(tm))
    td, tc, ta, tz = TM.route_top_k(torch.from_numpy(lg), k, capacity,
                                    None if tm is None
                                    else torch.from_numpy(tm))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= ROUTE_TOL
    assert abs(float(ta) - float(ja)) <= ROUTE_TOL
    assert abs(float(tz) - float(jz)) <= ROUTE_TOL * max(1.0, float(jz))
    if capacity == 3:                    # the capacity drops tokens
        assert td.sum() < k * (t if tm is None else tm.sum())
    if tm is not None:                   # a masked token takes no slot
        assert td.numpy()[tm == 0].sum() == 0


def _ffn_inputs(seed, d=6, f=5, e=4, shape=(3, 7)):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    return (n(*shape, d), n(d, e), n(e, d, f), n(e, f), n(e, f, d), n(e, d))


@pytest.mark.parametrize("act", ["default", "tanh"])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_matches_jax(act, masked):
    from deeplearning4j_tpu.parallel import moe as JM
    arrs = _ffn_inputs(1)
    tmask = None
    if masked:
        tmask = (np.arange(21).reshape(3, 7) % 4 != 1).astype(np.float32)
    kw_j = {} if act == "default" else {"activation": jnp.tanh}
    kw_t = {} if act == "default" else {"activation": torch.tanh}
    j = JM.moe_ffn(*map(jnp.asarray, arrs), top_k=2, capacity_factor=1.0,
                   token_mask=None if tmask is None else jnp.asarray(tmask),
                   **kw_j)
    t = TM.moe_ffn(*map(torch.from_numpy, arrs), top_k=2,
                   capacity_factor=1.0,
                   token_mask=None if tmask is None
                   else torch.from_numpy(tmask), **kw_t)
    _close(t.y, np.asarray(j.y), FFN_REL, "y")
    assert abs(float(t.aux_loss) - float(j.aux_loss)) <= ROUTE_TOL
    assert abs(float(t.router_z_loss) - float(j.router_z_loss)) <= \
        ROUTE_TOL * max(1.0, float(j.router_z_loss))
    if tmask is not None:                # masked tokens come out as 0
        assert torch.all(t.y[torch.from_numpy(tmask) == 0] == 0)


def test_expert_mesh_raises_naming_item_15():
    with pytest.raises(NotImplementedError, match="item 15"):
        TM.set_default_mesh(object())


def _moe_conf(seq=False, updater=None):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import (DenseLayer,
                                                          MixtureOfExperts)
    from deeplearning4j_tpu.nn.layers.output import (OutputLayer,
                                                     RnnOutputLayer)
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    from deeplearning4j_tpu.optimize.updaters import Sgd
    b = (NeuralNetConfiguration.Builder().seed(7)
         .updater(updater or Sgd(0.2)).list()
         .layer(DenseLayer(n_out=8, activation=Activation.RELU))
         .layer(MixtureOfExperts(n_out=8, num_experts=4, hidden=12, top_k=2,
                                 capacity_factor=1.0, aux_weight=0.5,
                                 z_weight=0.01,
                                 activation=Activation.GELU)))
    if seq:
        return (b.layer(RnnOutputLayer(n_out=3, loss=LossFunction.MCXENT))
                .set_input_type(InputType.recurrent(5, 6)).build())
    return (b.layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(5)).build())


def _cls(n, seed, seq=False):
    rng = np.random.default_rng(seed)
    if seq:
        x = rng.normal(size=(n, 6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, 6))]
        m = (rng.uniform(size=(n, 6)) > 0.3).astype(np.float32)
        m[:, 0] = 1
        return x, y, m
    x = rng.normal(size=(n, 5)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)], None


@pytest.mark.parametrize("seq", [False, True])
def test_moe_network_loss_gradients_and_steps_match_jax(seq):
    """The aux loss is in both packages' training loss; the loss, its
    gradients, and the parameters after 4 Sgd steps agree."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    jm, tm = pair(_moe_conf(seq))
    x, y, m = _cls(16, 3, seq)
    args_j = (jnp.asarray(x), jnp.asarray(y),
              None if m is None else jnp.asarray(m), None)
    args_t = (torch.from_numpy(x), torch.from_numpy(y),
              None if m is None else torch.from_numpy(m), None)
    (jloss, jst), jg = jax.value_and_grad(
        lambda p: jm._loss(p, jm.train_state.model_state, *args_j, None,
                           jnp.zeros((), jnp.int32)), has_aux=True)(
        jm.train_state.params)
    tloss, tg = _grad_of(lambda p: tm._loss(p, tm.model_state, *args_t,
                                            None, 0)[0], tm.params)
    aux = float(jst["layer_1"]["moe_aux_loss"])
    assert aux > 0.1                     # a real term of the loss
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _, tst = tm._loss(tm.params, tm.model_state, *args_t, None, 0)
    assert abs(float(tst["layer_1"]["moe_aux_loss"]) - aux) <= 1e-5 * aux
    _close(tg, _np(jg), 1e-4, "grad")
    for _ in range(4):
        jm.fit(JDS(x, y, m, m if seq else None))
        tm.fit(DataSet(x, y, m, m if seq else None))
    _close(tm.params, _np(jm.train_state.params), 1e-4, "params")
    assert abs(tm.score() - float(jm.score())) <= 1e-5 * abs(jm.score())


def test_masked_sequence_tokens_come_out_zero_and_take_no_slot():
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    jm, tm = pair(_moe_conf(True))
    layer = tm.layers[1]
    x, _, m = _cls(4, 5, True)
    h = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 6, 8)).astype(np.float32))
    y, st = layer.apply(tm.params[layer.name], {}, h,
                        LayerContext(mask=torch.from_numpy(m)))
    assert torch.all(y[torch.from_numpy(m) == 0] == 0)
    assert torch.any(y[torch.from_numpy(m) == 1] != 0)
    # the masked rows do not move the unmasked rows' answers
    h2 = h.clone()
    h2[torch.from_numpy(m) == 0] = 100.0
    y2, st2 = layer.apply(tm.params[layer.name], {}, h2,
                          LayerContext(mask=torch.from_numpy(m)))
    assert torch.equal(y, y2) and torch.equal(st["moe_aux_loss"],
                                              st2["moe_aux_loss"])


def test_moe_in_a_graph_adds_its_aux_loss():
    """The ComputationGraph's loss holds the aux term, as the JAX graph's
    does."""
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JCG
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import MixtureOfExperts
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.serialization import \
        _ensure_registry
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    jconf = (NeuralNetConfiguration.Builder().seed(2).updater(Sgd(0.1))
             .graph_builder().add_inputs("in")
             .set_input_types(InputType.feed_forward(5))
             .add_layer("moe", MixtureOfExperts(n_out=6, num_experts=3,
                                                hidden=4, aux_weight=1.0),
                        "in")
             .add_layer("out", OutputLayer(n_out=3), "moe")
             .set_outputs("out").build())
    jm = JCG(jconf).init()
    _ensure_registry()
    tm = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    params_from_jax(_np(jm.train_state.params),
                    _np(jm.train_state.model_state), model=tm)
    x, y, _ = _cls(12, 9)
    jl, jst = jm._loss(jm.train_state.params, jm.train_state.model_state,
                       (jnp.asarray(x),), (jnp.asarray(y),), None, None,
                       None, jnp.zeros((), jnp.int32))
    tl, tst = tm._loss(tm.params, tm.model_state, (torch.from_numpy(x),),
                       (torch.from_numpy(y),), None, None, None, 0)
    aux = float(tst["moe"]["moe_aux_loss"])
    assert aux > 0.5
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
