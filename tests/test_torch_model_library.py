"""The rest of the model library against the JAX package on the CPU:
reconstruction distributions, ``VariationalAutoencoder``,
``AutoEncoder``, layerwise ``pretrain``, ``LambdaLayer`` and
``SameDiffLayer``, the gradient check and the memory report.

Both packages build from the same ``configuration.json`` and the port
takes the JAX model's parameters (``params_from_jax``). The JAX package
draws the VAE's epsilon and the autoencoder's corruption from its keys;
the tests compute the same draws from the same keys and inject them into
the port (``eps=``, ``keep=``), which the JAX functions do not take.

Bounds (ROADMAP's f32 defaults): forward and loss rel 1e-5; gradients
and parameters after N steps 1e-4 of each array's largest magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (
    _ensure_registry, params_from_jax, restore_multi_layer_network,
    save_model)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import variational as TV

FWD_REL, TREE_REL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, rel, what=""):
    if isinstance(want, dict):
        for k in want:
            if not (isinstance(want[k], dict) and not want[k]):
                # (an empty dict: a parameterless layer's entry)
                _close(got[k], want[k], rel, f"{what}/{k}")
        return
    g = got.detach().float().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    err = np.abs(g - w).max()
    assert err <= rel * max(np.abs(w).max(), 1e-6), (what, err,
                                                      np.abs(w).max())


def pair(jconf):
    """The JAX model of ``jconf`` and the port's, from its JSON, with the
    JAX parameters and state."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    jm = JMLN(jconf).init()
    _ensure_registry()
    tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_jax(_np(jm.train_state.params),
                    _np(jm.train_state.model_state), model=tm)
    return jm, tm


def _builder(seed=3, updater=None):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.optimize.updaters import Adam
    return NeuralNetConfiguration.Builder().seed(seed).updater(
        updater or Adam(1e-2)).list()


def _x(n, f, seed=0, unit=False):
    rng = np.random.default_rng(seed)
    if unit:
        return rng.uniform(size=(n, f)).astype(np.float32)
    return rng.normal(size=(n, f)).astype(np.float32)


# ---------------------------------------------------------------------------
# reconstruction distributions
# ---------------------------------------------------------------------------

def _dists():
    from deeplearning4j_tpu.nn.layers import variational as JV
    from deeplearning4j_tpu.ops.activations import Activation as JA
    from deeplearning4j_tpu.ops.losses import LossFunction as JL
    from deeplearning4j_tpu_torch.ops.activations import Activation as TA
    from deeplearning4j_tpu_torch.ops.losses import LossFunction as TL
    return {
        "gaussian": (JV.GaussianReconstructionDistribution(),
                     TV.GaussianReconstructionDistribution()),
        "gaussian_tanh": (
            JV.GaussianReconstructionDistribution(JA.TANH),
            TV.GaussianReconstructionDistribution(TA.TANH)),
        "bernoulli": (JV.BernoulliReconstructionDistribution(),
                      TV.BernoulliReconstructionDistribution()),
        "exponential": (JV.ExponentialReconstructionDistribution(),
                        TV.ExponentialReconstructionDistribution()),
        "loss_wrapper": (JV.LossFunctionWrapper(),
                         TV.LossFunctionWrapper()),
        "loss_wrapper_mse": (JV.LossFunctionWrapper(loss=JL.MSE),
                             TV.LossFunctionWrapper(loss=TL.MSE)),
        "composite": (
            JV.CompositeReconstructionDistribution(components=(
                (3, JV.GaussianReconstructionDistribution()),
                (2, JV.BernoulliReconstructionDistribution()),
                (1, JV.ExponentialReconstructionDistribution()))),
            TV.CompositeReconstructionDistribution(components=(
                (3, TV.GaussianReconstructionDistribution()),
                (2, TV.BernoulliReconstructionDistribution()),
                (1, TV.ExponentialReconstructionDistribution())))),
    }


@pytest.mark.parametrize("name", sorted(_dists()))
def test_reconstruction_distribution_matches_jax(name):
    jd, td = _dists()[name]
    n_feat = 6
    n_par = (jd.total_params() if name == "composite"
             else n_feat * jd.params_per_feature())
    x = _x(5, n_feat, seed=1, unit=True)
    p = _x(5, n_par, seed=2)
    _close(td.log_prob(torch.from_numpy(x), torch.from_numpy(p)),
           jd.log_prob(jnp.asarray(x), jnp.asarray(p)), FWD_REL, "log_prob")
    _close(td.mean(torch.from_numpy(p)), jd.mean(jnp.asarray(p)), FWD_REL,
           "mean")


# ---------------------------------------------------------------------------
# VariationalAutoencoder
# ---------------------------------------------------------------------------

N_IN, LATENT = 12, 4


def _vae_conf(dist="bernoulli", samples=2):
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import variational as JV
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    d = {"bernoulli": JV.BernoulliReconstructionDistribution(),
         "gaussian": JV.GaussianReconstructionDistribution(),
         "composite": JV.CompositeReconstructionDistribution(components=(
             (8, JV.BernoulliReconstructionDistribution()),
             (4, JV.GaussianReconstructionDistribution())))}[dist]
    return (_builder().layer(JV.VariationalAutoencoder(
        n_out=LATENT, encoder_layer_sizes=(10, 8), decoder_layer_sizes=(8,),
        activation=Activation.TANH, reconstruction_distribution=d,
        num_samples=samples))
        .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
        .set_input_type(InputType.feed_forward(N_IN)).build())


def _jax_eps(key, shape, n):
    """The JAX VAE's draws: normal(fold_in(key, s)) for each sample."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, s), shape,
                                         jnp.float32)) for s in range(n)]


def _grad_of(fn, params):
    leaves = {k: v for k, v in _flat(params).items()}
    req = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    loss = fn(_unflat(req))
    gs = torch.autograd.grad(loss, list(req.values()))
    return loss, _unflat(dict(zip(req, gs)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _unflat(flat):
    out = {}
    for p, v in flat.items():
        node = out
        parts = p.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


@pytest.mark.parametrize("dist", ["bernoulli", "gaussian", "composite"])
def test_vae_forward_and_elbo_match_jax(dist):
    jm, tm = pair(_vae_conf(dist))
    jl, tl = jm.layers[0], tm.layers[0]
    jp = jm.train_state.params[jl.name]
    tp = tm.params[tl.name]
    x = _x(7, N_IN, seed=3, unit=True)
    # supervised forward: the latent mean, and the whole network
    from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    _close(tl.apply(tp, {}, torch.from_numpy(x), LayerContext())[0],
           jl.apply(jp, {}, jnp.asarray(x), JCtx())[0], FWD_REL, "mean")
    _close(tm.output(x), jm.output(x), FWD_REL, "output")
    # the negative ELBO with the JAX draws injected, and its gradients
    key = jax.random.PRNGKey(5)
    eps = _jax_eps(key, (7, LATENT), tl.num_samples)
    jloss, jg = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), key))(jp)
    tloss, tg = _grad_of(lambda p: tl.pretrain_loss(
        p, torch.from_numpy(x), eps=[torch.from_numpy(e) for e in eps]), tp)
    assert abs(float(tloss) - float(jloss)) <= FWD_REL * abs(float(jloss))
    _close(tg, _np(jg), TREE_REL, "grad")


def test_vae_extras_match_jax():
    jm, tm = pair(_vae_conf("gaussian"))
    jl, tl = jm.layers[0], tm.layers[0]
    jp, tp = jm.train_state.params[jl.name], tm.params[tl.name]
    x = _x(5, N_IN, seed=4)
    z = _x(5, LATENT, seed=6)
    _close(tl.reconstruct(tp, torch.from_numpy(x)),
           jl.reconstruct(jp, jnp.asarray(x)), FWD_REL, "reconstruct")
    _close(tl.generate_at_mean_given_z(tp, torch.from_numpy(z)),
           jl.generate_at_mean_given_z(jp, jnp.asarray(z)), FWD_REL,
           "generate")
    key = jax.random.PRNGKey(9)
    eps = _jax_eps(key, (5, LATENT), 3)
    _close(tl.reconstruction_log_probability(
        tp, torch.from_numpy(x), num_samples=3,
        eps=[torch.from_numpy(e) for e in eps]),
        jl.reconstruction_log_probability(jp, jnp.asarray(x), key,
                                          num_samples=3), FWD_REL,
        "log p(x)")
    with pytest.raises(ValueError, match="samples"):
        tl.pretrain_loss(tp, torch.from_numpy(x), eps=[])


def test_vae_pretrain_steps_match_jax_with_its_draws():
    """``pretrain_layer`` on the JAX side (its key per batch) against the
    port's ``pretrain_step`` fed the same draws, 4 batches."""
    jm, tm = pair(_vae_conf("bernoulli", samples=1))
    xs = [_x(6, N_IN, seed=10 + i, unit=True) for i in range(4)]
    r = jm._rng
    eps = []
    for x in xs:
        r, k = jax.random.split(r)
        eps.append(_jax_eps(k, (x.shape[0], LATENT), 1))
    jm.pretrain_layer(0, [DataSet(x) for x in xs])
    name = tm.layers[0].name
    tx = tm.conf.global_config.updater.to_transform()
    lp, opt = tm.params[name], tx.init(tm.params[name])
    for x, e in zip(xs, eps):
        lp, opt, loss = tm.pretrain_step(
            0, tx, lp, opt, x, eps=[torch.from_numpy(v) for v in e])
    _close(lp, _np(jm.train_state.params[name]), TREE_REL, "vae params")
    assert abs(float(loss) - jm._last_loss) <= FWD_REL * abs(jm._last_loss)


# ---------------------------------------------------------------------------
# AutoEncoder and layerwise pretraining
# ---------------------------------------------------------------------------

def _ae_conf(corruption=0.0, updater=None):
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.feedforward import (AutoEncoder,
                                                          DenseLayer)
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.activations import Activation
    from deeplearning4j_tpu.ops.losses import LossFunction
    return (_builder(updater=updater)
            .layer(DenseLayer(n_out=10, activation=Activation.TANH))
            .layer(AutoEncoder(n_out=6, activation=Activation.SIGMOID,
                               corruption_level=corruption))
            .layer(AutoEncoder(n_out=5, activation=Activation.SIGMOID,
                               corruption_level=corruption))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(N_IN)).build())


def test_autoencoder_layer_matches_jax():
    jm, tm = pair(_ae_conf(corruption=0.3))
    jl, tl = jm.layers[1], tm.layers[1]
    jp, tp = jm.train_state.params[jl.name], tm.params[tl.name]
    assert set(tp) == {"W", "b", "vb"}
    h = _x(5, 10, seed=2)
    from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    _close(tl.apply(tp, {}, torch.from_numpy(h), LayerContext())[0],
           jl.apply(jp, {}, jnp.asarray(h), JCtx())[0], FWD_REL, "encode")
    y = _x(5, 6, seed=3)
    _close(tl.reconstruct(tp, torch.from_numpy(y)),
           jl.reconstruct(jp, jnp.asarray(y)), FWD_REL, "reconstruct")
    # the denoising loss with JAX's corruption injected, and gradients
    key = jax.random.PRNGKey(2)
    keep = np.asarray(jax.random.bernoulli(key, 0.7, h.shape))
    jloss, jg = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(h), key))(jp)
    tloss, tg = _grad_of(lambda p: tl.pretrain_loss(
        p, torch.from_numpy(h), keep=torch.from_numpy(keep)), tp)
    assert abs(float(tloss) - float(jloss)) <= FWD_REL * abs(float(jloss))
    _close(tg, _np(jg), TREE_REL, "grad")
    # corruption from a generator keeps about 70%
    g = torch.Generator().manual_seed(0)
    l_noisy = tl.pretrain_loss(tp, torch.from_numpy(_x(400, 10)),
                               generator=g)
    assert torch.isfinite(l_noisy)


def test_pretrain_layer_matches_jax_over_steps():
    from deeplearning4j_tpu.optimize.updaters import Sgd
    jm, tm = pair(_ae_conf(0.0, updater=Sgd(0.5)))
    xs = [_x(8, N_IN, seed=20 + i) for i in range(5)]
    jm.pretrain_layer(1, [DataSet(x) for x in xs], epochs=2)
    tm.pretrain_layer(1, [DataSet(x) for x in xs], epochs=2)
    for l in tm.layers:
        _close(tm.params[l.name], _np(jm.train_state.params[l.name]),
               TREE_REL, l.name)
    assert abs(tm.score() - jm._last_loss) <= FWD_REL * jm._last_loss


def test_pretrain_all_then_fit_matches_jax():
    from deeplearning4j_tpu.optimize.updaters import Sgd
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    jm, tm = pair(_ae_conf(0.0, updater=Sgd(0.3)))
    xs = [_x(8, N_IN, seed=30 + i) for i in range(3)]
    jm.pretrain([JDS(x) for x in xs])
    tm.pretrain([DataSet(x) for x in xs])
    y = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    for x in xs:
        jm.fit(JDS(x, y))
        tm.fit(DataSet(x, y))
    for l in tm.layers:
        _close(tm.params[l.name], _np(jm.train_state.params[l.name]),
               TREE_REL, l.name)
    # layers without pretrain_loss are passed over
    before = {k: v.clone() for k, v in tm.params["layer_0"].items()}
    tm.pretrain_layer(0, [DataSet(xs[0])])
    assert all(torch.equal(before[k], tm.params["layer_0"][k])
               for k in before)


# ---------------------------------------------------------------------------
# LambdaLayer and SameDiffLayer
# ---------------------------------------------------------------------------

def _custom_models():
    """The same network in both packages: Dense(8) -> Lambda(x * sigmoid
    x) -> SameDiff(W (8, 6), b (6): tanh(x W + b)) -> Output(3). The
    custom layers hold functions, so each package builds its own conf;
    the port takes the JAX parameters."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JD
    from deeplearning4j_tpu.nn.layers.misc import (LambdaLayer as JLam,
                                                   SameDiffLayer as JSD)
    from deeplearning4j_tpu.nn.layers.output import OutputLayer as JO
    from deeplearning4j_tpu.ops.losses import LossFunction as JLF
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.misc import (LambdaLayer,
                                                         SameDiffLayer)
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
    shapes = {"W": (8, 6), "b": (6,)}
    ff6 = lambda it: it.__class__(6)
    jconf = (_builder(updater=JSgd(0.1)).layer(JD(n_out=8))
             .layer(JLam(fn=lambda x: x * jax.nn.sigmoid(x)))
             .layer(JSD(param_shapes=shapes,
                        fn=lambda p, x: jnp.tanh(x @ p["W"] + p["b"]),
                        out_type=ff6))
             .layer(JO(n_out=3, loss=JLF.MCXENT))
             .set_input_type(JIT.feed_forward(N_IN)).build())
    tconf = (NeuralNetConfiguration.Builder().seed(3).updater(Sgd(0.1))
             .list().layer(DenseLayer(n_out=8))
             .layer(LambdaLayer(fn=lambda x: x * torch.sigmoid(x)))
             .layer(SameDiffLayer(
                 param_shapes=shapes,
                 fn=lambda p, x: torch.tanh(x @ p["W"] + p["b"]),
                 out_type=ff6))
             .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
             .set_input_type(InputType.feed_forward(N_IN)).build())
    jm = JMLN(jconf).init()
    tm = MultiLayerNetwork(tconf, device="cpu").init()
    assert set(tm.params["layer_2"]) == {"W", "b"}
    params_from_jax(_np(jm.train_state.params),
                    _np(jm.train_state.model_state), model=tm)
    return jm, tm


def test_lambda_and_samediff_forward_and_gradients_match_jax():
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
    jm, tm = _custom_models()
    x = _x(9, N_IN, seed=5)
    y = np.eye(3, dtype=np.float32)[np.arange(9) % 3]
    _close(tm.output(x), jm.output(x), FWD_REL, "output")
    jloss, jg = jax.value_and_grad(lambda p: jm._loss(
        p, jm.train_state.model_state, jnp.asarray(x), jnp.asarray(y), None,
        None, None, jnp.zeros((), jnp.int32))[0])(jm.train_state.params)
    tloss, tg = _grad_of(lambda p: tm._loss(
        p, tm.model_state, torch.from_numpy(x), torch.from_numpy(y), None,
        None, None, 0)[0], tm.params)
    assert abs(float(tloss) - float(jloss)) <= FWD_REL * abs(float(jloss))
    _close(tg, _np(jg), TREE_REL, "grad")
    for _ in range(3):
        jm.fit(JDS(x, y))
        tm.fit(DataSet(x, y))
    _close(tm.params, _np(jm.train_state.params), TREE_REL, "params")


def test_samediff_default_and_custom_init():
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.misc import SameDiffLayer
    g = torch.Generator().manual_seed(0)
    sd = SameDiffLayer(param_shapes={"W": (400, 3)}, fn=None)
    w = sd.initialize(g, InputType.feed_forward(400))["W"]
    assert w.shape == (400, 3) and abs(float(w.std()) - 0.05) < 0.01
    sd2 = SameDiffLayer(param_shapes={"a": (2,)},
                        init_fn=lambda gen, name, shape: torch.full(shape,
                                                                    7.0))
    assert torch.equal(sd2.initialize(g, None)["a"], torch.full((2,), 7.0))


# ---------------------------------------------------------------------------
# the gradient check
# ---------------------------------------------------------------------------

def _library_mln():
    """Dense + AutoEncoder + MixtureOfExperts + SameDiffLayer + output
    (chip_smoke's gradient-check model), on the CPU."""
    import chip_smoke
    return chip_smoke.library_mln("cpu")


def _cls_data():
    import chip_smoke
    return chip_smoke.library_data()


def test_gradient_check_passes_on_the_library_model():
    from deeplearning4j_tpu_torch.gradientcheck import check_model_gradients
    assert check_model_gradients(_library_mln(), _cls_data(),
                                 max_params_per_leaf=6, verbose=False)


def test_gradient_check_passes_on_a_vae_model_and_a_graph():
    from deeplearning4j_tpu_torch.gradientcheck import check_model_gradients
    jm, tm = pair(_vae_conf("gaussian"))
    assert check_model_gradients(tm, DataSet(_x(5, N_IN), np.eye(
        3, dtype=np.float32)[[0, 1, 2, 0, 1]]), max_params_per_leaf=5,
        verbose=False)
    from test_torch_fit_loop import _graph_pair
    cg, _ = _graph_pair()
    x = _x(4, 5, seed=1)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    assert check_model_gradients(cg, DataSet(x, y), max_params_per_leaf=4,
                                 verbose=False)


class _ScaledGrad(torch.autograd.Function):
    """Identity forward whose backward is scaled by 1.5: a wrong
    gradient the check must catch."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


def test_gradient_check_catches_a_wrong_backward():
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(4, 3)))
    params = {"l": {"W": torch.from_numpy(rng.normal(size=(3, 2))),
                    "b": torch.zeros(2, dtype=torch.float64)}}

    def good(p):
        return torch.sum(torch.tanh(a @ p["l"]["W"] + p["l"]["b"]) ** 2)

    def bad(p):
        return torch.sum(torch.tanh(_ScaledGrad.apply(a @ p["l"]["W"])
                                    + p["l"]["b"]) ** 2)
    assert check_gradients(good, params, verbose=False)
    assert not check_gradients(bad, params, verbose=False)


def test_gradient_check_subsamples_the_jax_entries(capsys):
    """Both packages check the same entries: the same default_rng draws
    over the leaves in sorted-key order (a leaf over the limit), and the
    same verdict on the same function."""
    import deeplearning4j_tpu.gradientcheck.gradient_check_util as JG
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    rng = np.random.default_rng(3)
    w = rng.normal(size=(9, 5))
    a = rng.normal(size=(4, 9))
    pj = {"z": {"W": jnp.asarray(w)}, "a": {"v": jnp.asarray(w[0])}}
    pt = {"z": {"W": torch.from_numpy(w)}, "a": {"v": torch.from_numpy(w[0])}}
    jok = JG.check_gradients(lambda p: jnp.sum(
        jnp.sin(jnp.asarray(a) @ p["z"]["W"]) * p["a"]["v"][:5]), pj,
        max_params_per_leaf=4)
    jout = capsys.readouterr().out
    tok = check_gradients(lambda p: torch.sum(torch.sin(
        torch.from_numpy(a) @ p["z"]["W"]) * p["a"]["v"][:5]), pt,
        max_params_per_leaf=4)
    tout = capsys.readouterr().out
    assert jok and tok
    assert jout.split(",")[0] == tout.split(",")[0] == \
        "gradient check: 8 params checked"


# ---------------------------------------------------------------------------
# the memory report
# ---------------------------------------------------------------------------

def _jax_graph_report(conf, name):
    """The JAX package's per-layer report of a graph configuration, built
    from its own LayerMemoryReport, eval_shape and updater-slot table (its
    ``memory_report`` takes a MultiLayerConfiguration only)."""
    from deeplearning4j_tpu.nn import memory as JM
    conf.resolve()
    key = jax.random.PRNGKey(0)
    reps = []
    nodes = {n.name: n for n in conf.nodes}
    for nm in conf.topological_order():
        layer = nodes[nm].layer
        if layer is None:
            continue
        it = conf.layer_input_type(nm)
        shapes = jax.eval_shape(lambda l=layer, t=it: l.initialize(key, t))
        pcount = sum(int(np.prod(s.shape))
                     for s in jax.tree_util.tree_leaves(shapes))
        upd = layer.updater or conf.global_config.updater
        reps.append(JM.LayerMemoryReport(
            layer_name=layer.name, layer_type=type(layer).__name__,
            parameter_count=pcount,
            activation_elements_per_example=JM._nelems(
                layer.output_type(it).shape()),
            updater_state_slots=JM._UPDATER_STATE_SLOTS.get(
                type(upd).__name__, 2)))
    return JM.NetworkMemoryReport(reps, name)


def _bert_conf(vocab=30522, width=768, heads=12, blocks=12, seq=128):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.attention import (
        LearnedPositionalEmbedding, TransformerEncoderBlock)
    from deeplearning4j_tpu.nn.layers.feedforward import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu.optimize.updaters import Adam
    b = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-4))
         .compute_dtype("bfloat16").list()
         .layer(EmbeddingSequenceLayer(n_in=vocab, n_out=width))
         .layer(LearnedPositionalEmbedding(max_len=seq)))
    for _ in range(blocks):
        b = b.layer(TransformerEncoderBlock(n_out=width, n_heads=heads,
                                            ffn_mult=4))
    return (b.layer(RnnOutputLayer(n_out=vocab))
            .set_input_type(InputType.recurrent(1, seq)).build())


def _memory_confs():
    from deeplearning4j_tpu.zoo import models as JZ
    return {
        "LeNet": lambda: JZ.LeNet().conf(),
        "TextGenerationLSTM": lambda: JZ.TextGenerationLSTM().conf(),
        "BERT": _bert_conf,
        "ResNet50": lambda: JZ.ResNet50(
            num_classes=200, height=64, width=64, channels=3,
            compute_dtype="bfloat16", fused_blocks=True, fused_impl="xla",
            s2d_stem=True).conf(),
    }


@pytest.mark.parametrize("name", ["LeNet", "TextGenerationLSTM", "BERT",
                                  "ResNet50"])
def test_memory_report_json_matches_jax(name):
    from deeplearning4j_tpu.nn import memory as JM
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.memory import memory_report
    jconf = _memory_confs()[name]()
    _ensure_registry()
    if hasattr(jconf, "layers"):
        want = JM.memory_report(jconf, name)
        tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    else:
        want = _jax_graph_report(jconf, name)
        tconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    got = memory_report(tconf, name)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.total_bytes(32) == want.total_bytes(32)
    assert str(got) == str(want)


def test_memory_report_counts_match_the_model_and_device_analysis_cpu():
    from deeplearning4j_tpu_torch.nn.memory import (device_memory_analysis,
                                                    memory_report)
    tm = _library_mln()
    rep = memory_report(tm.conf)
    assert rep.total_parameters == tm.num_params()
    assert device_memory_analysis(tm, batch_size=4) == {}
    assert device_memory_analysis(tm, batch_size=4, train=True) == {}


def test_flight_recorder_memory_keeps_its_keys_and_adds_the_report(tmp_path):
    from deeplearning4j_tpu_torch.observe.flight_recorder import \
        FlightRecorder
    tm = _library_mln()
    sec = FlightRecorder(str(tmp_path))._memory_section(tm, "crash")
    an = sec["analytic"]
    assert an["param_bytes"] == 4 * tm.num_params()
    assert an["device"] == "cpu"
    assert an["total_parameters"] == tm.num_params()
    assert [l["type"] for l in an["layers"]] == [
        "DenseLayer", "AutoEncoder", "MixtureOfExperts", "SameDiffLayer",
        "OutputLayer"]


# ---------------------------------------------------------------------------
# checkpoints of the new parameter trees
# ---------------------------------------------------------------------------

def test_new_parameter_trees_round_trip_through_both_packages(tmp_path):
    """A VAE (nested enc/dec), AutoEncoder (vb) and MoE (stacked experts,
    aux-loss state) network: the JAX zip restores in the port and the
    port's zip in JAX, outputs equal."""
    from deeplearning4j_tpu.models.serialization import (
        restore_multi_layer_network as jrestore, save_model as jsave)
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import variational as JV
    from deeplearning4j_tpu.nn.layers.feedforward import (AutoEncoder,
                                                          MixtureOfExperts)
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu.ops.losses import LossFunction
    jconf = (_builder()
             .layer(JV.VariationalAutoencoder(
                 n_out=6, encoder_layer_sizes=(9,),
                 decoder_layer_sizes=(7, 5)))
             .layer(AutoEncoder(n_out=5))
             .layer(MixtureOfExperts(n_out=5, num_experts=3, hidden=4))
             .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
             .set_input_type(InputType.feed_forward(N_IN)).build())
    jm, tm = pair(jconf)
    assert tm.params["layer_0"]["enc"]["W0"].shape == (N_IN, 9)
    assert tm.params["layer_2"]["w_in"].shape == (3, 5, 4)
    x = _x(5, N_IN, seed=8)
    _close(tm.output(x), jm.output(x), FWD_REL, "pair")
    jsave(jm, str(tmp_path / "j.zip"))
    t2 = restore_multi_layer_network(str(tmp_path / "j.zip"), device="cpu")
    assert torch.equal(t2.output(x), tm.output(x))
    save_model(tm, str(tmp_path / "t.zip"))
    j2 = jrestore(str(tmp_path / "t.zip"))
    _close(np.asarray(j2.output(x)), jm.output(x), FWD_REL, "back")
    with pytest.raises(ValueError, match="shape"):
        bad = _np(jm.train_state.params)
        bad["layer_2"]["w_in"] = bad["layer_2"]["w_in"][:, :4]
        params_from_jax(bad, _np(jm.train_state.model_state), model=tm)
