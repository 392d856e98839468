"""Models whose first parameters are nested, against the JAX package.

A ``TransformerEncoderBlock`` keeps its attention parameters one level
down (``params[block]["attn"]["Wqkv"]``), and its ``"attn"`` entry comes
first. A ``MultiLayerNetwork`` and a ``ComputationGraph`` that start with
such a block (on ``InputType.recurrent(16, 8)``, ending in an
``RnnOutputLayer``) are built in both packages from the same
configuration, the JAX params carried across, and held to each other:
``init``, ``output``, three Adam steps (both start from their own zero
moments) and, for the graph, three Sgd steps, whose loss is taken by the
graph's ``_loss``. Inputs and labels come from a numpy seed.

Bounds (ROADMAP's f32 defaults): outputs and loss rel 1e-5; post-step
params rel 1e-4 of each leaf's largest magnitude. Left out of the Adam
comparison by name: a packed ``bqkv``'s key-bias entries. Softmax is
invariant to a shift of every score of a row, so those entries have an
exactly zero gradient; both packages compute rounding noise there, and
Adam divides that noise by its own root mean square into steps of ±lr
(ROADMAP "Not faults"). Sgd moves them by the noise alone, so its
comparison keeps every entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serialization import (flatten_paths,
                                                           params_from_jax)
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
# the layer modules register their types for ``from_json``
from deeplearning4j_tpu_torch.nn.layers import attention, output  # noqa: F401

N, T, F, HEADS, CLASSES = 3, 8, 16, 2, 5
FWD_REL, TREE_REL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _key_bias(width):
    """Key-bias entries of a head-major packed bqkv ((head, which, dh))."""
    which = np.arange(3 * width).reshape(HEADS, 3, width // HEADS)
    return np.isin(np.arange(3 * width), which[:, 1].ravel())


def _close_tree(got, want, rel, what, skip_key_bias):
    from deeplearning4j_tpu.models.serialization import _flatten_with_paths
    got, want = flatten_paths(got), _flatten_with_paths(want)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        v = np.asarray(v, np.float32)
        g = got[k].detach().float().cpu().numpy()
        if skip_key_bias and k.endswith("bqkv"):
            keep = ~_key_bias(v.shape[0] // 3)
            g, v = g[keep], v[keep]
        err = np.abs(g - v).max()
        assert err <= rel * max(np.abs(v).max(), 1e-6), (what, k, err)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _updater(kind):
    from deeplearning4j_tpu.optimize.updaters import Adam, Sgd
    return Adam(1e-4) if kind == "adam" else Sgd(1e-2)


def _jax_conf(model, kind):
    """The JAX configuration: a block first, then the output layer."""
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers.attention import \
        TransformerEncoderBlock
    from deeplearning4j_tpu.nn.layers.output import RnnOutputLayer
    block = TransformerEncoderBlock(n_out=F, n_heads=HEADS, ffn_mult=2)
    out = RnnOutputLayer(n_out=CLASSES)
    b = NeuralNetConfiguration.Builder().seed(3).updater(_updater(kind))
    if model == "mln":
        return (b.list().layer(block).layer(out)
                .set_input_type(InputType.recurrent(F, T)).build())
    return (b.graph_builder().add_inputs("in")
            .set_input_types(InputType.recurrent(F, T))
            .add_layer("block", block, "in").add_layer("out", out, "block")
            .set_outputs("out").build())


def _pair(model, kind, seed=0):
    """(JAX model, port model with the JAX params, x, one-hot labels)."""
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JGraph
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JMLN
    jconf = _jax_conf(model, kind)
    if model == "mln":
        jm = JMLN(jconf).init()
        tm = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    else:
        jm = JGraph(jconf).init()
        tm = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    first = next(iter(tm.params.values()))
    assert isinstance(next(iter(first.values())), dict)   # nested first
    ts = jm.train_state
    params_from_jax(_np(ts.params), _np(ts.model_state), "cpu", model=tm)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, T, F)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (N, T))]
    return jm, tm, x, y


@pytest.mark.parametrize("model", ["mln", "graph"])
def test_nested_first_params_init_and_output_match_jax(model):
    jm, tm, x, _ = _pair(model, "adam")
    # the port's own Adam state: zero moments of every nested leaf, as
    # optax's
    _close_tree(tm.opt_state, _np(jm.train_state.opt_state), 0.0,
                "opt_state", False)
    st = flatten_paths(tm.opt_state)
    assert any(k.endswith("attn/Wqkv") for k in st)
    _close(tm.output(x), jm.output(jnp.asarray(x)), FWD_REL, "output")


@pytest.mark.parametrize("model,kind", [("mln", "adam"), ("graph", "adam"),
                                        ("graph", "sgd")])
def test_nested_first_params_three_steps_match_jax(model, kind):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    jm, tm, x, y = _pair(model, kind, seed=1)
    for _ in range(3):
        jm.fit(JDataSet(x, y))
        tm.fit(DataSet(x, y))
        assert tm.score() == pytest.approx(float(jm.score()), rel=FWD_REL)
    _close_tree(tm.params, _np(jm.train_state.params), TREE_REL, "params",
                kind == "adam")
    _close(tm.output(x), jm.output(jnp.asarray(x)), FWD_REL, "output")
    assert tm.iteration == 3
