"""The port's dropout family (nn/dropout.py), ``Layer.maybe_dropout`` and
``DropoutLayer`` against the JAX package on the CPU.

JAX's threefry and torch's Philox never give the same numbers, so the
draws are not compared. Instead:

- outside training (or with no generator) every kind is the identity;
- over 200,000 draws the statistics stay within 6 standard errors of
  their expectation: the kept fraction of Dropout and AlphaDropout
  (binomial, sd √(k(1-k)/n)), the mean and the variance of
  GaussianDropout and GaussianNoise (normal draws: sd of the mean σ/√n,
  of the variance σ²·√(2/n)), and AlphaDropout's mean 0 and variance 1
  on standard normal input (sd 1/√n, and 1.5·√(2/n) for the variance of
  its two-part mixture, whose tails are heavier than a normal's);
- with the same mask or noise injected, each kind equals the JAX
  package's formula within 1e-6 relative (the JAX draw is patched to
  return it);
- ``DropoutLayer`` and an ``IDropout`` field round-trip through
  ``configuration.json`` in both packages.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import dropout as jdrop
import deeplearning4j_tpu_torch.nn.layers.output  # noqa: F401 (serde)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import dropout as tdrop
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                            DropoutLayer)

N = 200_000
SE = 6.0     # standard errors allowed
KINDS = [("Dropout", dict(p=0.3)), ("AlphaDropout", dict(p=0.1)),
         ("GaussianDropout", dict(rate=0.4)),
         ("GaussianNoise", dict(stddev=0.25))]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name,kw", KINDS + [("float", dict(p=0.5))])
def test_eval_mode_and_no_generator_are_the_identity(name, kw):
    d = 0.5 if name == "float" else getattr(tdrop, name)(**kw)
    x = torch.randn(4, 7, generator=_gen())
    for layer in (DropoutLayer(name="d", dropout=d),
                  DenseLayer(name="h", n_out=3, dropout=d)):
        assert torch.equal(layer.maybe_dropout(x, LayerContext(
            train=False, generator=_gen())), x)
        assert torch.equal(layer.maybe_dropout(x, LayerContext(
            train=True)), x)
    y, _ = DropoutLayer(name="d", dropout=d).apply(
        {}, {}, x, LayerContext(train=False, generator=_gen()))
    assert torch.equal(y, x)


@pytest.mark.parametrize("p", [0.3, 0.75])
def test_dropout_keep_fraction_and_scale(p):
    x = torch.ones(N)
    y = DropoutLayer(name="d", dropout=p).apply(
        {}, {}, x, LayerContext(train=True, generator=_gen(1)))[0]
    keep = 1.0 - p
    kept = (y != 0).double().mean().item()
    assert abs(kept - keep) <= SE * math.sqrt(keep * p / N)
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / keep))
    # the same generator state gives the same mask: the draws are seeded
    again = tdrop.Dropout(p).apply_dropout(x, _gen(1))
    assert torch.equal(again, y)


def test_alpha_dropout_keeps_standard_moments():
    p = 0.1
    x = torch.randn(N, generator=_gen(2), dtype=torch.float64)
    d = tdrop.AlphaDropout(p)
    mask = d.draw(x, _gen(3))
    assert mask.dtype == torch.bool
    kept = mask.double().mean().item()
    assert abs(kept - (1 - p)) <= SE * math.sqrt(p * (1 - p) / N)
    y = d.apply_draw(x, mask)
    assert abs(y.mean().item()) <= SE / math.sqrt(N)
    assert abs(y.var().item() - 1.0) <= SE * math.sqrt(2.0 / N) * 1.5


@pytest.mark.parametrize("name,kw,x0,mean,sd", [
    ("GaussianDropout", dict(rate=0.4), 1.0, 1.0, math.sqrt(0.4 / 0.6)),
    ("GaussianNoise", dict(stddev=0.25), 0.0, 0.0, 0.25)])
def test_gaussian_kinds_moments(name, kw, x0, mean, sd):
    x = torch.full((N,), x0, dtype=torch.float64)
    y = getattr(tdrop, name)(**kw).apply_dropout(x, _gen(4))
    assert y.dtype == x.dtype
    assert abs(y.mean().item() - mean) <= SE * sd / math.sqrt(N)
    assert abs(y.var().item() - sd ** 2) <= SE * sd ** 2 * math.sqrt(2 / N)


@pytest.mark.parametrize("name,kw", KINDS)
def test_injected_draw_equals_the_jax_formula(name, kw, monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (6, 9)).astype(np.float32)
    t = getattr(tdrop, name)(**kw)
    j = getattr(jdrop, name)(**kw)
    if name in ("Dropout", "AlphaDropout"):
        draw = rng.uniform(size=x.shape) > 0.35
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(draw))
    else:
        draw = rng.normal(0, 1, x.shape).astype(np.float32)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype: jnp.asarray(draw))
    want = np.asarray(j.apply_dropout(jnp.asarray(x), jax.random.PRNGKey(0)))
    got = t.apply_draw(torch.from_numpy(x), torch.from_numpy(draw)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_dropout_layer_round_trips_through_configuration_json():
    from deeplearning4j_tpu.nn.config import \
        MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.inputs import InputType
    from deeplearning4j_tpu.nn.layers import feedforward as jff
    from deeplearning4j_tpu.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jconf = (NeuralNetConfiguration.Builder().seed(1).list()
             .layer(jff.DropoutLayer(dropout=0.2))
             .layer(jff.DenseLayer(n_out=5,
                                   dropout=jdrop.GaussianDropout(0.3)))
             .layer(jff.DropoutLayer(dropout=jdrop.AlphaDropout(0.1)))
             .layer(OutputLayer(n_out=3))
             .set_input_type(InputType.feed_forward(4)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    layers = conf.layers
    assert isinstance(layers[0], DropoutLayer) and layers[0].dropout == 0.2
    assert layers[1].dropout == tdrop.GaussianDropout(0.3)
    assert layers[2].dropout == tdrop.AlphaDropout(0.1)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    back = JConf.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    # the model: dropout in the train step only, from its generator
    m = MultiLayerNetwork(conf, device="cpu").init()
    assert m.num_params() == 4 * 5 + 5 + 5 * 3 + 3
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    before = m.output(x).numpy()
    np.testing.assert_array_equal(m.output(x).numpy(), before)
    w = m.params["layer_1"]["W"].clone()
    m.fit(DataSet(x, y))
    assert np.isfinite(m.score()) and not torch.equal(
        m.params["layer_1"]["W"], w)
