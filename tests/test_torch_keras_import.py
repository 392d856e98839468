"""The port's Keras importer on models that Keras builds at test time, on
the CPU: each against Keras's own prediction (the bounds of
tests/test_keras_import.py, whose cases these mirror) and against the JAX
package's import of the same file within 1e-5 of the JAX output's largest
magnitude (the same f32 arithmetic in other orders). Then the custom
stateless Keras-3 layer through ``register_custom_layer``, the
cross-attention refusal, and the committed full-width configurations
(BERT-base, InceptionV3 at 299) held to what
``tools/keras_card_resources.py`` writes from Keras now.
"""

import json
import os
import sys

import numpy as np
import pytest

keras = pytest.importorskip("keras")

from deeplearning4j_tpu.modelimport.keras import (  # noqa: E402
    import_keras_model_and_weights as jax_import)
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    Hdf5Archive,
    import_keras_model_and_weights,
    import_keras_sequential_model_and_weights,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
JAX_REL = 1e-5


@pytest.fixture(scope="module")
def L():
    from keras import layers
    return layers


def _check(path, kmodel, x, rtol=2e-4, atol=2e-5, sequential=False):
    """The port's import of ``path`` against Keras and the JAX import."""
    imp = (import_keras_sequential_model_and_weights if sequential
           else import_keras_model_and_weights)
    model = imp(path, device="cpu")
    ours = model.output(x).detach().numpy()
    theirs = np.asarray(kmodel.predict(x, verbose=0))
    np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=atol)
    ref = np.asarray(jax_import(path).output(x))
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= JAX_REL * np.abs(ref).max()
    return model


def _save(km, tmp_path, name):
    p = str(tmp_path / name)
    km.save(p)
    return p


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class TestSequential:
    def test_mlp(self, tmp_path, L):
        km = keras.Sequential([keras.Input((6,)),
                               L.Dense(8, activation="relu", name="d1"),
                               L.Dense(4, activation="softmax", name="d2")])
        _check(_save(km, tmp_path, "mlp.h5"), km, _normal(0, (3, 6)),
               sequential=True)

    def test_cnn(self, tmp_path, L):
        km = keras.Sequential([
            keras.Input((12, 12, 3)),
            L.Conv2D(4, (3, 3), padding="same", activation="relu",
                     name="c1"),
            L.MaxPooling2D((2, 2), name="p1"),
            L.Conv2D(6, (3, 3), padding="valid", name="c2"),
            L.Flatten(name="f"),
            L.Dense(5, activation="softmax", name="out")])
        _check(_save(km, tmp_path, "cnn.h5"), km, _normal(1, (2, 12, 12, 3)),
               sequential=True)

    def test_batchnorm_inference(self, tmp_path, L):
        km = keras.Sequential([keras.Input((10,)),
                               L.Dense(8, name="d"),
                               L.BatchNormalization(name="bn"),
                               L.Dense(3, activation="softmax", name="o")])
        km.compile("sgd", "categorical_crossentropy")
        rng = np.random.default_rng(2)
        km.fit(rng.normal(size=(64, 10)).astype(np.float32),
               np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)],
               epochs=1, verbose=0)
        _check(_save(km, tmp_path, "bn.h5"), km,
               rng.normal(size=(4, 10)).astype(np.float32), rtol=1e-3,
               atol=1e-4, sequential=True)

    def test_lstm(self, tmp_path, L):
        km = keras.Sequential([
            keras.Input((7, 5)),
            L.LSTM(6, return_sequences=True, name="l1",
                   recurrent_activation="sigmoid"),
            L.LSTM(4, name="l2", recurrent_activation="sigmoid"),
            L.Dense(2, activation="softmax", name="o")])
        _check(_save(km, tmp_path, "lstm.h5"), km, _normal(3, (3, 7, 5)),
               rtol=1e-3, atol=1e-4, sequential=True)

    def test_dropout_is_inert_at_inference(self, tmp_path, L):
        km = keras.Sequential([keras.Input((6,)),
                               L.Dense(8, activation="relu", name="d1"),
                               L.Dropout(0.5, name="dr"),
                               L.Dense(3, activation="softmax", name="d2")])
        _check(_save(km, tmp_path, "drop.h5"), km, _normal(4, (3, 6)),
               sequential=True)

    def test_imported_model_trains(self, tmp_path, L):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        km = keras.Sequential([keras.Input((6,)),
                               L.Dense(16, activation="relu", name="d1"),
                               L.Dense(2, activation="softmax", name="d2")])
        m = import_keras_sequential_model_and_weights(
            _save(km, tmp_path, "train.h5"), device="cpu")
        rng = np.random.default_rng(5)
        x = rng.normal(size=(128, 6)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
        before = m.score(DataSet(x, y))
        for _ in range(60):
            m.fit(DataSet(x, y))
        assert m.score(DataSet(x, y)) < before


class TestFunctional:
    def test_two_branch_add(self, tmp_path, L):
        inp = keras.Input((8, 8, 3), name="in")
        a = L.Conv2D(4, (3, 3), padding="same", activation="relu",
                     name="ca")(inp)
        b = L.Conv2D(4, (3, 3), padding="same", name="cb")(inp)
        z = L.GlobalAveragePooling2D(name="gap")(L.Add(name="add")([a, b]))
        km = keras.Model(inp, L.Dense(5, activation="softmax",
                                      name="out")(z))
        _check(_save(km, tmp_path, "fun.h5"), km, _normal(6, (2, 8, 8, 3)))

    def test_concat(self, tmp_path, L):
        inp = keras.Input((10,), name="in")
        a = L.Dense(4, activation="relu", name="da")(inp)
        b = L.Dense(6, activation="tanh", name="db")(inp)
        z = L.Concatenate(name="cat")([a, b])
        km = keras.Model(inp, L.Dense(3, activation="softmax",
                                      name="out")(z))
        _check(_save(km, tmp_path, "cat.h5"), km, _normal(7, (4, 10)))

    def test_sequential_falls_through(self, tmp_path, L):
        km = keras.Sequential([keras.Input((4,)),
                               L.Dense(2, activation="softmax", name="d")])
        m = _check(_save(km, tmp_path, "st.h5"), km, _normal(8, (3, 4)))
        assert type(m).__name__ == "MultiLayerNetwork"

    def test_archive_attrs_and_weights(self, tmp_path, L):
        km = keras.Sequential([keras.Input((4,)), L.Dense(2, name="d")])
        with Hdf5Archive(_save(km, tmp_path, "a.h5")) as a:
            assert a.model_config()["class_name"] == "Sequential"
            w = a.layer_weights("d")
            assert w["kernel"].shape == (4, 2) and w["bias"].shape == (2,)


class TestTransformer:
    def test_layer_norm(self, tmp_path, L):
        km = keras.Sequential([keras.Input((6,)), L.Dense(8, name="d"),
                               L.LayerNormalization(name="ln"),
                               L.Dense(3, activation="softmax", name="o")])
        _check(_save(km, tmp_path, "ln.h5"), km, _normal(4, (3, 6)),
               sequential=True)

    def test_multi_head_attention_block(self, tmp_path, L):
        inp = keras.Input((5, 8), name="in")
        att = L.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(
            inp, inp)
        km = keras.Model(inp, L.Dense(3, activation="softmax",
                                      name="out")(att))
        _check(_save(km, tmp_path, "mha.h5"), km, _normal(5, (2, 5, 8)),
               rtol=5e-4, atol=5e-5)

    def test_mini_bert_encoder(self, tmp_path, L):
        t, v, e = 6, 32, 16
        tok = keras.Input((t, v), name="tok")
        x = L.Dense(e, use_bias=False, name="embed")(tok)
        for i in range(2):
            att = L.MultiHeadAttention(num_heads=2, key_dim=e // 2,
                                       name=f"b{i}_mha")(x, x)
            x = L.LayerNormalization(name=f"b{i}_ln1")(
                L.Add(name=f"b{i}_res1")([x, att]))
            ff = L.Dense(e * 4, activation="gelu", name=f"b{i}_ff1")(x)
            ff = L.Dense(e, name=f"b{i}_ff2")(ff)
            x = L.LayerNormalization(name=f"b{i}_ln2")(
                L.Add(name=f"b{i}_res2")([x, ff]))
        km = keras.Model(tok, L.Dense(v, activation="softmax",
                                      name="mlm")(x))
        ids = np.random.default_rng(7).integers(0, v, (2, t))
        _check(_save(km, tmp_path, "minibert.h5"), km,
               np.eye(v, dtype=np.float32)[ids], rtol=1e-3, atol=1e-4)

    def test_bidirectional_lstm(self, tmp_path, L):
        km = keras.Sequential([
            keras.Input((7, 3)),
            L.Bidirectional(L.LSTM(5, return_sequences=True), name="bi"),
            L.Dense(2, activation="softmax", name="out")])
        _check(_save(km, tmp_path, "bi.h5"), km, _normal(8, (2, 7, 3)),
               rtol=1e-3, atol=1e-4, sequential=True)

    def test_cross_attention_rejected(self, tmp_path, L):
        a = keras.Input((4, 8), name="a")
        b = keras.Input((4, 8), name="b")
        att = L.MultiHeadAttention(num_heads=2, key_dim=4, name="xattn")(a, b)
        km = keras.Model([a, b], L.Dense(2, name="out")(att))
        with pytest.raises(ValueError, match="cross-attention"):
            import_keras_model_and_weights(_save(km, tmp_path, "x.h5"),
                                           device="cpu")

    def test_inception_v3_architecture(self, tmp_path):
        """keras.applications.InceptionV3 at 75×75 with 10 classes (SAME
        padding at stride 2, BN without gamma, concat merges)."""
        app = pytest.importorskip("keras.applications")
        km = app.InceptionV3(weights=None, input_shape=(75, 75, 3),
                             classes=10)
        _check(_save(km, tmp_path, "iv3.h5"), km, _normal(0, (2, 75, 75, 3)),
               rtol=1e-3, atol=1e-5)


class TestKerasV3Format:
    def test_sequential_mlp(self, tmp_path, L):
        km = keras.Sequential([keras.Input((6,)),
                               L.Dense(8, activation="relu", name="d1"),
                               L.Dense(4, activation="softmax", name="d2")])
        _check(_save(km, tmp_path, "mlp.keras"), km, _normal(0, (3, 6)),
               sequential=True)

    def test_cnn_bn(self, tmp_path, L):
        km = keras.Sequential([
            keras.Input((10, 10, 3)),
            L.Conv2D(4, 3, activation="relu", name="c"),
            L.BatchNormalization(name="bn"),
            L.SeparableConv2D(5, 3, name="sc"),
            L.Flatten(name="f"),
            L.Dense(3, activation="softmax", name="o")])
        _check(_save(km, tmp_path, "cnn.keras"), km,
               _normal(1, (2, 10, 10, 3)), rtol=1e-3, atol=1e-4,
               sequential=True)

    def test_lstm_bidirectional(self, tmp_path, L):
        km = keras.Sequential([
            keras.Input((7,)),
            L.Embedding(20, 5, name="e"),
            L.Bidirectional(L.LSTM(4, return_sequences=True), name="bi"),
            L.LSTM(3, name="l"),
            L.Dense(2, activation="softmax", name="o")])
        x = np.random.default_rng(2).integers(0, 20, (3, 7)).astype(
            np.float32)
        _check(_save(km, tmp_path, "rnn.keras"), km, x, rtol=1e-3,
               atol=1e-4, sequential=True)

    def test_functional_mha(self, tmp_path, L):
        inp = keras.Input((5, 8), name="in")
        att = L.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(
            inp, inp)
        x = L.LayerNormalization(name="ln")(L.Add(name="res")([inp, att]))
        km = keras.Model(inp, L.Dense(3, activation="softmax",
                                      name="out")(x))
        _check(_save(km, tmp_path, "mha.keras"), km, _normal(3, (2, 5, 8)),
               rtol=5e-4, atol=5e-5)


def test_custom_stateless_layer_keras3_import(tmp_path):
    """A user-registered parameter-free custom layer imports from the
    .keras format without tripping the weights-expected guard
    (reference: KerasLayer.registerCustomLayer)."""
    import dataclasses

    from keras import layers as KL

    from deeplearning4j_tpu_torch.modelimport.layers import (
        _CUSTOM, Converted, register_custom_layer)
    from deeplearning4j_tpu_torch.nn.layers.base import Layer

    @keras.saving.register_keras_serializable(package="torch_t")
    class Doubler(KL.Layer):
        def call(self, x):
            return x * 2.0

    @dataclasses.dataclass(frozen=True)
    class DoublerLayer(Layer):
        @property
        def has_params(self):
            return False

        def output_type(self, input_type):
            return input_type

        def apply(self, params, state, x, ctx):
            return x * 2.0, state

    keras.utils.set_random_seed(0)
    inp = keras.Input((4,))
    km = keras.Model(inp, KL.Dense(3)(Doubler()(inp)))
    p = _save(km, tmp_path, "m.keras")
    register_custom_layer("Doubler", lambda cfg, v: Converted(
        layer=DoublerLayer()))
    try:
        model = import_keras_model_and_weights(p, device="cpu")
        x = _normal(0, (3, 4))
        np.testing.assert_allclose(model.output(x).numpy(),
                                   np.asarray(km(x)), rtol=1e-5, atol=1e-6)
    finally:
        _CUSTOM.pop("Doubler", None)


def test_custom_layer_registry():
    from deeplearning4j_tpu_torch.modelimport.layers import (
        _CUSTOM, Converted, convert_layer, register_custom_layer)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        ActivationLayer
    from deeplearning4j_tpu_torch.ops.activations import Activation
    register_custom_layer("MyCustom", lambda cfg, v: Converted(
        layer=ActivationLayer(activation=Activation.RELU)))
    try:
        assert isinstance(convert_layer("MyCustom", {}, 2).layer,
                          ActivationLayer)
    finally:
        _CUSTOM.pop("MyCustom", None)


@pytest.mark.parametrize("name", ["bert_base", "inception_v3"])
def test_committed_configuration_is_what_keras_writes(name):
    """The committed full-width configuration equals the model_config
    Keras writes for the model now (what Hdf5Archive would read), and its
    manifest names every layer that has weights, with Keras's shapes."""
    import keras_card_resources as tool
    km = tool.keras_model(name)
    want = tool.legacy_model_config(km)
    with open(os.path.join(tool.OUT, name + ".json")) as f:
        meta = json.load(f)
    assert meta["model_config"] == want
    assert meta["keras_version"] == int(keras.__version__.split(".")[0])
    assert meta["training_config"] is None
    assert set(meta["manifest"]) == {l.name for l in km.layers if l.weights}
    for layer in km.layers:
        shapes = [list(w.shape) for w in layer.weights]
        assert [s for _, s in meta["manifest"].get(layer.name, [])] == shapes
        for (keys, _), w in zip(meta["manifest"].get(layer.name, []),
                                layer.weights):
            assert w.path in keys


def test_committed_small_bert_is_what_the_tool_writes():
    """bert_small (the on-card tests' imported BERT): configuration and
    seeded weights as the tool writes them, Keras's hidden states within
    1e-5 of their largest magnitude (Keras's CPU sums may order
    differently on another machine)."""
    import keras_card_resources as tool
    meta, weights, gold = tool.small_bert_resource()
    stem = os.path.join(tool.OUT, "bert_small")
    with open(stem + ".json") as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    with np.load(stem + ".npz") as z:
        assert sorted(z.files) == sorted(weights)
        for k in z.files:
            np.testing.assert_array_equal(z[k], weights[k])
    with np.load(stem + "_golden.npz") as z:
        np.testing.assert_array_equal(z["ids"], gold["ids"])
        assert np.abs(z["hidden"] - gold["hidden"]).max() <= \
            1e-5 * np.abs(gold["hidden"]).max()


@pytest.mark.slow
def test_full_width_resources_regenerate(tmp_path):
    """Every committed full-width resource (configuration, manifest and
    Keras's goldens on the seeded weights) regenerated and compared; the
    goldens within 1e-5 of their largest magnitude (Keras's CPU sums may
    order differently on another machine)."""
    import keras_card_resources as tool
    tool.OUT = str(tmp_path)
    tool.write_models()
    ref = os.path.join(ROOT, "deeplearning4j_tpu_torch", "modelimport",
                       "resources")
    for name in ("bert_base", "inception_v3"):
        with open(os.path.join(ref, name + ".json")) as a, \
                open(os.path.join(tool.OUT, name + ".json")) as b:
            assert json.load(a) == json.load(b)
        with np.load(os.path.join(ref, name + "_golden.npz")) as a, \
                np.load(os.path.join(tool.OUT, name + "_golden.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                if a[k].dtype.kind in "iu":
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert np.abs(a[k] - b[k]).max() <= \
                        1e-5 * np.abs(a[k]).max()
