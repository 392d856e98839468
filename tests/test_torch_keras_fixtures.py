"""The port's Keras importer (``deeplearning4j_tpu_torch.modelimport``) on
the committed fixture corpus, on the CPU, against the fixtures' own
goldens and against the JAX package's import of the same files.

The cases of tests/test_keras_fixtures.py, mirrored: all 14 fixtures
(``k1_*``/``k2_*`` .h5, ``k3_*`` .keras) within rtol 1e-4, atol 1e-5 of
their ``_io.npz`` (that file's bound) and within 1e-5 of the JAX import's
output relative to its largest magnitude (the same f32 arithmetic in
other orders); the registry's coverage and the manifest's table equal to
the JAX package's; the converters' refusals; the Keras-1 dialect. Then
what the card relies on: the package imports with h5py and keras absent,
the committed resources under ``modelimport/resources`` are what
``tools/keras_card_resources.py`` writes from the fixtures now, and
chip_smoke.py's ``KerasResourceArchive`` gives the same model as
``Hdf5Archive`` for every fixture.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.modelimport import keras as pk
from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.layers import convert_layer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "tests", "resources", "keras")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import keras_card_resources as tool  # noqa: E402

FIXTURES = list(chip_smoke.KERAS_FIXTURES)
SEQUENTIAL = ["k1_mlp", "k1_cnn_atrous", "k1_lstm", "k2_googlenet_bits",
              "k2_yolo_bits", "k2_temporal", "k2_reshape_permute",
              "k2_selu_alpha_dropout"]
JAX_REL = 1e-5


def _path(name):
    return tool.fixture_path(name)


def _out(model, x):
    return np.asarray(model.output(x).detach().cpu().numpy())


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_golden_and_jax(name):
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_model_and_weights as jax_import
    model = pk.import_keras_model_and_weights(_path(name), device="cpu")
    io = np.load(os.path.join(HERE, f"{name}_io.npz"))
    out = _out(model, io["x"])
    np.testing.assert_allclose(out, io["y"], rtol=1e-4, atol=1e-5)
    ref = np.asarray(jax_import(_path(name)).output(io["x"]))
    assert out.shape == ref.shape
    assert _rel(out, ref) <= JAX_REL


@pytest.mark.parametrize("name", SEQUENTIAL)
def test_sequential_entry_point(name):
    model = pk.import_keras_sequential_model_and_weights(_path(name),
                                                         device="cpu")
    io = np.load(os.path.join(HERE, f"{name}_io.npz"))
    np.testing.assert_allclose(_out(model, io["x"]), io["y"], rtol=1e-4,
                               atol=1e-5)


def test_sequential_entry_refuses_functional():
    with pytest.raises(ValueError, match="not a Sequential model"):
        pk.import_keras_sequential_model_and_weights(_path("k3_conv"),
                                                     device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pk.import_keras_model_and_weights(_path("k1_mlp"))


def test_registry_fully_covered_like_jax():
    from deeplearning4j_tpu.modelimport import manifest as jm
    from deeplearning4j_tpu_torch.modelimport import manifest as pm
    assert pm.uncovered(HERE) == []
    cov = pm.coverage(HERE)
    assert set(cov) == set(pm.supported_layers()) == set(
        jm.supported_layers())
    assert cov == jm.coverage(HERE)
    assert "k3_conv" in cov["Conv2DTranspose"]
    assert "k1_merge" in cov["Merge"]
    assert cov["add"] == cov["Add"] != []


def test_manifest_renders_the_jax_table():
    from deeplearning4j_tpu.modelimport.manifest import render_markdown as jr
    from deeplearning4j_tpu_torch.modelimport.manifest import render_markdown
    md = render_markdown(HERE)
    assert md == jr(HERE)
    assert "| Conv2D" in md and "alias of Conv2D" in md
    doc = open(os.path.join(ROOT, "SUPPORTED_KERAS_LAYERS.md")).read()
    assert md in doc


def test_fused_leaky_relu_string_rejected():
    with pytest.raises(ValueError, match="standalone"):
        convert_layer("Dense", {"units": 4, "activation": "leaky_relu"}, 3)


def test_reshape_permute_reject_bad_configs():
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    with pytest.raises(ValueError, match="target_shape"):
        convert_layer("Reshape", {"name": "r"}, 2)
    with pytest.raises(ValueError, match="dims"):
        convert_layer("Permute", {"name": "p"}, 2)
    conv = convert_layer("Reshape", {"target_shape": [5, 7]}, 2)
    with pytest.raises(ValueError, match="incompatible"):
        conv.layer.output_type(InputType.feed_forward(36))
    conv = convert_layer("Permute", {"dims": [3, 1]}, 2)
    with pytest.raises(ValueError, match="permutation"):
        conv.layer.output_type(InputType.recurrent(4, 6))


@pytest.mark.parametrize("cfg,match", [
    ({"num_heads": 2, "key_dim": 4, "value_dim": 8}, "value_dim"),
    ({"num_heads": 2, "key_dim": 4, "output_shape": [6]}, "output_shape"),
    ({"num_heads": 2, "key_dim": 4, "attention_axes": [2]},
     "attention_axes"),
    ({"units": 3, "activation": "no_such"}, "unsupported Keras activation"),
])
def test_converter_refusals(cfg, match):
    cls = "Dense" if "units" in cfg else "MultiHeadAttention"
    with pytest.raises(ValueError, match=match):
        convert_layer(cls, cfg, 3)
    with pytest.raises(ValueError, match="unsupported Keras layer"):
        convert_layer("NoSuchLayer", {}, 2)


def test_mha_packing_is_head_major():
    """Keras (F, H, dh) query/key/value kernels pack into the (head,
    which, dh) columns the port's SelfAttentionLayer reads as strided
    views; biases alike."""
    f, h, d = 6, 2, 3
    rng = np.random.default_rng(0)
    w = {f"{n}/kernel": rng.normal(size=(f, h, d)).astype(np.float32)
         for n in ("query", "key", "value")}
    w.update({f"{n}/bias": rng.normal(size=(h, d)).astype(np.float32)
              for n in ("query", "key", "value")})
    w["attention_output/kernel"] = rng.normal(size=(h, d, f))
    w["attention_output/bias"] = rng.normal(size=(f,))
    conv = convert_layer("MultiHeadAttention", {"num_heads": h,
                                                "key_dim": d}, 3)
    params, _ = conv.weights(w)
    packed = params["Wqkv"].reshape(f, h, 3, d)
    for i, n in enumerate(("query", "key", "value")):
        np.testing.assert_array_equal(packed[:, :, i], w[f"{n}/kernel"])
        np.testing.assert_array_equal(
            params["bqkv"].reshape(h, 3, d)[:, i], w[f"{n}/bias"])
    assert params["Wo"].shape == (h * d, f)


def test_lstm_gate_permutation():
    """Keras i,f,c,o → the port's i,f,o,g; Keras-1 per-gate matrices."""
    from deeplearning4j_tpu_torch.modelimport.layers import _lstm_weights
    k = np.arange(8, dtype=np.float32)[None].repeat(3, 0)
    p, _ = _lstm_weights({"kernel": k, "recurrent_kernel": k[:2],
                          "bias": k[0]})
    np.testing.assert_array_equal(p["b"], [0, 1, 2, 3, 6, 7, 4, 5])
    gates = {f"{m}_{g}": np.full((2, 1), i, np.float32)
             for i, g in enumerate("ifco") for m in ("W", "U")}
    p, _ = _lstm_weights(gates)
    np.testing.assert_array_equal(p["Wx"][0], [0, 1, 3, 2])


def test_keras1_dialect_detected():
    with Hdf5Archive(_path("k1_mlp")) as a:
        assert a.keras_version() == 1
        assert isinstance(a.model_config()["config"], list)
    with Hdf5Archive(_path("k2_yolo_bits")) as a:
        assert a.keras_version() == 2
    with Hdf5Archive(_path("k3_conv")) as a:
        assert a.keras_version() == 3


def test_archive_reads_like_jax():
    from deeplearning4j_tpu.modelimport.hdf5 import Hdf5Archive as JA
    for name in FIXTURES:
        with Hdf5Archive(_path(name)) as a, JA(_path(name)) as b:
            assert a.model_config() == b.model_config()
            assert a.keras_version() == b.keras_version()
            for layer in tool._layer_names(a.model_config()):
                wa, wb = a.layer_weights(layer), b.layer_weights(layer)
                assert wa.keys() == wb.keys()
                for k in wa:
                    np.testing.assert_array_equal(wa[k], wb[k])


def test_gaussian_noise_maps_to_additive_noise():
    from deeplearning4j_tpu_torch.nn.dropout import (GaussianDropout,
                                                     GaussianNoise)
    conv = convert_layer("GaussianNoise", {"stddev": 0.25}, 2)
    assert isinstance(conv.layer.dropout, GaussianNoise)
    assert conv.layer.dropout.stddev == 0.25
    conv = convert_layer("GaussianDropout", {"rate": 0.3}, 2)
    assert isinstance(conv.layer.dropout, GaussianDropout)


def test_imported_weights_are_copies_on_the_model_device():
    model = pk.import_keras_model_and_weights(_path("k1_mlp"),
                                              device="cpu")
    with Hdf5Archive(_path("k1_mlp")) as a:
        w = a.layer_weights("dense_1")
    got = model.params["dense_1"]["W"]
    np.testing.assert_array_equal(got.numpy(), w["W"])
    assert got.dtype == torch.float32
    got.add_(1.0)                       # writing the model's tensor ...
    with Hdf5Archive(_path("k1_mlp")) as a:
        np.testing.assert_array_equal(a.layer_weights("dense_1")["W"],
                                      w["W"])   # ... leaves the file's


def test_shape_mismatch_raises():
    class Archive:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, k):
            return getattr(self.inner, k)

        def layer_weights(self, name):
            w = self.inner.layer_weights(name)
            return {k: np.zeros((3, 3), np.float32) for k in w}
    with Hdf5Archive(_path("k1_mlp")) as a:
        with pytest.raises(ValueError, match="model expects"):
            pk._import_archive(Archive(a), "cpu")


def test_fixtures_trainable_after_import():
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    model = pk.import_keras_sequential_model_and_weights(_path("k1_mlp"),
                                                         device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    before = model.iteration
    model.fit(DataSet(x, y))
    assert model.iteration == before + 1
    assert np.isfinite(model.score())


def test_imports_without_h5py_and_keras():
    """The package imports where h5py and keras are missing (the card's
    machine); opening a file then raises RuntimeError, and nothing of JAX
    is imported."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['keras'] = None\n"
        "import deeplearning4j_tpu_torch.modelimport as m\n"
        "from deeplearning4j_tpu_torch.modelimport import bert, manifest\n"
        "try:\n"
        f"    m.Hdf5Archive({_path('k1_mlp')!r})\n"
        "except RuntimeError as e:\n"
        "    assert 'h5py' in str(e)\n"
        "else:\n"
        "    raise SystemExit('no RuntimeError')\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(k.startswith('deeplearning4j_tpu.') or "
        "k == 'deeplearning4j_tpu' for k in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_resource_is_what_the_tool_writes(name):
    meta, weights = tool.fixture_resource(name)
    stem = os.path.join(tool.OUT, name)
    with open(stem + ".json") as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    with np.load(stem + ".npz") as z:
        assert sorted(z.files) == sorted(weights)
        for k in z.files:
            assert z[k].dtype == weights[k].dtype
            np.testing.assert_array_equal(z[k], weights[k])


@pytest.mark.parametrize("name", FIXTURES)
def test_card_reader_gives_the_hdf5_model(name):
    """chip_smoke.py's reader of the committed resource and Hdf5Archive
    of the fixture file give the same model: the same configuration,
    bitwise the same parameters and state, and the same output."""
    res = chip_smoke.KerasResourceArchive(os.path.join(tool.OUT, name))
    with Hdf5Archive(_path(name)) as a:
        ref = pk._import_archive(a, "cpu")
        assert res.model_config() == a.model_config()
        assert res.keras_version() == a.keras_version()
    got = pk._import_archive(res, "cpu")
    assert got.conf.to_json() == ref.conf.to_json()
    for tree in ("params", "model_state"):
        ga, gb = getattr(got, tree), getattr(ref, tree)
        from deeplearning4j_tpu_torch.models.serialization import \
            flatten_paths
        fa, fb = flatten_paths(ga), flatten_paths(gb)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
    io = np.load(os.path.join(HERE, f"{name}_io.npz"))
    np.testing.assert_array_equal(_out(got, io["x"]), _out(ref, io["x"]))


def test_seeded_rule_is_per_layer_and_keras_glorot():
    """The full-width models' weight rule: each layer's draws depend on
    its name only; kernels within Keras's glorot-uniform limit, gamma and
    the variance in their ranges."""
    g = [(["d/kernel"], (30, 20)), (["d/bias"], (20,))]
    a = chip_smoke.seeded_keras_arrays("d", g)
    b = chip_smoke.seeded_keras_arrays("d", g)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = chip_smoke.seeded_keras_arrays("e", g)
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.float32
    assert np.abs(a[0]).max() <= np.sqrt(6 / 50)
    assert np.abs(a[0]).max() > 0.9 * np.sqrt(6 / 50)
    assert np.abs(a[1]).max() <= 0.05
    bn = [(["bn/gamma"], (500,)), (["bn/moving_variance"], (500,))]
    gamma, var = chip_smoke.seeded_keras_arrays("bn", bn)
    assert 0.8 <= gamma.min() and gamma.max() <= 1.2
    assert 0.5 <= var.min() and var.max() <= 1.5
    with pytest.raises(ValueError, match="no seeded rule"):
        chip_smoke.seeded_keras_arrays("x", [(["x/odd"], (2,))])
