"""The digits data and the committed digit models in the port, against the
JAX package on the CPU.

- ``datasets/resources/digits.npz`` holds scikit-learn's bundled UCI
  digits bit for bit (skipped where scikit-learn is missing);
- the port's ``DigitsDataSetIterator`` yields the JAX package's batches,
  shuffle and every-5th test split included, and the copied MNIST and
  Iris iterators yield the JAX package's arrays;
- the committed ``lenet_digits.zip`` and ``simplecnn_digits.zip`` give the
  JAX package's probabilities within 1e-5 of each row's largest (f32
  convolutions summed in other orders), with held-out accuracies of at
  least 0.98 and 0.95 (the JAX package's own gates,
  tests/test_pretrained_artifacts.py);
- ``mlp_v1.zip`` and ``cnn_v1.zip`` give ``expected_outputs.json``'s
  outputs within rtol 1e-5, atol 1e-6 (tests/test_regression_fixtures.py's
  bound).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.datasets.dataset import (ArrayDataSetIterator as
                                                 JArrayIt)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.models.serialization import restore_model
from deeplearning4j_tpu_torch.zoo.models import LeNet, SimpleCNN

REPO = Path(__file__).resolve().parents[1]
ACC = {"LeNet": 0.98, "SimpleCNN": 0.95}


def test_digits_npz_equals_load_digits():
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    images, labels = tfetch.DigitsDataSetIterator.load()
    assert images.dtype == np.uint8 and labels.dtype == np.int64
    assert images.shape == (1797, 8, 8)
    np.testing.assert_array_equal(images.astype(np.float64), d.images)
    np.testing.assert_array_equal(labels, d.target)


@pytest.mark.parametrize("train", [True, False])
def test_digits_fetch_matches_jax(train):
    x, y = tfetch.DigitsDataSetIterator.fetch(train)
    jx, jy = jfetch.DigitsDataSetIterator.fetch(train)
    assert x.dtype == jx.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape == ((1437 if train else 360), 784)


@pytest.mark.parametrize("train,shuffle", [(True, True), (False, False),
                                           (False, True)])
def test_digits_iterator_yields_the_jax_batches(train, shuffle):
    """Two passes (the shuffle seed advances by epoch), drop_last=True:
    the test split gives 5 batches of 64 out of 360."""
    it = tfetch.DigitsDataSetIterator(64, train=train, shuffle=shuffle)
    jit = jfetch.DigitsDataSetIterator(64, train=train, shuffle=shuffle)
    for _ in range(2):
        got, want = list(it), list(jit)
        assert len(got) == len(want) == (22 if train else 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.features, w.features)
            np.testing.assert_array_equal(g.labels, w.labels)
        it.reset()
        jit.reset()


def test_mnist_and_iris_iterators_match_jax(tmp_path, monkeypatch):
    """The seeded synthetic MNIST stand-in, the IDX files written by
    write_idx_gz and read back, and the Iris set: the JAX package's
    arrays."""
    for mod in (tfetch, jfetch):
        monkeypatch.setattr(mod, "DATA_DIR", str(tmp_path / "none"))
    pairs = [(tfetch.MnistDataSetIterator(64, subset=200),
              jfetch.MnistDataSetIterator(64, subset=200)),
             (tfetch.IrisDataSetIterator(50), jfetch.IrisDataSetIterator(50))]
    x, y = tfetch.DigitsDataSetIterator.fetch(train=False)
    scans = (x.reshape(-1, 28, 28) * 255).astype(np.uint8)
    tfetch.write_idx_gz(scans, y, str(tmp_path / "mnist"), "t10k")
    for mod in (tfetch, jfetch):
        monkeypatch.setattr(mod, "DATA_DIR", str(tmp_path))
    pairs.append((tfetch.MnistDataSetIterator(32, train=False,
                                              shuffle=False),
                  jfetch.MnistDataSetIterator(32, train=False,
                                              shuffle=False)))
    for t_it, j_it in pairs:
        got, want = list(t_it), list(j_it)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.features, w.features)
            np.testing.assert_array_equal(g.labels, w.labels)
    got = np.concatenate([b.features for b in pairs[-1][0]])
    np.testing.assert_array_equal(
        got, scans[:got.shape[0]].reshape(-1, 784) / np.float32(255.0))


def _digits_test_set(name):
    x, y = tfetch.DigitsDataSetIterator.fetch(train=False)
    if name == "SimpleCNN":
        x = x.reshape(-1, 28, 28, 1)
    return x, np.eye(10, dtype=np.float32)[y]


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN"])
def test_pretrained_digit_models_match_jax(name):
    from deeplearning4j_tpu.zoo import models as jzoo
    from deeplearning4j_tpu_torch.zoo import models as tzoo
    model = getattr(tzoo, name)().init_pretrained(flavor="digits",
                                                  device="cpu")
    jmodel = getattr(jzoo, name)().init_pretrained(flavor="digits")
    assert model.num_params() == jmodel.num_params()
    x, y = _digits_test_set(name)
    p = model.output(x).numpy()
    q = np.asarray(jmodel.output(x))
    assert (np.abs(p - q).max(1) / q.max(1)).max() <= 1e-5
    assert (p.argmax(1) == q.argmax(1)).all()
    if name == "LeNet":
        ev = model.evaluate(tfetch.DigitsDataSetIterator(64, train=False,
                                                         shuffle=False))
        jev = jmodel.evaluate(jfetch.DigitsDataSetIterator(
            64, train=False, shuffle=False))
    else:
        ev = model.evaluate(ArrayDataSetIterator(DataSet(x, y), 64))
        jev = jmodel.evaluate(JArrayIt(JDataSet(x, y), 64))
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())
    assert ev.accuracy() >= ACC[name], ev.accuracy()


def test_pretrained_checksum_enforced(monkeypatch):
    bad = {"digits": dict(LeNet.PRETRAINED["digits"], checksum=1234)}
    monkeypatch.setattr(LeNet, "PRETRAINED", bad)
    with pytest.raises(IOError, match="Adler32"):
        LeNet().init_pretrained(flavor="digits", device="cpu")
    with pytest.raises(FileNotFoundError, match="flavor"):
        SimpleCNN().init_pretrained(flavor="imagenet", device="cpu")


@pytest.mark.parametrize("name", ["mlp_v1", "cnn_v1"])
def test_regression_fixtures_match_expected_outputs(name):
    res = REPO / "tests" / "resources" / "regression"
    exp = json.loads((res / "expected_outputs.json").read_text())[name]
    model = restore_model(str(res / f"{name}.zip"), device="cpu",
                          load_updater=True)
    out = model.output(np.asarray(exp["input"], np.float32)).numpy()
    np.testing.assert_allclose(out, np.asarray(exp["output"]), rtol=1e-5,
                               atol=1e-6)


def test_zoo_configurations_match_jax():
    """LeNet and SimpleCNN build the JAX package's configuration.json and
    parameter count (431,080 for LeNet at 28×28×1)."""
    from deeplearning4j_tpu.zoo import models as jzoo
    for t, j in ((LeNet(), jzoo.LeNet()),
                 (SimpleCNN(height=28, width=28, channels=1),
                  jzoo.SimpleCNN(height=28, width=28, channels=1))):
        assert json.loads(t.conf().to_json()) == json.loads(
            j.conf().to_json())
    assert LeNet().init(device="cpu").num_params() == 431080
    jax.clear_caches()
