"""The rest of the port's dataset fetchers against the JAX package's, on
the CPU: every new fetcher's seeded stand-in bitwise equal to JAX's, and
its local-file reads equal on files written by ``write_cifar_bin``,
``write_idx_gz`` and numpy; the Adler32 cache contract
(``verify_checksum``, ``fetch_with_mirror`` over local ``file://``
sources only). Nothing is downloaded.
"""

import os
import zlib

import numpy as np
import pytest

import deeplearning4j_tpu.datasets.fetchers as jf
import deeplearning4j_tpu_torch.datasets.fetchers as pf


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """An empty cache directory for both packages' fetchers."""
    monkeypatch.setattr(jf, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(pf, "DATA_DIR", str(tmp_path))
    return tmp_path


def _batches(it, n=3):
    out = []
    for i, b in enumerate(it):
        if i == n:
            break
        out.append((np.asarray(b.features), np.asarray(b.labels)))
    return out


def _same(a_it, b_it, n=3):
    a, b = _batches(a_it, n), _batches(b_it, n)
    assert len(a) == len(b) > 0
    for (fa, la), (fb, lb) in zip(a, b):
        assert fa.dtype == fb.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("make", [
    lambda m: m.TinyImageNetDataSetIterator(16, subset=64, seed=3),
    lambda m: m.TinyImageNetDataSetIterator(16, subset=64,
                                            num_classes=10),
    lambda m: m.EmnistDataSetIterator(32, "LETTERS", subset=256),
    lambda m: m.EmnistDataSetIterator(32, "digits", train=False,
                                      subset=128),
    lambda m: m.SvhnDataSetIterator(32, subset=128),
    lambda m: m.SvhnDataSetIterator(32, train=False, subset=96, seed=4),
    lambda m: m.CifarDataSetIterator(32, subset=128),
    lambda m: m.CifarDataSetIterator(32, train=False, subset=64, seed=2),
    lambda m: m.LFWDataSetIterator(16, num_examples=64,
                                   image_shape=(32, 32, 3), num_labels=8),
], ids=["tiny", "tiny10", "emnist-letters", "emnist-digits-test", "svhn",
        "svhn-test", "cifar", "cifar-test", "lfw"])
def test_stand_in_is_bitwise_jax(data_dir, make):
    _same(make(jf), make(pf))


def test_fetchers_fetch_the_same_arrays(data_dir):
    for cls in ("TinyImageNetFetcher", "SvhnDataFetcher"):
        a = getattr(jf, cls)(subset=40).fetch()
        b = getattr(pf, cls)(subset=40).fetch()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_emnist_refuses_unknown_split(data_dir):
    with pytest.raises(ValueError, match="unknown EMNIST split"):
        pf.EmnistDataSetIterator(8, "NOPE")


def test_cifar_reads_write_cifar_bin_files(data_dir):
    rng = np.random.default_rng(0)
    d = os.path.join(data_dir, "cifar-10-batches-bin")
    for i in range(1, 6):
        pf.write_cifar_bin(rng.integers(0, 256, (20, 32, 32, 3)),
                           rng.integers(0, 10, 20),
                           os.path.join(d, f"data_batch_{i}.bin"))
    jf.write_cifar_bin(rng.integers(0, 256, (10, 32, 32, 3)),
                       rng.integers(0, 10, 10),
                       os.path.join(d, "test_batch.bin"))
    _same(jf.CifarDataSetIterator(10, subset=100),
          pf.CifarDataSetIterator(10, subset=100), n=10)
    _same(jf.CifarDataSetIterator(5, train=False),
          pf.CifarDataSetIterator(5, train=False))
    imgs, labels = pf.CifarDataSetIterator._read_bin(
        [os.path.join(d, "test_batch.bin")])
    assert imgs.shape == (10, 32, 32, 3) and labels.shape == (10,)


def test_emnist_reads_write_idx_gz_files(data_dir):
    rng = np.random.default_rng(1)
    d = os.path.join(data_dir, "emnist")
    pf.write_idx_gz(rng.integers(0, 256, (64, 28, 28)),
                    rng.integers(1, 27, 64), d, "emnist-letters-train")
    _same(jf.EmnistDataSetIterator(16, "LETTERS"),
          pf.EmnistDataSetIterator(16, "LETTERS"))
    it = pf.EmnistDataSetIterator(16, "LETTERS", subset=32)
    assert it.num_classes == 26


def test_svhn_lfw_tiny_read_local_npz(data_dir):
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(data_dir, "svhn"))
    np.savez(os.path.join(data_dir, "svhn", "train_32x32.npz"),
             X=rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8),
             y=rng.integers(0, 11, 40))
    _same(jf.SvhnDataSetIterator(8), pf.SvhnDataSetIterator(8))
    os.makedirs(os.path.join(data_dir, "lfw"))
    np.savez(os.path.join(data_dir, "lfw", "lfw.npz"),
             X=rng.normal(size=(30, 16, 16, 3)).astype(np.float32),
             y=rng.integers(0, 100, 30))
    _same(jf.LFWDataSetIterator(6, num_labels=5),
          pf.LFWDataSetIterator(6, num_labels=5))
    os.makedirs(os.path.join(data_dir, "tinyimagenet"))
    np.savez(os.path.join(data_dir, "tinyimagenet", "train.npz"),
             images=rng.normal(size=(24, 64, 64, 3)).astype(np.float32),
             labels=rng.integers(0, 200, 24))
    _same(jf.TinyImageNetDataSetIterator(8, subset=16),
          pf.TinyImageNetDataSetIterator(8, subset=16))


def _adler(path):
    with open(path, "rb") as f:
        return zlib.adler32(f.read())


def test_verify_checksum_and_sidecar(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"deeplearning4j" * 100)
    good = _adler(p)
    pf.verify_checksum(str(p), good)
    assert (tmp_path / "blob.bin.adler32.ok").exists()
    pf.verify_checksum(str(p), good)             # the stamp skips re-hashing
    with pytest.raises(IOError, match="failed checksum"):
        pf.verify_checksum(str(p), good + 1)
    (tmp_path / "blob.bin.adler32").write_text(str(good + 1))
    with pytest.raises(IOError):
        pf._maybe_verify(str(p))
    pf._maybe_verify(str(p), good)               # an explicit value wins
    q = tmp_path / "plain.bin"
    q.write_bytes(b"x")
    pf._maybe_verify(str(q))                      # no sidecar: nothing


def test_fetch_with_mirror_local_file(tmp_path):
    src = tmp_path / "mirror" / "data.bin"
    src.parent.mkdir()
    src.write_bytes(os.urandom(4096))
    dest = tmp_path / "cache" / "data.bin"
    out = pf.fetch_with_mirror(src.as_uri(), str(dest), _adler(src))
    assert out == str(dest) and dest.read_bytes() == src.read_bytes()
    dest2 = tmp_path / "cache" / "bad.bin"
    with pytest.raises(IOError):
        pf.fetch_with_mirror(src.as_uri(), str(dest2), _adler(src) + 1)
    assert not dest2.exists()                     # a failed file is purged
