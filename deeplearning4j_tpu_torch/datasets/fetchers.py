"""Dataset fetchers and canonical iterators.

The parts of the JAX package's ``datasets/fetchers.py`` (numpy only)
that the LeNet/``MultiLayerNetwork`` flow needs, copied: ``MnistDataFetcher``
and ``MnistDataSetIterator`` (the canonical IDX files when cached under
``DL4J_TPU_DATA_DIR``, else the same seeded synthetic stand-in),
``write_idx_gz``, ``IrisDataSetIterator`` and ``UciSequenceDataSetIterator``
(the UCI synthetic-control series when cached, else its six regimes
generated from the seed); and ``DigitsDataSetIterator``, the real-data
iterator.

``DigitsDataSetIterator`` reads ``resources/digits.npz`` beside this
module: scikit-learn's bundled copy of the UCI "Optical Recognition of
Handwritten Digits" test set (``sklearn.datasets.load_digits()``: 1797
8×8 scans, values 0-16 stored as uint8, and their int64 labels), written
once with ``np.savez_compressed``. The port never imports scikit-learn;
the images, the upscale and the split are the JAX package's, so both
packages train and evaluate on the same arrays.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (
    ArrayDataSetIterator,
    DataSet,
    DataSetIterator,
)

DATA_DIR = os.environ.get("DL4J_TPU_DATA_DIR",
                          os.path.expanduser("~/.deeplearning4j_tpu/data"))
DIGITS_NPZ = Path(__file__).resolve().parent / "resources" / "digits.npz"


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((idx.shape[0], n), np.float32)
    out[np.arange(idx.shape[0]), idx] = 1.0
    return out


def _synthetic_image_classes(num: int, h: int, w: int, c: int, classes: int,
                             seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured images: each class is a distinct
    frequency/orientation pattern + noise, so models actually learn."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=num)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.empty((num, h, w, c), np.float32)
    for k in range(classes):
        mask = labels == k
        n_k = int(mask.sum())
        if n_k == 0:
            continue
        fx = 1.0 + (k % 5)
        fy = 1.0 + (k // 5) % 5
        base = np.sin(2 * np.pi * fx * xx / w + k) * \
            np.cos(2 * np.pi * fy * yy / h)
        pattern = np.repeat(base[:, :, None], c, axis=2)
        noise = rng.normal(0, 0.3, size=(n_k, h, w, c)).astype(np.float32)
        images[mask] = pattern[None] + noise
    images = (images - images.min()) / (images.max() - images.min() + 1e-8)
    return images.astype(np.float32), labels


class _ArrayBackedIterator(DataSetIterator):
    """Shared delegation for fetcher-backed iterators: subclasses build a
    DataSet and call ``_wrap``; iteration/reset delegate to one
    ArrayDataSetIterator."""

    def _wrap(self, ds: DataSet, batch_size: int, seed: int,
              shuffle: bool = True):
        self._it = ArrayDataSetIterator(ds, batch_size, shuffle=shuffle,
                                        seed=seed, drop_last=True)

    def __iter__(self):
        return iter(self._it)

    def reset(self):
        self._it.reset()

    @property
    def batch_size(self):
        return self._it.batch_size


class MnistDataFetcher:
    """Reads the canonical IDX-format files if cached locally, else builds
    a synthetic 10-class 28x28 set (reference: MnistDataFetcher)."""

    NUM_TRAIN = 60000
    NUM_TEST = 10000

    def __init__(self, train: bool = True, subset: Optional[int] = None,
                 seed: int = 123):
        self.train = train
        self.subset = subset
        self.seed = seed

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        base = os.path.join(DATA_DIR, "mnist")
        prefix = "train" if self.train else "t10k"
        img_path = os.path.join(base, f"{prefix}-images-idx3-ubyte.gz")
        lbl_path = os.path.join(base, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            images = self._read_idx_images(img_path)
            labels = self._read_idx_labels(lbl_path)
        else:
            n = self.NUM_TRAIN if self.train else self.NUM_TEST
            n = min(n, self.subset or n)
            images4d, labels = _synthetic_image_classes(
                n, 28, 28, 1, 10, self.seed + (0 if self.train else 1))
            images = images4d.reshape(n, 784)
        if self.subset:
            images = images[:self.subset]
            labels = labels[:self.subset]
        return images.astype(np.float32), labels

    @staticmethod
    def _read_idx_images(path: str) -> np.ndarray:
        with gzip.open(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), np.uint8)
        return data.reshape(n, rows * cols).astype(np.float32) / 255.0

    @staticmethod
    def _read_idx_labels(path: str) -> np.ndarray:
        with gzip.open(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype(np.int64)


def write_idx_gz(images: np.ndarray, labels: np.ndarray, directory: str,
                 prefix: str) -> None:
    """Write (N, H, W) uint8 images + (N,) labels as canonical gzipped
    IDX files (``{prefix}-images-idx3-ubyte.gz`` etc.) — the exact byte
    format of the MNIST distribution. Lets a user (or test) populate the
    ``DL4J_TPU_DATA_DIR`` cache so fetchers take the real-file path; the
    reference's MnistFetcher downloads these same files
    (deeplearning4j-data/.../MnistDataFetcher.java:1)."""
    images = np.asarray(images, np.uint8)
    labels = np.asarray(labels, np.uint8)
    n, rows, cols = images.shape
    os.makedirs(directory, exist_ok=True)
    with gzip.open(os.path.join(
            directory, f"{prefix}-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">IIII", 0x803, n, rows, cols))
        f.write(images.tobytes())
    with gzip.open(os.path.join(
            directory, f"{prefix}-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">II", 0x801, n))
        f.write(labels.tobytes())


class DigitsDataSetIterator(_ArrayBackedIterator):
    """REAL handwritten digits (the UCI optical-recognition test corpus:
    1797 genuine 8x8 grayscale scans, from ``resources/digits.npz``),
    upscaled to 28x28 (3x nearest + 2px border) so LeNet-class models run
    unchanged, with the deterministic every-5th-is-test split and
    ``drop_last=True`` batching of the JAX package's iterator."""

    IMG = 28

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 shuffle: bool = True):
        images, labels = self.fetch(train)
        ds = DataSet(images, _one_hot(labels, 10))
        self._wrap(ds, batch_size, seed, shuffle=shuffle)

    @staticmethod
    def load() -> Tuple[np.ndarray, np.ndarray]:
        """(images (1797, 8, 8) uint8 in 0-16, labels (1797,) int64)."""
        with np.load(DIGITS_NPZ) as z:
            return z["images"], z["labels"]

    @classmethod
    def fetch(cls, train: bool) -> Tuple[np.ndarray, np.ndarray]:
        raw, labels = cls.load()
        images = raw.astype(np.float32) / 16.0             # (1797, 8, 8)
        # 8x8 -> 24x24 nearest-neighbour, then 2px zero border -> 28x28
        up = np.repeat(np.repeat(images, 3, axis=1), 3, axis=2)
        up = np.pad(up, ((0, 0), (2, 2), (2, 2)))
        # deterministic interleaved split: every 5th example is test
        test = np.arange(up.shape[0]) % 5 == 0
        sel = ~test if train else test
        return up[sel].reshape(-1, cls.IMG * cls.IMG), labels[sel]


class MnistDataSetIterator(_ArrayBackedIterator):
    """(reference: MnistDataSetIterator) — yields flattened 784-float
    features + one-hot 10 labels."""

    def __init__(self, batch_size: int, train: bool = True,
                 subset: Optional[int] = None, seed: int = 123,
                 shuffle: bool = True):
        images, labels = MnistDataFetcher(train, subset, seed).fetch()
        ds = DataSet(images, _one_hot(labels, 10))
        self._it = ArrayDataSetIterator(ds, batch_size, shuffle=shuffle,
                                        seed=seed, drop_last=True)



class IrisDataSetIterator(_ArrayBackedIterator):
    """(reference: IrisDataSetIterator) — the classic 150x4 set, generated
    deterministically from the published means/stds when no cache exists."""

    def __init__(self, batch_size: int = 150, seed: int = 6):
        rng = np.random.default_rng(seed)
        means = np.array([[5.0, 3.4, 1.5, 0.2],
                          [5.9, 2.8, 4.3, 1.3],
                          [6.6, 3.0, 5.6, 2.0]], np.float32)
        stds = np.array([[0.35, 0.38, 0.17, 0.10],
                         [0.52, 0.31, 0.47, 0.20],
                         [0.64, 0.32, 0.55, 0.27]], np.float32)
        feats, labels = [], []
        for k in range(3):
            feats.append(rng.normal(means[k], stds[k], size=(50, 4)))
            labels.append(np.full(50, k))
        x = np.concatenate(feats).astype(np.float32)
        y = np.concatenate(labels)
        perm = rng.permutation(150)
        ds = DataSet(x[perm], _one_hot(y[perm], 3))
        self._it = ArrayDataSetIterator(ds, batch_size)


class UciSequenceDataSetIterator(_ArrayBackedIterator):
    """UCI synthetic-control time series: 600 univariate length-60 series,
    6 classes (reference: UciSequenceDataFetcher/-Iterator). Reads cached
    ``uci/synthetic_control.data`` (600x60 whitespace floats, class = row
    block of 100), else generates the same six regimes procedurally.
    Features (N, 60, 1), normalized per series; labels one-hot at every
    step (N, 60, 6), the RnnOutputLayer format."""

    CLASSES = 6
    LENGTH = 60

    def __init__(self, batch_size: int, train: bool = True, seed: int = 23):
        path = os.path.join(DATA_DIR, "uci", "synthetic_control.data")
        if os.path.exists(path):
            series = np.loadtxt(path).astype(np.float32)
            labels = np.repeat(np.arange(6), 100)
        else:
            series, labels = self._synthesize(seed)
        # the reference's split: 450 train / 150 test after a shuffle
        rng = np.random.default_rng(seed)
        order = rng.permutation(series.shape[0])
        cut = int(0.75 * len(order))
        keep = order[:cut] if train else order[cut:]
        series, labels = series[keep], labels[keep]
        mu = series.mean(axis=1, keepdims=True)
        sd = series.std(axis=1, keepdims=True) + 1e-6
        feats = ((series - mu) / sd)[:, :, None].astype(np.float32)
        lab = np.repeat(_one_hot(labels, self.CLASSES)[:, None, :],
                        self.LENGTH, axis=1)
        self._wrap(DataSet(feats, lab), batch_size, seed)

    @classmethod
    def _synthesize(cls, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        t = np.arange(cls.LENGTH, dtype=np.float32)
        rows, labels = [], []
        for k in range(cls.CLASSES):
            for _ in range(100):
                base = 30 + rng.normal(0, 2, cls.LENGTH)
                if k == 1:    # cyclic
                    base += 15 * np.sin(2 * np.pi * t / rng.uniform(10, 15))
                elif k == 2:  # increasing trend
                    base += rng.uniform(0.2, 0.5) * t
                elif k == 3:  # decreasing trend
                    base -= rng.uniform(0.2, 0.5) * t
                elif k == 4:  # upward shift
                    base[cls.LENGTH // 2:] += rng.uniform(7.5, 20)
                elif k == 5:  # downward shift
                    base[cls.LENGTH // 2:] -= rng.uniform(7.5, 20)
                rows.append(base)
                labels.append(k)
        return (np.asarray(rows, np.float32),
                np.asarray(labels, np.int64))
