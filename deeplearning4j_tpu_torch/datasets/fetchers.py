"""Dataset fetchers and canonical iterators.

The parts of the JAX package's ``datasets/fetchers.py`` (numpy only)
that the LeNet/``MultiLayerNetwork`` flow needs, copied: ``MnistDataFetcher``
and ``MnistDataSetIterator`` (the canonical IDX files when cached under
``DL4J_TPU_DATA_DIR``, else the same seeded synthetic stand-in),
``write_idx_gz``, ``IrisDataSetIterator`` and ``UciSequenceDataSetIterator``
(the UCI synthetic-control series when cached, else its six regimes
generated from the seed); the Adler32 cache contract (``verify_checksum``,
``fetch_with_mirror``); ``TinyImageNetFetcher`` and its iterator,
``EmnistDataSetIterator``, ``SvhnDataFetcher`` and its iterator,
``CifarDataSetIterator`` with ``write_cifar_bin``, and
``LFWDataSetIterator``, each reading its canonical files when cached and
otherwise its seeded stand-in; and ``DigitsDataSetIterator``, the
real-data iterator.

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
import zlib
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


def verify_checksum(path: str, expected: int) -> None:
    """Adler32 check of a cached dataset file — the reference's
    CacheableExtractableDataSetFetcher contract (Adler32 over the
    artifact, hard failure on mismatch). Verified once per file; a
    ``<path>.adler32.ok`` stamp (containing the value) skips re-hashing
    unless the file changed size/mtime after stamping."""
    stamp = path + ".adler32.ok"
    sig = f"{expected}:{os.path.getsize(path)}:{os.path.getmtime(path)}"
    if os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == sig:
                return
    a = 1
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            a = zlib.adler32(chunk, a)
    if a != expected:
        raise IOError(
            f"Dataset file failed checksum: {path} has adler32 {a}, "
            f"expected {expected}. Delete the file and re-populate the "
            "cache (reference: CacheableExtractableDataSetFetcher).")
    with open(stamp, "w") as fh:
        fh.write(sig)


def _sidecar_checksum(path: str) -> Optional[int]:
    """Expected checksum from a ``<path>.adler32`` sidecar, if present."""
    side = path + ".adler32"
    if os.path.exists(side):
        with open(side) as fh:
            return int(fh.read().strip())
    return None


def _maybe_verify(path: str, expected: Optional[int] = None) -> None:
    expected = expected if expected is not None else _sidecar_checksum(path)
    if expected is not None:
        verify_checksum(path, expected)


def fetch_with_mirror(url: str, dest: str,
                      expected_checksum: Optional[int] = None) -> str:
    """Download-and-verify (reference:
    CacheableExtractableDataSetFetcher.downloadAndExtract). Zero-egress
    environments point ``url`` at a ``file://`` mirror; the checksum
    contract is identical either way. Returns ``dest``."""
    if not os.path.exists(dest):
        import urllib.request
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = dest + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, dest)
    try:
        _maybe_verify(dest, expected_checksum)
    except IOError:
        os.unlink(dest)     # reference behavior: failed files are purged
        raise
    return dest


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


class TinyImageNetFetcher:
    """64x64x3, 200 classes (reference: TinyImageNetFetcher). Parses the
    CANONICAL distribution layout — ``tiny-imagenet-200/`` with
    ``wnids.txt``, ``train/<wnid>/images/*.JPEG`` and
    ``val/images`` + ``val_annotations.txt`` — decoding JPEGs via PIL
    (the reference decodes through datavec-image's native loaders).
    Falls back to a preprocessed ``train.npz`` cache, else synthetic."""

    H, W, C, CLASSES = 64, 64, 3, 200

    def __init__(self, subset: int = 10000, seed: int = 7,
                 train: bool = True):
        self.subset = subset
        self.seed = seed
        self.train = train

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image
        with Image.open(path) as im:
            a = np.asarray(im.convert("RGB"), np.uint8)
        if a.shape[:2] != (self.H, self.W):   # canonical files are 64x64
            from PIL import Image as I
            with I.open(path) as im:
                a = np.asarray(im.convert("RGB").resize((self.W, self.H)),
                               np.uint8)
        return a

    def _fetch_canonical(self, root: str) -> Tuple[np.ndarray, np.ndarray]:
        with open(os.path.join(root, "wnids.txt")) as fh:
            wnids = [w.strip() for w in fh if w.strip()]
        cls = {w: i for i, w in enumerate(wnids)}
        images, labels = [], []
        if self.train:
            # round-robin over classes so a subset stays class-balanced
            per_cls = [[] for _ in wnids]
            for w in wnids:
                d = os.path.join(root, "train", w, "images")
                if os.path.isdir(d):
                    per_cls[cls[w]] = sorted(os.listdir(d))
            i = 0
            while len(images) < self.subset:
                added = False
                for w in wnids:
                    files = per_cls[cls[w]]
                    if i < len(files):
                        images.append(self._decode(os.path.join(
                            root, "train", w, "images", files[i])))
                        labels.append(cls[w])
                        added = True
                        if len(images) >= self.subset:
                            break
                if not added:
                    break
                i += 1
        else:
            ann = os.path.join(root, "val", "val_annotations.txt")
            with open(ann) as fh:
                for line in fh:
                    parts = line.split("\t")
                    if len(parts) < 2:
                        continue
                    fname, wnid = parts[0], parts[1]
                    images.append(self._decode(os.path.join(
                        root, "val", "images", fname)))
                    labels.append(cls[wnid])
                    if len(images) >= self.subset:
                        break
        x = np.stack(images).astype(np.float32) / 255.0
        return x, np.asarray(labels, np.int64)

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        base = os.path.join(DATA_DIR, "tinyimagenet")
        if self.train:
            # preprocessed cache stays the fast path when present
            legacy = os.path.join(base, "train.npz")
            if os.path.exists(legacy):
                _maybe_verify(legacy)
                z = np.load(legacy)
                return (z["images"][:self.subset],
                        z["labels"][:self.subset])
        root = os.path.join(base, "tiny-imagenet-200")
        if os.path.isdir(root):
            split = "train" if self.train else "val"
            # write-through decode cache: ~10k PIL decodes per call
            # otherwise
            cache = os.path.join(base,
                                 f"decoded_{split}_{self.subset}.npz")
            if os.path.exists(cache):
                z = np.load(cache)
                return z["images"], z["labels"]
            images, labels = self._fetch_canonical(root)
            try:
                np.savez_compressed(cache, images=images, labels=labels)
            except OSError:
                pass                      # read-only cache dir: skip
            return images, labels
        return _synthetic_image_classes(self.subset, self.H, self.W, self.C,
                                        self.CLASSES, self.seed)


class TinyImageNetDataSetIterator(_ArrayBackedIterator):
    def __init__(self, batch_size: int, subset: int = 10000, seed: int = 7,
                 num_classes: Optional[int] = None):
        images, labels = TinyImageNetFetcher(subset, seed).fetch()
        n_cls = num_classes or TinyImageNetFetcher.CLASSES
        labels = labels % n_cls
        ds = DataSet(images, _one_hot(labels, n_cls))
        self._wrap(ds, batch_size, seed)



class EmnistDataSetIterator(_ArrayBackedIterator):
    """(reference: EmnistDataSetIterator + EmnistDataFetcher) — MNIST-format
    IDX files per EMNIST split; synthetic fallback with the split's class
    count. Splits mirror EmnistDataSetIterator.Set."""

    SETS = {"COMPLETE": 62, "MERGE": 47, "BALANCED": 47, "LETTERS": 26,
            "DIGITS": 10, "MNIST": 10}

    def __init__(self, batch_size: int, dataset: str = "BALANCED",
                 train: bool = True, subset: Optional[int] = None,
                 seed: int = 123):
        dataset = dataset.upper()
        if dataset not in self.SETS:
            raise ValueError(f"unknown EMNIST split {dataset!r}; "
                             f"one of {sorted(self.SETS)}")
        n_cls = self.SETS[dataset]
        base = os.path.join(DATA_DIR, "emnist")
        prefix = f"emnist-{dataset.lower()}-" + ("train" if train else "test")
        img_path = os.path.join(base, f"{prefix}-images-idx3-ubyte.gz")
        lbl_path = os.path.join(base, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            images = MnistDataFetcher._read_idx_images(img_path)
            labels = MnistDataFetcher._read_idx_labels(lbl_path)
            if dataset == "LETTERS":
                labels = labels - 1  # EMNIST letters are 1-indexed (a=1)
            labels = labels % n_cls
            if subset:
                images, labels = images[:subset], labels[:subset]
        else:
            n = min(subset or 10000, 10000)
            images4d, labels = _synthetic_image_classes(
                n, 28, 28, 1, n_cls, seed + (0 if train else 1))
            images = images4d.reshape(n, 784)
        ds = DataSet(images.astype(np.float32), _one_hot(labels, n_cls))
        self.num_classes = n_cls
        self._wrap(ds, batch_size, seed)



class SvhnDataFetcher:
    """32x32x3 street-view house numbers, 10 classes (reference:
    SvhnDataFetcher, which also publishes Adler32 checksums for its
    artifacts — the same contract ``verify_checksum`` implements here).

    Reads the CANONICAL cropped-digits distribution
    ``svhn/{train,test}_32x32.mat`` (MATLAB v7: ``X`` (32,32,3,N) uint8,
    ``y`` (N,1) with 10 meaning digit 0) via scipy's libmat reader; a
    preprocessed ``.npz`` is accepted for back-compat; synthetic
    fallback otherwise. A ``<file>.adler32`` sidecar in the cache dir
    triggers checksum verification."""

    H = W = 32
    C = 3
    CLASSES = 10

    def __init__(self, train: bool = True, subset: Optional[int] = None,
                 seed: int = 11,
                 expected_checksum: Optional[int] = None):
        self.train = train
        self.subset = subset
        self.seed = seed
        self.expected_checksum = expected_checksum

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        split = "train" if self.train else "test"
        mat = os.path.join(DATA_DIR, "svhn", f"{split}_32x32.mat")
        if os.path.exists(mat):
            _maybe_verify(mat, self.expected_checksum)
            from scipy.io import loadmat
            z = loadmat(mat)
            # (32, 32, 3, N) → NHWC; label "10" is the digit 0
            images = np.transpose(z["X"], (3, 0, 1, 2)) \
                .astype(np.float32) / 255.0
            labels = z["y"].reshape(-1).astype(np.int64) % self.CLASSES
            if self.subset:
                images, labels = images[:self.subset], labels[:self.subset]
            return images, labels
        path = os.path.join(DATA_DIR, "svhn", f"{split}_32x32.npz")
        if os.path.exists(path):
            _maybe_verify(path, self.expected_checksum)
            with np.load(path) as z:
                images = z["X"].astype(np.float32) / 255.0
                labels = z["y"].astype(np.int64) % self.CLASSES
            if self.subset:
                images, labels = images[:self.subset], labels[:self.subset]
            return images, labels
        n = min(self.subset or 5000, 5000)
        return _synthetic_image_classes(
            n, self.H, self.W, self.C, self.CLASSES,
            self.seed + (0 if self.train else 1))


class SvhnDataSetIterator(_ArrayBackedIterator):
    def __init__(self, batch_size: int, train: bool = True,
                 subset: Optional[int] = None, seed: int = 11):
        images, labels = SvhnDataFetcher(train, subset, seed).fetch()
        ds = DataSet(images, _one_hot(labels, SvhnDataFetcher.CLASSES))
        self._wrap(ds, batch_size, seed)



class CifarDataSetIterator(_ArrayBackedIterator):
    """32x32x3, 10 classes (reference: CifarDataSetIterator). Reads the
    canonical ``cifar-10-batches-bin`` layout if cached, else synthetic."""

    H = W = 32
    C = 3
    CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True,
                 subset: Optional[int] = None, seed: int = 17):
        base = os.path.join(DATA_DIR, "cifar-10-batches-bin")
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [os.path.join(base, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            images, labels = self._read_bin(paths)
            if subset:
                images, labels = images[:subset], labels[:subset]
        else:
            n = min(subset or 5000, 5000)
            images, labels = _synthetic_image_classes(
                n, self.H, self.W, self.C, self.CLASSES,
                seed + (0 if train else 1))
        ds = DataSet(images, _one_hot(labels, self.CLASSES))
        self._wrap(ds, batch_size, seed)

    @classmethod
    def _read_bin(cls, paths) -> Tuple[np.ndarray, np.ndarray]:
        rec = 1 + 3072
        imgs, lbls = [], []
        for p in paths:
            raw = np.fromfile(p, np.uint8).reshape(-1, rec)
            lbls.append(raw[:, 0].astype(np.int64))
            chw = raw[:, 1:].reshape(-1, 3, 32, 32)
            imgs.append(chw.transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
        return np.concatenate(imgs), np.concatenate(lbls)


def write_cifar_bin(images: np.ndarray, labels: np.ndarray,
                    path: str) -> None:
    """Write (N, 32, 32, 3) uint8 NHWC images + (N,) labels in the
    canonical ``cifar-10-batches-bin`` record format (label byte + 3072
    CHW bytes) — lets tests/users populate the cache so the real-file
    path is exercised byte-for-byte (same contract as write_idx_gz)."""
    images = np.asarray(images, np.uint8)
    labels = np.asarray(labels, np.uint8)
    n = images.shape[0]
    chw = images.transpose(0, 3, 1, 2).reshape(n, 3072)
    rec = np.concatenate([labels[:, None], chw], axis=1)
    d = os.path.dirname(path)
    if d:                      # bare filename → cwd, no mkdir needed
        os.makedirs(d, exist_ok=True)
    rec.tofile(path)



class LFWDataSetIterator(_ArrayBackedIterator):
    """Labeled-faces-in-the-wild (reference: LFWDataSetIterator). The
    reference decodes JPEGs via DataVec's image reader; here a cached
    ``lfw/lfw.npz`` (``X`` float images NHWC, ``y`` int labels) is used,
    else a synthetic multi-class face-shaped set."""

    def __init__(self, batch_size: int, num_examples: int = 1000,
                 image_shape: Tuple[int, int, int] = (64, 64, 3),
                 num_labels: int = 40, train: bool = True, seed: int = 42):
        h, w, c = image_shape
        path = os.path.join(DATA_DIR, "lfw", "lfw.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                images = z["X"].astype(np.float32)
                labels = z["y"].astype(np.int64) % num_labels
            images, labels = images[:num_examples], labels[:num_examples]
        else:
            images, labels = _synthetic_image_classes(
                min(num_examples, 2000), h, w, c, num_labels,
                seed + (0 if train else 1))
        self.num_labels = num_labels
        ds = DataSet(images, _one_hot(labels, num_labels))
        self._wrap(ds, batch_size, seed)


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
