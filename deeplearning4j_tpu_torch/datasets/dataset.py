"""DataSet and iterator protocol.

A copy of the JAX package's ``datasets/dataset.py`` (numpy only; analog of
ND4J's ``DataSet``/``MultiDataSet`` and the reference's
``DataSetIterator`` contract). A DataSet is a minibatch: features,
labels, optional masks, as host numpy arrays until a model moves them to
its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        def sl(a, lo, hi):
            return None if a is None else a[lo:hi]
        n = self.num_examples()
        return (DataSet(*(sl(a, 0, n_train) for a in self._arrays())),
                DataSet(*(sl(a, n_train, n) for a in self._arrays())))

    def _arrays(self):
        return (self.features, self.labels, self.features_mask, self.labels_mask)

    def shuffle(self, seed: int = 0) -> "DataSet":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_examples())
        def idx(a):
            return None if a is None else np.asarray(a)[perm]
        return DataSet(*(idx(a) for a in self._arrays()))

    @staticmethod
    def merge(batches: Sequence["DataSet"]) -> "DataSet":
        def cat(xs):
            xs = [x for x in xs if x is not None]
            return np.concatenate([np.asarray(x) for x in xs],
                                  axis=0) if xs else None
        return DataSet(cat([b.features for b in batches]),
                       cat([b.labels for b in batches]),
                       cat([b.features_mask for b in batches]),
                       cat([b.labels_mask for b in batches]))


@dataclasses.dataclass
class MultiDataSet:
    """Multiple feature/label arrays for ComputationGraph (analog of ND4J
    MultiDataSet)."""
    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


class DataSetIterator:
    """Iterator protocol: iterable over DataSet minibatches with reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    @property
    def batch_size(self) -> Optional[int]:
        return None

    @property
    def async_supported(self) -> bool:
        return True


class ListDataSetIterator(DataSetIterator):
    """In-memory iterator over a list of pre-built minibatches (analog of
    the reference's ListDataSetIterator)."""

    def __init__(self, batches: Sequence[DataSet]):
        self._batches = list(batches)

    def __iter__(self):
        return iter(self._batches)

    def __len__(self):
        return len(self._batches)

    @property
    def batch_size(self):
        return self._batches[0].num_examples() if self._batches else None


class ArrayDataSetIterator(DataSetIterator):
    """Batches a single large DataSet (supports shuffling each epoch)."""

    def __init__(self, data: DataSet, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self._data = data
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last

    def __iter__(self):
        d = self._data
        if self._shuffle:
            d = d.shuffle(self._seed + self._epoch)
            self._epoch += 1
        n = d.num_examples()
        end = n - (n % self._bs) if self._drop_last else n
        for lo in range(0, end, self._bs):
            hi = min(lo + self._bs, n)
            def cut(a):
                return None if a is None else np.asarray(a)[lo:hi]
            yield DataSet(cut(d.features), cut(d.labels),
                          cut(d.features_mask), cut(d.labels_mask))

    @property
    def batch_size(self):
        return self._bs
