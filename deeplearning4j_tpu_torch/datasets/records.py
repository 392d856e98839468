"""Record readers and the DataVec bridge.

A numpy-only copy of the JAX package's ``datasets/records.py``: the
equivalent of the reference's DataVec ETL surface (CSV and collection
record readers, sequence readers) and of its bridge iterators
(``RecordReaderDataSetIterator.java``, in classification and
regression; ``SequenceRecordReaderDataSetIterator.java`` with its
alignment modes). Records are float32 numpy rows; a CSV field is parsed
by Python's ``float`` and rounded to float32 (the JAX package's numpy
path; its optional native parser rounds the text to float32 directly,
which agrees except for fields within a float32 rounding tie). The
bridge emits padded and masked sequence batches; the alignment modes
map to mask layouts (ALIGN_START, ALIGN_END, EQUAL_LENGTH). The batches
are host arrays; a model's ``fit`` moves them to its device.
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator


# -------------------------------------------------------------------------
# Readers
# -------------------------------------------------------------------------

class RecordReader:
    """Iterable over records (1-D float arrays)."""

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def reset(self):
        pass


class CSVRecordReader(RecordReader):
    """Numeric CSV file/text reader (DataVec CSVRecordReader analog).

    ``skip_lines`` skips headers.
    """

    def __init__(self, path: Optional[str] = None,
                 text: Optional[str] = None, delimiter: str = ",",
                 skip_lines: int = 0):
        if (path is None) == (text is None):
            raise ValueError("provide exactly one of path= or text=")
        self.path, self.text = path, text
        self.delimiter = delimiter
        self.skip_lines = skip_lines
        self._data: Optional[np.ndarray] = None

    def _load(self) -> np.ndarray:
        if self._data is None:
            text = self.text
            if text is None:
                with open(self.path, "r") as f:
                    text = f.read()
            if self.skip_lines:
                text = "\n".join(text.splitlines()[self.skip_lines:])
            rows = [r for r in text.splitlines() if r.strip()]
            self._data = np.asarray(
                [[float(v) for v in r.split(self.delimiter)]
                 for r in rows], np.float32)
        return self._data

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self._load())


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec CollectionRecordReader)."""

    def __init__(self, records: Sequence[Sequence[float]]):
        self._records = [np.asarray(r, np.float32) for r in records]

    def __iter__(self):
        return iter(self._records)


class SequenceRecordReader:
    """Iterable over sequences: each item is a (T, F) float matrix
    (DataVec SequenceRecordReader)."""

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Sequence[float]]]):
        self._seqs = [np.asarray(s, np.float32) for s in sequences]

    def __iter__(self):
        return iter(self._seqs)


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (DataVec CSVSequenceRecordReader)."""

    def __init__(self, paths: Sequence[str], delimiter: str = ",",
                 skip_lines: int = 0):
        self.readers = [CSVRecordReader(path=p, delimiter=delimiter,
                                        skip_lines=skip_lines)
                        for p in paths]

    def __iter__(self):
        for r in self.readers:
            yield r._load()


# -------------------------------------------------------------------------
# Bridge iterators
# -------------------------------------------------------------------------

def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((idx.shape[0], n), np.float32)
    out[np.arange(idx.shape[0]), idx.astype(np.int64)] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSet batches (RecordReaderDataSetIterator.java).

    ``label_index`` selects the label column; with ``num_classes`` the
    label becomes one-hot (classification), otherwise it stays a
    regression target. ``label_index_to`` selects a label column range
    (multi-output regression), inclusive, like the reference.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 label_index_to: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.label_index_to = label_index_to
        self.num_classes = num_classes
        self.regression = regression or label_index_to is not None

    def _split(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        li = self.label_index
        if li is None:
            return rows, rows        # unsupervised: features as labels
        hi = (self.label_index_to if self.label_index_to is not None
              else li)
        feats = np.concatenate([rows[:, :li], rows[:, hi + 1:]], axis=1)
        labels = rows[:, li:hi + 1]
        if not self.regression:
            if self.num_classes is None:
                raise ValueError(
                    "classification needs num_classes (or pass"
                    " regression=True)")
            labels = _one_hot(labels[:, 0], self.num_classes)
        return feats.astype(np.float32), labels.astype(np.float32)

    def __iter__(self) -> Iterator[DataSet]:
        buf: List[np.ndarray] = []
        for rec in self.reader:
            buf.append(np.asarray(rec, np.float32))
            if len(buf) == self._batch:
                f, l = self._split(np.stack(buf))
                yield DataSet(f, l)
                buf = []
        if buf:
            f, l = self._split(np.stack(buf))
            yield DataSet(f, l)
        self.reader.reset()

    def reset(self):
        self.reader.reset()

    @property
    def batch_size(self):
        return self._batch


class AlignmentMode(enum.Enum):
    """Sequence label alignment (SequenceRecordReaderDataSetIterator
    AlignmentMode): where shorter sequences sit inside the padded window."""
    ALIGN_START = "align_start"
    ALIGN_END = "align_end"
    EQUAL_LENGTH = "equal_length"


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """(features_seq_reader, labels_seq_reader) -> padded+masked DataSet
    batches (SequenceRecordReaderDataSetIterator.java, incl. seq2seq
    alignment modes — SURVEY §2.3)."""

    def __init__(self, feature_reader: SequenceRecordReader,
                 label_reader: Optional[SequenceRecordReader],
                 batch_size: int,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 alignment: AlignmentMode = AlignmentMode.ALIGN_START):
        self.feature_reader = feature_reader
        self.label_reader = label_reader
        self._batch = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.alignment = alignment

    def _pack(self, feats: List[np.ndarray], labels: List[np.ndarray]):
        t_max = max(max(f.shape[0] for f in feats),
                    max(l.shape[0] for l in labels))
        n = len(feats)
        fdim = feats[0].shape[1]
        if self.regression or self.num_classes is None:
            ldim = labels[0].shape[1]
        else:
            ldim = self.num_classes
        f_out = np.zeros((n, t_max, fdim), np.float32)
        l_out = np.zeros((n, t_max, ldim), np.float32)
        f_mask = np.zeros((n, t_max), np.float32)
        l_mask = np.zeros((n, t_max), np.float32)
        for i, (f, l) in enumerate(zip(feats, labels)):
            tf_, tl = f.shape[0], l.shape[0]
            if self.alignment is AlignmentMode.EQUAL_LENGTH \
                    and tf_ != tl:
                raise ValueError(
                    f"EQUAL_LENGTH alignment but lengths {tf_} != {tl}")
            if not self.regression and self.num_classes is not None:
                l = _one_hot(l[:, 0], self.num_classes)
            if self.alignment is AlignmentMode.ALIGN_END:
                f_out[i, t_max - tf_:] = f
                f_mask[i, t_max - tf_:] = 1.0
                l_out[i, t_max - tl:] = l
                l_mask[i, t_max - tl:] = 1.0
            else:
                f_out[i, :tf_] = f
                f_mask[i, :tf_] = 1.0
                l_out[i, :tl] = l
                l_mask[i, :tl] = 1.0
        return DataSet(f_out, l_out, f_mask, l_mask)

    def __iter__(self) -> Iterator[DataSet]:
        feats, labels = [], []
        label_iter = (iter(self.label_reader)
                      if self.label_reader is not None else None)
        for f in self.feature_reader:
            f = np.asarray(f, np.float32)
            if label_iter is not None:
                l = np.asarray(next(label_iter), np.float32)
            else:
                # single-reader mode: last column is the per-step label
                l = f[:, -1:]
                f = f[:, :-1]
            feats.append(f)
            labels.append(l)
            if len(feats) == self._batch:
                yield self._pack(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._pack(feats, labels)
        self.feature_reader.reset()
        if self.label_reader is not None:
            self.label_reader.reset()

    def reset(self):
        self.feature_reader.reset()
        if self.label_reader is not None:
            self.label_reader.reset()

    @property
    def batch_size(self):
        return self._batch
