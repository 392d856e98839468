"""The port's record readers and DataVec bridge iterators
(datasets/records.py) against the JAX package's on the CPU: every
reader and both iterators, in classification, regression and
unsupervised form and with every ``AlignmentMode``, on the same CSV
files written into ``tmp_path``, yield batches bitwise equal to the JAX
package's (values printed as float32 round-trip strings, so both
packages' parsers give the same floats).
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import records as JR
from deeplearning4j_tpu_torch.datasets import records as TR


def _csv(path, rows, header=None):
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        for r in rows:
            f.write(",".join(repr(float(np.float32(v))) for v in r) + "\n")
    return str(path)


def _table(seed=0, n=23, f=4, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    lab = rng.integers(0, classes, n).astype(np.float32)
    return np.concatenate([x[:, :2], lab[:, None], x[:, 2:]], axis=1)


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in ((g.features, w.features), (g.labels, w.labels),
                     (g.features_mask, w.features_mask),
                     (g.labels_mask, w.labels_mask)):
            if b is None:
                assert a is None
                continue
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mode", ["classification", "regression",
                                  "range", "unsupervised"])
def test_csv_record_reader_iterator(tmp_path, mode):
    path = _csv(tmp_path / "t.csv", _table(), header="a,b,c,d,e")
    kw = {"classification": dict(label_index=2, num_classes=3),
          "regression": dict(label_index=2, regression=True),
          "range": dict(label_index=1, label_index_to=2),
          "unsupervised": {}}[mode]
    its = [M.RecordReaderDataSetIterator(
        M.CSVRecordReader(path=path, skip_lines=1), 5, **kw)
        for M in (TR, JR)]
    assert_same_batches(its[0], its[1])
    assert its[0].batch_size == 5
    # a second pass after reset gives the same batches again
    its[0].reset()
    assert_same_batches(its[0], its[1])


def test_csv_text_and_collection_readers(tmp_path):
    table = _table(1, n=9)
    text = "\n".join(";".join(repr(float(v)) for v in r) for r in table)
    for make in (lambda M: M.CSVRecordReader(text=text, delimiter=";"),
                 lambda M: M.CollectionRecordReader(table.tolist())):
        assert_same_batches(
            TR.RecordReaderDataSetIterator(make(TR), 4, label_index=2,
                                           num_classes=3),
            JR.RecordReaderDataSetIterator(make(JR), 4, label_index=2,
                                           num_classes=3))
    with pytest.raises(ValueError):
        TR.CSVRecordReader()
    with pytest.raises(ValueError, match="num_classes"):
        list(TR.RecordReaderDataSetIterator(
            TR.CollectionRecordReader(table.tolist()), 4, label_index=2))


def _sequences(seed, lengths, f):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (t, f)).astype(np.float32) for t in lengths]


@pytest.mark.parametrize("alignment", ["ALIGN_START", "ALIGN_END",
                                       "EQUAL_LENGTH"])
@pytest.mark.parametrize("labels", ["classes", "regression"])
def test_sequence_iterator_alignments(tmp_path, alignment, labels):
    lengths = [5, 3, 7, 4, 6]
    feats = _sequences(0, lengths, 3)
    if labels == "classes":
        labs = [np.random.default_rng(t).integers(0, 4, (t, 1)).astype(
            np.float32) for t in lengths]
    else:
        labs = _sequences(1, lengths, 2)
    if alignment != "EQUAL_LENGTH":
        labs = [l[: max(1, len(l) - 1)] for l in labs]   # shorter labels
    fpaths = [_csv(tmp_path / f"f{i}.csv", s) for i, s in enumerate(feats)]
    lpaths = [_csv(tmp_path / f"l{i}.csv", s) for i, s in enumerate(labs)]
    kw = (dict(num_classes=4) if labels == "classes"
          else dict(regression=True))
    its = [M.SequenceRecordReaderDataSetIterator(
        M.CSVSequenceRecordReader(fpaths), M.CSVSequenceRecordReader(lpaths),
        2, alignment=getattr(M.AlignmentMode, alignment), **kw)
        for M in (TR, JR)]
    assert_same_batches(its[0], its[1])


def test_sequence_single_reader_and_equal_length_error():
    seqs = [s.tolist() for s in _sequences(2, [4, 6, 5], 4)]
    assert_same_batches(
        TR.SequenceRecordReaderDataSetIterator(
            TR.CollectionSequenceRecordReader(seqs), None, 2,
            regression=True),
        JR.SequenceRecordReaderDataSetIterator(
            JR.CollectionSequenceRecordReader(seqs), None, 2,
            regression=True))
    labs = [s[:2] for s in seqs]
    it = TR.SequenceRecordReaderDataSetIterator(
        TR.CollectionSequenceRecordReader(seqs),
        TR.CollectionSequenceRecordReader(labs), 2, regression=True,
        alignment=TR.AlignmentMode.EQUAL_LENGTH)
    with pytest.raises(ValueError, match="EQUAL_LENGTH"):
        list(it)


def test_records_feed_a_port_fit(tmp_path):
    """A CSV file through the bridge into ``fit(iterator)`` of a port
    model on the CPU, as the card's records phase runs it."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from test_torch_telemetry import mln_pair
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.normal(0, 1, (24, 5)),
                           rng.integers(0, 3, (24, 1))], axis=1)
    path = _csv(tmp_path / "r.csv", rows)       # 5 features, label last
    tm, _ = mln_pair()
    twin = tm.clone()
    it = TR.RecordReaderDataSetIterator(TR.CSVRecordReader(path=path), 8,
                                        label_index=5, num_classes=3)
    tm.fit(it)
    for b in TR.RecordReaderDataSetIterator(TR.CSVRecordReader(path=path),
                                            8, label_index=5,
                                            num_classes=3):
        twin.fit(DataSet(b.features, b.labels))
    for ln, lp in tm.params.items():
        for k, v in lp.items():
            assert v.equal(twin.params[ln][k])
