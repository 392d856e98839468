"""Word-vector serialization.

The port of the JAX package's ``nlp/serializer.py``: the same files, so
a model written by either package is read by the other. The analog of the reference's models/embeddings/loader/WordVectorSerializer.java:87
(SURVEY §2.7): save/load in the classic word2vec text format (one
"word v1 v2 ..." line per word, optional gzip) plus a fast npz binary.
Loaders return StaticWord2Vec (serving) or hydrate a Word2Vec for
continued training.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import List, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.sequence_vectors import host_array
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import StaticWord2Vec, Word2Vec
from deeplearning4j_tpu_torch.utils.device import DeviceLike


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t", encoding="utf-8")
    return open(path, mode, encoding="utf-8")


def write_word_vectors(model, path: str):
    """Text format, word2vec-compatible (reference:
    WordVectorSerializer.writeWordVectors)."""
    words = model.vocab.words() if hasattr(model, "vocab") else model._words
    mat = (model.word_vectors_matrix if hasattr(model, "word_vectors_matrix")
           else model._vectors)
    with _open(path, "w") as f:
        f.write(f"{len(words)} {mat.shape[1]}\n")
        for i, w in enumerate(words):
            vec = " ".join(f"{x:.6g}" for x in mat[i])
            f.write(f"{w.replace(' ', '_')} {vec}\n")


def read_word_vectors(path: str) -> StaticWord2Vec:
    """reference: WordVectorSerializer.readWord2VecModel (text path)."""
    words: List[str] = []
    rows: List[np.ndarray] = []
    with _open(path, "r") as f:
        header = f.readline().split()
        dim = int(header[1]) if len(header) == 2 else None
        if dim is None:       # headerless variant
            f.seek(0)
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append(np.asarray([float(x) for x in parts[1:]], np.float32))
    return StaticWord2Vec(words, np.stack(rows))


def write_full_model(model: Word2Vec, path: str):
    """Full training state (vocab counts + syn0/syn1 + hyperparams) so
    training can resume — analog of writeFullModel/zip format."""
    meta = {
        "layer_size": model.layer_size,
        "window_size": model.window_size,
        "negative": model.negative,
        "use_hs": model.use_hs,
        "learning_rate": model.learning_rate,
        "words": model.vocab.words(),
        "counts": [w.count for w in model.vocab.vocab_words()],
        "codes": [w.codes for w in model.vocab.vocab_words()],
        "points": [w.points for w in model.vocab.vocab_words()],
        "total_word_count": model.vocab.total_word_count,
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        syn0=host_array(model.syn0), syn1=host_array(model.syn1))


def read_full_model(path: str, device: DeviceLike = None) -> Word2Vec:
    """A Word2Vec with the file's vocab and tables on ``device`` (None is
    the card)."""
    data = np.load(path if os.path.exists(path) else path + ".npz",
                   allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    model = Word2Vec(layer_size=meta["layer_size"],
                     window_size=meta["window_size"],
                     negative=meta["negative"],
                     use_hierarchic_softmax=meta["use_hs"],
                     learning_rate=meta["learning_rate"], device=device)
    cache = VocabCache()
    for w, c, codes, points in zip(meta["words"], meta["counts"],
                                   meta["codes"], meta["points"]):
        vw = VocabWord(word=w, count=c, codes=codes, points=points)
        cache.add_token(vw)
    cache.total_word_count = meta["total_word_count"]
    model.vocab = cache
    model.set_tables(data["syn0"], data["syn1"])
    if not model.use_hs:
        model._table = cache.unigram_table()
    if model.use_hs:
        model._max_code_len = max(
            (len(c) for c in meta["codes"]), default=1)
    return model
