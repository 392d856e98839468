"""Bag-of-words / TF-IDF vectorizers.

Analog of the reference's bagofwords/vectorizer/ (BagOfWordsVectorizer,
TfidfVectorizer — SURVEY §2.7): corpus → fixed-width count or tf-idf
feature matrix over the vocab, suitable as DataSet features.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Iterable[str] = ()):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = stop_words
        self.vocab: Optional[VocabCache] = None

    def fit(self, corpus: Iterable[str]):
        tokens = [self.tokenizer_factory.create(s).get_tokens()
                  for s in corpus]
        self.vocab = VocabConstructor(
            self.min_word_frequency, self.stop_words).build_vocab(tokens)
        self._post_fit(tokens)
        return self

    def _post_fit(self, token_lists: List[List[str]]):
        pass

    def transform(self, corpus: Iterable[str]) -> np.ndarray:
        out = []
        for s in corpus:
            row = np.zeros(self.vocab.num_words(), np.float32)
            for tok in self.tokenizer_factory.create(s).get_tokens():
                idx = self.vocab.index_of(tok)
                if idx >= 0:
                    row[idx] += 1.0
            out.append(self._weight(row))
        return np.stack(out) if out else np.zeros(
            (0, self.vocab.num_words()), np.float32)

    def _weight(self, counts: np.ndarray) -> np.ndarray:
        return counts

    def fit_transform(self, corpus: Iterable[str]) -> np.ndarray:
        docs = list(corpus)
        self.fit(docs)
        return self.transform(docs)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf weighting with smooth idf (reference: TfidfVectorizer.java)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._idf: Optional[np.ndarray] = None

    def _post_fit(self, token_lists: List[List[str]]):
        n_docs = max(1, len(token_lists))
        df = np.zeros(self.vocab.num_words(), np.float64)
        for toks in token_lists:
            for idx in {self.vocab.index_of(t) for t in toks}:
                if idx >= 0:
                    df[idx] += 1
        self._idf = np.log((1 + n_docs) / (1 + df)) + 1.0

    def _weight(self, counts: np.ndarray) -> np.ndarray:
        tf = counts / max(1.0, counts.sum())
        return (tf * self._idf).astype(np.float32)
