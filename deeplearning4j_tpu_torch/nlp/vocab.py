"""Vocabulary construction + Huffman coding.

Analog of the reference's models/word2vec/wordstore/ (VocabConstructor.java:32,
VocabCache.java, inmemory/AbstractCache.java) and word2vec/Huffman.java
(SURVEY §2.7, §3.6): scan a token stream, count frequencies, apply a
min-frequency cutoff, and build the Huffman tree used by hierarchical
softmax (codes/points per word, as in the reference's VocabWord).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclasses.dataclass
class VocabWord:
    """reference: models/word2vec/VocabWord.java — word + frequency +
    Huffman code/points filled in by Huffman.build()."""
    word: str
    count: int = 0
    index: int = -1
    codes: List[int] = dataclasses.field(default_factory=list)
    points: List[int] = dataclasses.field(default_factory=list)


class VocabCache:
    """In-memory vocab store (reference: wordstore/inmemory/
    AbstractCache.java). Words are index-addressable; index order is
    descending frequency (ties by first occurrence)."""

    def __init__(self):
        self._words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_word_count = 0

    def add_token(self, vw: VocabWord):
        vw.index = len(self._words)
        self._words.append(vw)
        self._by_word[vw.word] = vw
        # word->index cache (built lazily by _encode_corpus_flat)
        self._index_by_word = None

    def contains_word(self, word: str) -> bool:
        return word in self._by_word

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._by_word.get(word)

    def index_of(self, word: str) -> int:
        vw = self._by_word.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, idx: int) -> str:
        return self._words[idx].word

    def element_at_index(self, idx: int) -> VocabWord:
        return self._words[idx]

    def num_words(self) -> int:
        return len(self._words)

    def words(self) -> List[str]:
        return [w.word for w in self._words]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._words)

    def word_frequency(self, word: str) -> int:
        vw = self._by_word.get(word)
        return 0 if vw is None else vw.count

    def unigram_table(self, table_size: int = 1_000_000,
                      power: float = 0.75) -> np.ndarray:
        """Negative-sampling table: word index drawn ∝ count^0.75
        (reference builds this natively inside AggregateSkipGram;
        word2vec.c heritage)."""
        counts = np.array([w.count for w in self._words], dtype=np.float64)
        probs = counts ** power
        probs /= probs.sum()
        return np.random.default_rng(12345).choice(
            len(self._words), size=table_size, p=probs).astype(np.int32)


class VocabConstructor:
    """Corpus scan → VocabCache (reference: wordstore/
    VocabConstructor.java:32 buildJointVocabulary)."""

    def __init__(self, min_word_frequency: int = 1,
                 stop_words: Optional[Iterable[str]] = None):
        self.min_word_frequency = min_word_frequency
        self.stop_words = frozenset(stop_words or ())

    def build_vocab(self, token_sequences: Iterable[List[str]],
                    special_tokens: Iterable[str] = ()) -> VocabCache:
        counts: Counter = Counter()
        total = 0
        for seq in token_sequences:
            for tok in seq:
                if tok and tok not in self.stop_words:
                    counts[tok] += 1
                    total += 1
        cache = VocabCache()
        # special tokens (e.g. ParagraphVectors labels) bypass the cutoff
        for tok in special_tokens:
            if tok not in counts:
                counts[tok] = 1
        order = sorted(counts.items(), key=lambda kv: (-kv[1],))
        specials = set(special_tokens)
        for word, count in order:
            if count >= self.min_word_frequency or word in specials:
                cache.add_token(VocabWord(word=word, count=count))
        cache.total_word_count = total
        return cache


class Huffman:
    """Huffman tree over vocab frequencies → per-word binary code + inner
    node path (reference: models/word2vec/Huffman.java). ``points[i]`` are
    inner-node rows of syn1, ``codes[i]`` the branch bits."""

    MAX_CODE_LENGTH = 40

    def __init__(self, words: List[VocabWord]):
        self.words = words

    def build(self):
        n = len(self.words)
        if n == 0:
            return
        if n == 1:
            self.words[0].codes = [0]
            self.words[0].points = [0]
            return
        # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
        heap = [(w.count, i, i) for i, w in enumerate(self.words)]
        heapq.heapify(heap)
        parent = {}
        bit = {}
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a] = next_id
            parent[b] = next_id
            bit[a] = 0
            bit[b] = 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, w in enumerate(self.words):
            codes: List[int] = []
            points: List[int] = []
            node = i
            while node != root:
                codes.append(bit[node])
                node = parent[node]
                points.append(node - n)  # inner-node index into syn1
            codes.reverse()
            points.reverse()
            w.codes = codes[: self.MAX_CODE_LENGTH]
            w.points = points[: self.MAX_CODE_LENGTH]
