"""Cluster text pipeline — the Spark-NLP analog.

The port of the JAX package's ``nlp/cluster.py``: the workers are
Word2Vec models on one device, trained in turn in one process, and their
tables are averaged on the host with the JAX package's numpy code.

Reference: dl4j-spark-nlp's ``TextPipeline``
(deeplearning4j-scaleout/spark/dl4j-spark-nlp/.../functions/TextPipeline.java:48 —
tokenize per partition, accumulate word counters, filter by min word
frequency, build the shared vocab) and ``Word2VecPerformer`` (same tree
— per-partition skip-gram training against broadcast weights, merged by
the parameter-averaging master).

Design: the "cluster" is host processes around a device
mesh, not Spark executors. Map and reduce are explicit:

- ``TextPipeline``: shards a corpus, tokenizes + counts per shard (the
  map), merges counters into one ``VocabCache`` (the reduce) — bitwise
  identical to the single-host vocab build.
- ``DistributedWord2Vec``: one ``Word2Vec`` worker per shard, all seeded
  from the same initial tables; each round every worker trains its shard
  (the vectorized SGNS device loop), then syn0/syn1 are parameter-
  averaged — the Spark master's ``averageAndPropagate`` semantics. On a
  real multi-host pod each worker is a process with its own corpus
  shard; here workers run in one process over the corpus shards, which
  is the same math (the reference's local[N] test mode).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.sequence_vectors import host_array
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class TextPipeline:
    """Sharded tokenize → count → filter → vocab (TextPipeline.java:48)."""

    def __init__(self, num_shards: int = 4,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Iterable[str] = ()):
        self.num_shards = max(1, num_shards)
        self.tokenizer_factory = (tokenizer_factory
                                  or DefaultTokenizerFactory())
        self.min_word_frequency = min_word_frequency
        self.stop_words = frozenset(stop_words)

    def shard(self, corpus: Iterable[str]) -> List[List[str]]:
        shards: List[List[str]] = [[] for _ in range(self.num_shards)]
        for i, sentence in enumerate(corpus):
            shards[i % self.num_shards].append(sentence)
        return shards

    def tokenize_shard(self, sentences: Sequence[str]) -> List[List[str]]:
        """The per-partition map: raw sentences → token sequences.
        Empty results are KEPT (as []) so local indices still invert the
        round-robin sharding for count_shard's position keys."""
        out = []
        for s in sentences:
            out.append([t for t in
                        self.tokenizer_factory.create(s).get_tokens()
                        if t and t not in self.stop_words])
        return out

    def count_shard(self, token_seqs: Iterable[Sequence[str]],
                    shard_index: int = 0) -> dict:
        """Per-partition word counters (the accumulator): word →
        [count, first_global_position]. The position key inverts the
        round-robin sharding (global sentence = local_j * num_shards +
        shard_index), so the reduce can break frequency ties in original
        corpus-appearance order — the single-host constructor's Counter
        insertion order."""
        counts: dict = {}
        for j, seq in enumerate(token_seqs):
            sent = j * self.num_shards + shard_index
            for ti, t in enumerate(seq):
                entry = counts.get(t)
                if entry is None:
                    counts[t] = [1, (sent, ti)]
                else:
                    entry[0] += 1
        return counts

    def reduce_vocab(self, shard_counts: Sequence[dict]) -> VocabCache:
        """Merge counters, apply min frequency; ordering = count desc
        with ties in first-appearance order — index-identical to the
        single-host VocabConstructor (Huffman codes / syn1 rows line up
        across the two build paths)."""
        merged: dict = {}
        for counts in shard_counts:
            for w, (c, first) in counts.items():
                entry = merged.get(w)
                if entry is None:
                    merged[w] = [c, first]
                else:
                    entry[0] += c
                    entry[1] = min(entry[1], first)
        vocab = VocabCache()
        items = sorted(merged.items(), key=lambda kv: (-kv[1][0],
                                                       kv[1][1]))
        for w, (c, _first) in items:
            if c >= self.min_word_frequency:
                vocab.add_token(VocabWord(word=w, count=c))
        vocab.total_word_count = sum(c for c, _ in merged.values())
        return vocab

    def build_vocab(self, corpus: Iterable[str]) -> VocabCache:
        shards = self.shard(corpus)
        counts = [self.count_shard(self.tokenize_shard(s), i)
                  for i, s in enumerate(shards)]
        return self.reduce_vocab(counts)


class DistributedWord2Vec:
    """Data-parallel Word2Vec over corpus shards with parameter
    averaging (Word2VecPerformer + ParameterAveraging master analog)."""

    def __init__(self, num_workers: int = 4, averaging_rounds: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **w2v_kwargs):
        self.num_workers = max(1, num_workers)
        self.averaging_rounds = max(1, averaging_rounds)
        self.w2v_kwargs = dict(w2v_kwargs)
        self.pipeline = TextPipeline(
            num_shards=self.num_workers,
            tokenizer_factory=tokenizer_factory,
            min_word_frequency=self.w2v_kwargs.get("min_word_frequency", 1),
            stop_words=self.w2v_kwargs.get("stop_words", ()))
        self.model: Optional[Word2Vec] = None

    def fit(self, corpus: Iterable[str]) -> Word2Vec:
        sentences = list(corpus)
        shards_raw = self.pipeline.shard(sentences)
        token_shards = [self.pipeline.tokenize_shard(s)
                        for s in shards_raw]
        vocab = self.pipeline.reduce_vocab(
            [self.pipeline.count_shard(ts, i)
             for i, ts in enumerate(token_shards)])
        token_shards = [[s for s in ts if s] for ts in token_shards]

        # global model: shared vocab + one set of initial tables
        master = Word2Vec(**self.w2v_kwargs)
        master.vocab = vocab
        if master.use_hs:
            Huffman(vocab.vocab_words()).build()
            master._max_code_len = max(
                (len(w.codes) for w in vocab.vocab_words()), default=1)
        master._init_tables()

        epochs = master.epochs
        for _round in range(self.averaging_rounds):
            syn0s, syn1s = [], []
            for wid, shard in enumerate(token_shards):
                if not shard:
                    continue
                worker = Word2Vec(**{**self.w2v_kwargs,
                                     "seed": master.seed + wid})
                worker.vocab = vocab
                worker._max_code_len = master._max_code_len
                worker._table = master._table
                if master.use_hs:
                    # share the device-resident Huffman matrices
                    # (read-only)
                    worker._hs_points = master._hs_points
                    worker._hs_labels = master._hs_labels
                    worker._hs_mask = master._hs_mask
                worker.epochs = max(1, epochs // self.averaging_rounds)
                # broadcast current globals (the Spark broadcast step) —
                # as COPIES: the device loop updates its tables in place
                worker.set_tables(host_array(master.syn0),
                                  host_array(master.syn1))
                worker.fit(shard)
                syn0s.append(host_array(worker.syn0))
                syn1s.append(host_array(worker.syn1))
            if syn0s:
                master.set_tables(np.mean(syn0s, axis=0),
                                  np.mean(syn1s, axis=0))
        self.model = master
        return master
