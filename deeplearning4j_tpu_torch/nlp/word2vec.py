"""Word2Vec: SkipGram/CBOW over text corpora.

The port of the JAX package's ``nlp/word2vec.py`` (reference:
models/word2vec/Word2Vec.java:32, extends SequenceVectors): a
SentenceIterator + TokenizerFactory turn raw text into token sequences,
then training is SequenceVectors' device loop (``nlp/skipgram.py``) on
the model's device. CBOW's producer is the JAX package's host code; its
superchunks go through the same upload and in-place scanned steps.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.nlp import skipgram as sk
from deeplearning4j_tpu_torch.nlp.sentence_iterators import SentenceIterator
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    """reference: Word2Vec.Builder — same knob names (layerSize →
    layer_size, windowSize → window_size, minWordFrequency, negative,
    useHierarchicSoftmax, elementsLearningAlgorithm SkipGram/CBOW)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    # ---- text front-end --------------------------------------------------
    def _tokenize(self, corpus) -> List[List[str]]:
        # materialize first so type-sniffing can't consume a generator
        items = corpus if isinstance(corpus, list) else list(corpus)
        if items and isinstance(items[0], str):
            return [self.tokenizer_factory.create(s).get_tokens()
                    for s in items]
        if items and all(isinstance(s, list) for s in items):
            return items       # already token lists: no 3M-token copy
        return [list(s) for s in items]

    def fit(self, corpus: Union[SentenceIterator, Iterable[str],
                                Iterable[Sequence[str]]]):
        return super().fit(self._tokenize(corpus))

    def fit_stream(self, sentences: Iterable[str], *,
                   window_sentences: int = 1000,
                   max_windows: Optional[int] = None,
                   on_window=None) -> "Word2Vec":
        """Train from an UNBOUNDED sentence stream (a
        StreamingSentenceIterator or a follow-mode
        CorpusDataSetIterator) in windows of ``window_sentences``:

        - the FIRST window builds the vocab, which is then fixed —
          stable syn0/syn1 geometry means downstream consumers
          (OnlineServing promotion) never see a shape change, so
          refreshed embeddings hot-swap with zero recompiles; later
          out-of-vocab tokens are dropped like any sub-min-frequency
          word
        - every window then runs one full ``fit`` pass over its
          sentences (``epochs`` per window, lr re-annealing per window
          — the streaming analog of restarting the linear decay each
          corpus revision)
        - ``on_window(model, index, n_sentences)`` fires after each
          window — the hot-promotion hook

        Consumes until the stream ends (EOS / idle timeout / stream
        cap) or ``max_windows`` windows. Returns self."""
        import itertools
        it = iter(sentences)
        wi = 0
        while max_windows is None or wi < max_windows:
            batch = list(itertools.islice(it, window_sentences))
            if not batch:
                break
            self.fit(batch)
            wi += 1
            if on_window is not None:
                on_window(self, wi - 1, len(batch))
        return self

    def build_vocab(self, corpus, special_tokens: Iterable[str] = ()):
        return super().build_vocab(self._tokenize(corpus),
                                   special_tokens=special_tokens)

    # ---- CBOW training path ---------------------------------------------
    def _train_sequence(self, idxs, batcher, seen, total):
        if not self.use_cbow:
            return super()._train_sequence(idxs, batcher, seen, total)
        # CBOW: context window predicts center (reference: CBOW.java via
        # AggregateCBOW). Batched separately because the h-vector is a
        # masked mean over context rows.
        window = self.window_size
        ctx_w = 2 * window
        if not hasattr(self, "_cbow_buf") or self._cbow_buf is None:
            self._cbow_buf = _CbowBatcher(self.batch_size, ctx_w, self._k())
        buf = self._cbow_buf
        for pos, center in enumerate(idxs):
            lo, hi = self._window_bounds(pos, len(idxs))
            ctx = [idxs[c] for c in range(lo, hi) if c != pos]
            if not ctx:
                seen += 1
                continue
            if self.use_hs:
                targets, labels = sk.hs_targets(
                    self.vocab.element_at_index(center))
            else:
                targets, labels = sk.negative_sample_targets(
                    center, self._table, self.negative, self._rng)
            if buf.add(ctx, targets, labels):
                self._flush_cbow(buf, self._lr(seen, total))
            seen += 1
        return seen

    def fit_finalize(self):
        pass

    def _flush(self, batcher, lr):
        super()._flush(batcher, lr)
        if getattr(self, "_cbow_buf", None) is not None:
            self._flush_cbow(self._cbow_buf, lr)

    def _flush_cbow(self, buf: "_CbowBatcher", lr: float):
        if buf.n == 0 and buf.mask.sum() == 0:
            return
        sk.cbow_step(self.syn0, self.syn1, *self._upload(*buf.take()), lr)

    # non-CBOW calls delegate straight to the base hook, so the vectorized
    # SGNS fast path stays valid for Word2Vec (see _fast_sgns_ok)
    _train_sequence._sgns_fast_path_safe = True

    def _dispatch_chunks(self, prep):
        """Adds the CBOW superchunk kinds to the base consumer (same
        prepare/dispatch split — see SequenceVectors._dispatch_chunks)."""
        kind = prep[0]
        if kind == "cbow_hs":
            ctx, cmask, cen, nv, lrs = self._upload(*prep[1:])
            sk.cbow_hs_scan_step(
                self.syn0, self.syn1, ctx, cmask, cen, self._hs_points,
                self._hs_labels, self._hs_mask, nv, lrs)
        elif kind == "cbow_ns":
            ctx, cmask, tgt, nv, lrs = self._upload(*prep[1:])
            sk.cbow_scan_step(self.syn0, self.syn1, ctx, cmask, tgt, nv,
                              lrs)
        else:
            super()._dispatch_chunks(prep)

    def _fit_fast_cbow(self, seqs, total_words: int,
                       extra_per_seq=None):
        """Vectorized CBOW (NS and HS): context windows built with the
        same numpy offsets grid the SGNS fast path uses, one in-place
        ``cbow_step`` per chunk — replaces the per-center Python loop
        (reference: AggregateCBOW batching, CBOW.java).

        ``extra_per_seq``: per-sequence id lists appended to every
        center's context window — ParagraphVectors' DM mode (the doc
        label vectors join each context)."""
        rng = self._rng
        if self.device_pair_generation:
            import warnings
            warnings.warn(
                "device_pair_generation does not cover CBOW; using the "
                "host context-window pipeline", stacklevel=2)
        W = self.window_size
        max_extra = (max((len(e) for e in extra_per_seq), default=0)
                     if extra_per_seq else 0)
        ctx_w = 2 * W + max_extra
        from deeplearning4j_tpu_torch.nlp.sequence_vectors import _PairStream
        chunk = self._pair_chunk_size(total_words)  # one center per token
        depth = _PairStream.DEPTH   # chunks per scanned dispatch
        k = self._k()
        ctx_buf = np.zeros((depth, chunk, ctx_w), np.int32)
        cmask_buf = np.zeros((depth, chunk, ctx_w), np.float32)
        cen_buf = np.zeros((depth, chunk), np.int32)
        nv = np.zeros(depth, np.int32)
        lrs = np.zeros(depth, np.float32)
        hs = self.use_hs
        if hs:
            self._ensure_hs_matrices()
        table = self._table
        n_words = self.vocab.num_words()
        # fused pairgen covers plain CBOW only (DM's per-doc label
        # columns keep the per-sequence producer); with NS its per-row
        # negatives ride the counter streams instead of flush-time draws
        fused = self.pairgen != "legacy" and not max_extra
        n_negf = 0 if (hs or not fused) else k - 1
        negs_buf = (np.zeros((depth, chunk, n_negf), np.int32)
                    if n_negf else None)
        d = 0
        fill = 0
        seen = 0

        def produce(sink):
            nonlocal d, fill, seen

            def flush():
                nonlocal d
                if d == 0:
                    return
                nv[d:] = 0
                lrs[d:] = 0.0
                # .copy(): the loop keeps mutating these buffers
                # (see _fit_fast_sgns)
                if hs:
                    prep = ("cbow_hs", ctx_buf.copy(), cmask_buf.copy(),
                            cen_buf.copy(), nv.copy(), lrs.copy())
                else:
                    tgt = np.zeros((depth, chunk, k), np.int32)
                    tgt[..., 0] = cen_buf
                    if negs_buf is not None:
                        # fused counter-stream draws (nlp/pairgen.py);
                        # rows past nv are inert under the mask
                        tgt[..., 1:] = negs_buf
                    else:
                        flat = tgt.reshape(-1, k)
                        flat[:, 1:] = sk.draw_negatives(
                            rng, table, flat[:, 0:1], k - 1, n_words)
                    prep = ("cbow_ns", ctx_buf.copy(),
                            cmask_buf.copy(), tgt, nv.copy(),
                            lrs.copy())
                d = 0
                sink(prep)

            def seal():
                nonlocal d, fill
                nv[d] = fill
                lrs[d] = self._lr(seen, total_words)
                if fill < chunk:
                    cmask_buf[d, fill:] = 0.0
                d += 1
                fill = 0
                if d == depth:
                    flush()

            def push_rows(cens, ctxs, valids, tokens=0.0, negs=None):
                """``tokens`` of anneal progress spreads evenly over the
                rows (the _PairStream.push contract — advancing ``seen``
                up front snaps small corpora straight to
                min_learning_rate)."""
                nonlocal fill, seen
                p, n = 0, len(cens)
                if n == 0:
                    seen += tokens
                    return
                per = tokens / n
                while p < n:
                    take = min(chunk - fill, n - p)
                    sl = slice(fill, fill + take)
                    seen += per * take
                    cen_buf[d, sl] = cens[p:p + take]
                    ctx_buf[d, sl] = ctxs[p:p + take]
                    cmask_buf[d, sl] = \
                        valids[p:p + take].astype(np.float32)
                    if negs is not None:
                        negs_buf[d, sl] = negs[p:p + take]
                    fill += take
                    p += take
                    if fill == chunk:
                        seal()

            if max_extra:
                # DM: per-sequence loop (label columns vary per doc)
                for _epoch in range(self.epochs):
                    for si, seq in enumerate(seqs):
                        idxs = np.asarray(self._indices(seq), np.int32)
                        n = len(idxs)
                        # even a 1-token doc trains its label vector
                        if n < 1:
                            continue
                        grid, valid = sk.window_grid(n, W, rng)
                        ctx = idxs[np.clip(grid, 0, n - 1)]
                        e = np.asarray(extra_per_seq[si], np.int32)
                        pad = np.zeros(max_extra - len(e), np.int32)
                        ctx = np.concatenate(
                            [ctx,
                             np.tile(np.concatenate([e, pad]), (n, 1))],
                            axis=1)
                        evalid = np.concatenate(
                            [np.ones(len(e), bool),
                             np.zeros(max_extra - len(e), bool)])
                        valid = np.concatenate(
                            [valid, np.tile(evalid, (n, 1))], axis=1)
                        push_rows(idxs, ctx, valid, tokens=n)
            elif fused:
                # fused pairgen (nlp/pairgen.py): subsample + window
                # rows + negatives in one native (or bitwise-equal
                # numpy) pass, row counter = emitted rows per epoch
                from deeplearning4j_tpu_torch.nlp import pairgen as pg
                ids_all, seq_all = self._encode_corpus_flat(seqs)
                walker = pg.CorpusWalker(
                    self, ids_all, seq_all,
                    force_numpy=self.pairgen == "numpy")
                for ep in range(self.epochs):
                    view = walker.epoch(ep)
                    if view.n < 2:
                        seen += view.n
                        continue
                    row_base = 0
                    for lo, hi in view.slab_bounds():
                        ctx, cmask, cens, negs = view.walk_cbow(
                            lo, hi, n_neg=n_negf, row_base=row_base)
                        row_base += len(cens)
                        push_rows(cens, ctx, cmask, tokens=hi - lo,
                                  negs=negs)
            else:
                # plain CBOW corpus-level numpy via the SAME
                # window walk the SGNS fast path uses (_window_slabs) —
                # one flat encode, offsets-grid slabs, no per-sequence
                # Python (the measured host bound)
                ids_all, seq_all = self._encode_corpus_flat(seqs)
                for ids, lo, hi, grid, valid in self._window_slabs(
                        ids_all, seq_all):
                    if valid is None:
                        seen += hi - lo
                        continue
                    keep = valid.any(axis=1)   # centers w/ context
                    push_rows(ids[lo:hi][keep], ids[grid][keep],
                              valid[keep], tokens=hi - lo)
            if fill:
                seal()
            flush()

        if self.overlap_pairgen:
            self._run_overlapped(produce)
        else:
            produce(self._dispatch_chunks)
        return self


class _CbowBatcher:
    def __init__(self, batch_size: int, ctx_w: int, k: int):
        self.batch_size, self.ctx_w, self.k = batch_size, ctx_w, k
        self.ctx = np.zeros((batch_size, ctx_w), np.int32)
        self.cmask = np.zeros((batch_size, ctx_w), np.float32)
        self.targets = np.zeros((batch_size, k), np.int32)
        self.labels = np.zeros((batch_size, k), np.float32)
        self.mask = np.zeros((batch_size, k), np.float32)
        self.n = 0

    def add(self, ctx, targets, labels) -> bool:
        i = self.n
        w = min(len(ctx), self.ctx_w)
        self.ctx[i, :w] = ctx[:w]
        self.cmask[i, :w] = 1.0
        self.cmask[i, w:] = 0.0
        kk = min(len(targets), self.k)
        self.targets[i, :kk] = targets[:kk]
        self.labels[i, :kk] = labels[:kk]
        self.mask[i, :kk] = 1.0
        self.mask[i, kk:] = 0.0
        self.n += 1
        return self.n >= self.batch_size

    def take(self):
        out = (self.ctx.copy(), self.cmask.copy(), self.targets.copy(),
               self.labels.copy(), self.mask.copy())
        if self.n < self.batch_size:
            out[4][self.n:] = 0.0
            out[1][self.n:] = 0.0
        self.n = 0
        self.mask[:] = 0.0
        self.cmask[:] = 0.0
        return out


class StaticWord2Vec:
    """Read-only vector lookup (reference: word2vec/StaticWord2Vec.java —
    memory-mapped serving copy without training state)."""

    def __init__(self, words: List[str], vectors: np.ndarray):
        self._index = {w: i for i, w in enumerate(words)}
        self._words = list(words)
        self._vectors = np.asarray(vectors, np.float32)

    @classmethod
    def from_model(cls, w2v: SequenceVectors) -> "StaticWord2Vec":
        return cls(w2v.vocab.words(), w2v.word_vectors_matrix)

    def has_word(self, w: str) -> bool:
        return w in self._index

    def get_word_vector(self, w: str) -> np.ndarray:
        return self._vectors[self._index[w]]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        den = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / den) if den else 0.0
