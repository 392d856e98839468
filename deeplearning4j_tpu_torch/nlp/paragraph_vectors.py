"""ParagraphVectors (doc2vec): label-aware embeddings.

The port of the JAX package's ``nlp/paragraph_vectors.py``, on the
model's device. The analog of the reference's models/paragraphvectors/ParagraphVectors.java
with the two sequence learning algorithms from
models/embeddings/learning/impl/sequence/ (SURVEY §2.7):
  - DBOW (DBOW.java): the document label is a center "word" predicting
    every word in the document — plain SkipGram pairs with the label row.
  - DM (DM.java): the label vector joins the context window in a CBOW
    step predicting the center word.
Label vectors live in the same syn0 table as word vectors (as in the
reference, where labels are special vocab elements), so both algorithms
reuse the device steps unchanged. ``infer_vector`` trains a fresh row
against frozen syn1 (ParagraphVectors.java inferVector).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import skipgram as sk
from deeplearning4j_tpu_torch.nlp.sentence_iterators import (
    LabelAwareIterator,
    LabelledDocument,
    SentenceLabelledIterator,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class ParagraphVectors(Word2Vec):
    def __init__(self, dm: bool = False, **kwargs):
        kwargs.setdefault("use_cbow", dm)
        # DBOW rides the shared _PairStream; keep the exact per-pair
        # negative draws here (the grouped shared-negative step is
        # validated for Word2Vec SGNS, not for PV) — opt in
        # explicitly with shared_negatives=True
        kwargs.setdefault("shared_negatives", False)
        super().__init__(**kwargs)
        self.dm = dm
        self._label_set = set()

    # ---- corpus handling -------------------------------------------------
    def _docs(self, corpus) -> List[LabelledDocument]:
        if isinstance(corpus, LabelAwareIterator):
            return list(corpus)
        docs = list(corpus)
        if docs and isinstance(docs[0], str):
            return list(SentenceLabelledIterator(docs))
        return docs

    def fit(self, corpus: Union[LabelAwareIterator, Iterable[str],
                                Iterable[LabelledDocument]]):
        docs = self._docs(corpus)
        tokenized = [(self.tokenizer_factory.create(d.content).get_tokens(),
                      d.labels) for d in docs]
        self._label_set = {lb for _t, lbs in tokenized for lb in lbs}
        if self.vocab is None:
            super(Word2Vec, self).build_vocab(
                [t for t, _ in tokenized],
                special_tokens=sorted(self._label_set))
        if self.syn0 is None:
            self._init_tables()
        # lr anneal denominator: DBOW sees each token twice per epoch
        # (once as a label-pair add, once in the joint word pass)
        per_epoch = sum(len(t) for t, _ in tokenized)
        total = max(1, per_epoch * self.epochs * (1 if self.dm else 2))
        # fast paths only when no subclass customizes the doc-level
        # hooks either (same trap _fast_sgns_ok documents for
        # _train_sequence overrides)
        doc_hooks_ok = (
            type(self)._train_dbow is ParagraphVectors._train_dbow
            and type(self)._train_dm is ParagraphVectors._train_dm)
        if self._fast_hooks_ok() and doc_hooks_ok:
            if self.dm:
                lidx_lists = [
                    [i for i in (self.vocab.index_of(lb) for lb in lbs)
                     if i >= 0] for _t, lbs in tokenized]
                return self._fit_fast_cbow(
                    [t for t, _ in tokenized], total,
                    extra_per_seq=lidx_lists)
            return self._fit_fast_dbow(tokenized, total)
        k = self._k()
        batcher = sk.PairBatcher(self.batch_size, k)
        seen = 0
        for _ep in range(self.epochs):
            for tokens, labels in tokenized:
                idxs = self._indices(tokens)
                lidxs = [self.vocab.index_of(lb) for lb in labels]
                lidxs = [i for i in lidxs if i >= 0]
                if self.dm:
                    seen = self._train_dm(idxs, lidxs, seen, total)
                else:
                    seen = self._train_dbow(idxs, lidxs, batcher, seen, total)
                    # words also train among themselves (reference trains
                    # word vectors jointly unless trainWordVectors=false)
                    seen = super(Word2Vec, self)._train_sequence(
                        idxs, batcher, seen, total)
        self._flush(batcher, self._lr(seen, total))
        return self

    def _fit_fast_dbow(self, tokenized, total: int):
        """Corpus-level vectorized DBOW: ONE vocab-lookup
        pass flattens the corpus (``_encode_corpus_flat``), the label
        of every token is materialized as a per-token array per label
        slot (one numpy gather each), and both passes stream as
        corpus-level numpy over ``_window_slabs`` — the same walk the
        SGNS and CBOW producers share, no per-doc Python. Per slab:
        the (label, word) product (the doc vector predicts each of its
        words — DBOW.java), then the joint word-window pairs
        (trainWordVectors=true semantics)."""
        from deeplearning4j_tpu_torch.nlp.sequence_vectors import _PairStream
        W = self.window_size
        # total already carries DBOW's x2 token factor; the pair count
        # is ~tokens * (W + 2), so halve before scaling
        chunk = self._pair_chunk_size((total // 2) * (W + 2))

        seqs = [t for t, _ in tokenized]
        ids_all, seq_all = self._encode_corpus_flat(seqs)
        lidx_lists = [
            [i for i in (self.vocab.index_of(lb) for lb in labels)
             if i >= 0] for _t, labels in tokenized]
        # label slot j -> per-token label row (-1 where the doc has
        # fewer than j+1 labels); docs rarely carry more than one
        max_l = max((len(ls) for ls in lidx_lists), default=0)
        extras = []
        for j in range(max_l):
            lab = np.full(len(tokenized), -1, np.int32)
            for d, ls in enumerate(lidx_lists):
                if len(ls) > j:
                    lab[d] = ls[j]
            extras.append(lab[seq_all])
        extras = tuple(extras)

        if self.pairgen != "legacy":
            from deeplearning4j_tpu_torch.nlp import pairgen as pg
            walker = pg.CorpusWalker(
                self, ids_all, seq_all, extras=extras,
                force_numpy=self.pairgen == "numpy")
            n_neg = self._fused_n_neg(chunk)

            def produce(sink):
                stream = _PairStream(self, chunk, total, sink=sink,
                                     n_neg=n_neg)
                for ep in range(self.epochs):
                    view = walker.epoch(ep)
                    # one global pair counter per epoch, advanced in
                    # emission order: per slab the label rows (slot by
                    # slot), then the word-window pairs — so every pair
                    # owns a unique NEG-stream counter range
                    pair_base = 0
                    bounds = (view.slab_bounds() if view.n >= 2
                              else [(0, view.n)])
                    for lo, hi in bounds:
                        ids_slab = view.ids[lo:hi]
                        for lab in view.extras or ():
                            lab_s = lab[lo:hi]
                            lm = lab_s >= 0
                            if lm.all():
                                cen, ctx, tk = lab_s, ids_slab, \
                                    len(lab_s)
                            else:
                                cen, ctx, tk = lab_s[lm], \
                                    ids_slab[lm], int(lm.sum())
                            negs = (view.negatives(ctx, n_neg,
                                                   pair_base)
                                    if n_neg and len(ctx) else None)
                            pair_base += len(cen)
                            stream.push(cen, ctx, tokens=tk,
                                        negs=negs)
                        if view.n >= 2:
                            c, x, negs = view.walk(lo, hi,
                                                   n_neg=n_neg,
                                                   pair_base=pair_base)
                            pair_base += len(c)
                            stream.push(c, x, tokens=hi - lo,
                                        negs=negs)
                        else:
                            stream.seen += hi - lo
                stream.finish()
        else:
            def produce(sink):
                stream = _PairStream(self, chunk, total, sink=sink)
                for ids, lo, hi, grid, valid, labs in \
                        self._window_slabs(ids_all, seq_all,
                                           extras=extras):
                    ids_slab = ids[lo:hi]
                    for lab in labs:
                        lm = lab >= 0
                        # per-doc accounting advanced n tokens per label
                        # slot; spread the same progress over these
                        # pairs. All-labeled slabs (the common
                        # single-label-per-doc corpus) skip the two
                        # boolean gathers.
                        if lm.all():
                            stream.push(lab, ids_slab, tokens=len(lab))
                        else:
                            stream.push(lab[lm], ids_slab[lm],
                                        tokens=int(lm.sum()))
                    if valid is not None:
                        stream.push(
                            np.repeat(ids_slab, valid.sum(axis=1)),
                            ids[grid[valid]], tokens=hi - lo)
                    else:
                        stream.seen += hi - lo
                stream.finish()

        if self.overlap_pairgen:
            self._run_overlapped(produce)
        else:
            produce(None)
        return self

    def _train_dbow(self, idxs, lidxs, batcher, seen, total):
        for label_row in lidxs:
            for w in idxs:
                self._add_pair(label_row, w, batcher, seen, total)
                seen += 1
        return seen

    def _train_dm(self, idxs, lidxs, seen, total):
        window = self.window_size
        ctx_w = 2 * window + len(lidxs)
        if getattr(self, "_cbow_buf", None) is None or \
                self._cbow_buf.ctx_w < ctx_w:
            from deeplearning4j_tpu_torch.nlp.word2vec import _CbowBatcher
            if getattr(self, "_cbow_buf", None) is not None:
                # drain pending pairs before swapping in a wider batcher
                self._flush_cbow(self._cbow_buf, self._lr(seen, total))
            self._cbow_buf = _CbowBatcher(self.batch_size, ctx_w, self._k())
        buf = self._cbow_buf
        for pos, center in enumerate(idxs):
            lo, hi = self._window_bounds(pos, len(idxs))
            ctx = [idxs[c] for c in range(lo, hi) if c != pos] + lidxs
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

    # ---- serving ---------------------------------------------------------
    def labels(self) -> List[str]:
        return sorted(self._label_set)

    def get_label_vector(self, label: str) -> np.ndarray:
        return self.get_word_vector(label)

    def infer_vector(self, text: str, steps: int = 10,
                     learning_rate: Optional[float] = None) -> np.ndarray:
        """Train one fresh vector for unseen text against frozen syn1
        (reference: ParagraphVectors.inferVector)."""
        lr = learning_rate or self.learning_rate
        tokens = self.tokenizer_factory.create(text).get_tokens()
        idxs = [self.vocab.index_of(t) for t in tokens]
        idxs = [i for i in idxs if i >= 0]
        rng = np.random.default_rng(0)
        vec = torch.tensor(((rng.random(self.layer_size) - 0.5)
                            / self.layer_size).astype(np.float32),
                           device=self.device)
        if not idxs:
            return vec.cpu().numpy()
        k = self._k()
        # rows padded to a power-of-two bucket, as the JAX package pads
        # them (padding rows carry a zero mask)
        rows = 1 << (len(idxs) - 1).bit_length()
        targets = np.zeros((rows, k), np.int32)
        labels = np.zeros((rows, k), np.float32)
        mask = np.zeros((rows, k), np.float32)
        for _step in range(steps):
            mask[:] = 0.0
            for p, w in enumerate(idxs):
                if self.use_hs:
                    t, l = sk.hs_targets(self.vocab.element_at_index(w))
                else:
                    t, l = sk.negative_sample_targets(
                        w, self._table, self.negative, rng)
                kk = min(len(t), k)
                targets[p, :kk], labels[p, :kk] = t[:kk], l[:kk]
                mask[p, :kk] = 1.0
            sk.infer_step(vec, self.syn1,
                          *self._upload(targets, labels, mask), lr)
        return vec.cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        den = np.linalg.norm(v) * np.linalg.norm(lv)
        return float(v @ lv / den) if den else 0.0

    def predict(self, text: str) -> str:
        """Nearest label for unseen text (reference:
        ParagraphVectors.predict)."""
        v = self.infer_vector(text)
        best, best_sim = None, -np.inf
        for lb in self.labels():
            lv = self.get_label_vector(lb)
            den = np.linalg.norm(v) * np.linalg.norm(lv)
            s = float(v @ lv / den) if den else 0.0
            if s > best_sim:
                best, best_sim = lb, s
        return best
