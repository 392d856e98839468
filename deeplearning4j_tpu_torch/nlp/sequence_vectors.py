"""SequenceVectors: the generic embedding trainer.

The port of the JAX package's ``nlp/sequence_vectors.py`` (reference:
models/sequencevectors/SequenceVectors.java:50, ``fit()`` at :193): build
a vocab over element sequences, then train SkipGram/CBOW over windows.
Word2Vec, ParagraphVectors and DeepWalk all specialise this class.

The host side is the JAX package's, line for line: the corpus encode,
the pair producers (``nlp/pairgen.py``, native when built), the chunk
buffers and the lr anneal, so both packages hand their device steps the
same arrays. The tables ``syn0``/``syn1`` are torch tensors on the
model's device (``device=None`` is the card, ``resolve_device``), updated
in place by ``nlp/skipgram.py``'s steps. A superchunk's arrays reach the
card through pinned staging buffers on a side stream
(``datasets/feeder.py``'s ``StagingRing``: a buffer is rewritten only
after the event of the copy that read it), and its chunk steps queue
without a host sync, so the producer thread builds the next superchunk
while the card trains on this one.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import skipgram as sk
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device


def host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a device tensor (a snapshot: the tables are
    updated in place)."""
    return t.detach().to("cpu", copy=True).numpy()


class Uploader:
    """Host arrays to the model's device. On the card each array is
    copied into a pinned slot of a ``StagingRing`` (a slot is rewritten
    only after the event of the copy that last read it), sent on a side
    stream, and handed to the compute stream; on the CPU it is a copy
    (the host loops rewrite their buffers after a flush)."""

    SLOTS = 3

    def __init__(self, device: torch.device):
        self.device = device
        self.transport = self.ring = None
        if device.type == "cuda":
            from deeplearning4j_tpu_torch.datasets.feeder import (
                CudaTransport, StagingRing)
            self.transport = CudaTransport(device)
            self.ring = StagingRing(self.SLOTS, self.transport.alloc)

    def __call__(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if self.transport is None:
            return [torch.from_numpy(a.copy()) for a in arrays]
        slots = [self.ring.stage(a) for a in arrays]
        out = [self.transport.copy(s.buf) for s in slots]
        event = self.transport.record()
        for s in slots:
            s.event = event
        self.transport.hand_off(out, event)
        return out


def token_seed(seed: int, n_flush: int) -> int:
    """The device pair generator's seed for flush ``n_flush``: the model
    seed ``^ 0x5EED`` and the flush counter through the pair
    generator's splitmix64 mixer."""
    from deeplearning4j_tpu_torch.nlp.pairgen import GOLDEN, _mix_int
    return _mix_int((seed ^ 0x5EED) + GOLDEN * (n_flush + 1))


def _corpus_positions(seq_id: np.ndarray):
    """Per-token (position-within-sequence, sequence-length) for a flat
    encoded corpus — ONE numpy pass, no per-sequence loop. Shared by the
    SGNS and CBOW corpus-level pair generators."""
    n = len(seq_id)
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(seq_id[1:], seq_id[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    seg = np.cumsum(change) - 1
    # int32: the (slab, 2W) window arithmetic downstream is memory
    # bound — half-width indices halve its traffic
    pos = (np.arange(n) - starts[seg]).astype(np.int32)
    lens = np.diff(np.append(starts, n))
    return pos, lens[seg].astype(np.int32)


class _PairStream:
    """Chunked (center, context) consumer for the vectorized SGNS/HS
    paths (used by SequenceVectors and ParagraphVectors' DBOW): buffers
    ``depth`` chunks of pushed pair arrays and flushes them as ONE
    scanned device dispatch (sk.skipgram_scan_step) — the scan applies
    the chunks sequentially (same math as chunk-at-a-time) while
    amortizing the per-dispatch transport overhead depth× and letting
    the host build the next superchunk while the device drains this
    one. ``seen`` is advanced by the producer; the lr anneal snapshots
    it per chunk (word2vec.c's linear decay)."""

    DEPTH = 8

    def __init__(self, model, chunk: int, total_words: int,
                 depth: int = DEPTH, sink=None, n_neg: int = 0):
        self.m = model
        self.chunk = chunk
        self.depth = depth
        self.total = total_words
        self.seen = 0
        self.cen = np.zeros((depth, chunk), np.int32)
        # n_neg > 0: the fused producers (nlp/pairgen.py) push their
        # stream-drawn per-pair negatives alongside the pairs. They are
        # buffered interleaved in the device-shaped (1 + n_neg) target
        # rows (context in column 0), so _flush forwards ONE copy
        # instead of re-assembling the rows — and skips its own
        # draw_negatives pass.
        self.n_neg = n_neg
        if n_neg > 0:
            self.tgt = np.zeros((depth, chunk, 1 + n_neg), np.int32)
            self.ctx = self.tgt[..., 0]
            self.neg = self.tgt[..., 1:]
        else:
            self.tgt = None
            self.ctx = np.zeros((depth, chunk), np.int32)
            self.neg = None
        self.nv = np.zeros(depth, np.int32)
        self.lrs = np.zeros(depth, np.float32)
        self.d = 0          # chunks filled
        self.fill = 0       # rows filled in the current chunk
        # ``sink``: where sealed superchunks go. Default = dispatch the
        # device step inline (serial). The overlapped fit loop passes a
        # queue.put so a producer thread can run ALL host work (pair
        # gen + negative draws, everything rng-ordered) while the main
        # thread drains device dispatches.
        self.sink = sink if sink is not None else self.m._dispatch_chunks
        if model.use_hs:
            model._ensure_hs_matrices()

    def push(self, centers: np.ndarray, contexts: np.ndarray,
             tokens: float = 0.0, negs: np.ndarray = None):
        """``tokens`` spreads that many corpus tokens' worth of
        lr-anneal progress evenly over these pairs, so producers that
        batch many sequences per push keep the
        same smooth decay the per-sequence producer had — advancing
        ``seen`` up front would snap small corpora straight to
        min_learning_rate. ``negs``: per-pair
        (n, n_neg) fused negative draws (requires n_neg at
        construction)."""
        if len(centers) == 0:
            self.seen += tokens
            return
        per = tokens / len(centers)
        p = 0
        while p < len(centers):
            take = min(self.chunk - self.fill, len(centers) - p)
            self.seen += per * take
            self.cen[self.d, self.fill:self.fill + take] = \
                centers[p:p + take]
            self.ctx[self.d, self.fill:self.fill + take] = \
                contexts[p:p + take]
            if negs is not None:
                self.neg[self.d, self.fill:self.fill + take] = \
                    negs[p:p + take]
            self.fill += take
            p += take
            if self.fill == self.chunk:
                self._seal_chunk()

    def _seal_chunk(self):
        self.nv[self.d] = self.fill
        self.lrs[self.d] = self.m._lr(self.seen, self.total)
        self.d += 1
        self.fill = 0
        if self.d == self.depth:
            self._flush()

    def finish(self):
        if self.fill:
            self._seal_chunk()
        self._flush()

    def _flush(self):
        """Seal the superchunk: finish ALL host-side work (including the
        rng-ordered negative draws, so producer-thread and serial modes
        make identical rng calls in identical order → bitwise-equal
        training) and hand the prepared arrays to the sink."""
        if self.d == 0:
            return
        m = self.m
        self.nv[self.d:] = 0                 # unused chunks are inert
        self.lrs[self.d:] = 0.0
        if m.use_hs:
            prep = ("hs", self.cen.copy(), self.ctx.copy(),
                    self.nv.copy(), self.lrs.copy())
        elif getattr(m, "shared_negatives", False) and m.negative > 0 \
                and self.chunk % sk.SHARED_NEG_GROUP == 0:
            g = self.chunk // sk.SHARED_NEG_GROUP
            draws = m._rng.integers(0, len(m._table),
                                    (self.depth, g, m.negative))
            negs = m._table[draws].astype(np.int32)
            prep = ("shared", self.cen.copy(), self.ctx.copy(),
                    self.nv.copy(), self.lrs.copy(), negs)
        else:
            k = 1 + m.negative
            if self.n_neg:
                # fused producers already drew per-pair negatives on
                # their counter streams and pushed them interleaved
                # into self.tgt; rows past nv are inert (stale but
                # always-valid indices under the nv mask)
                tgt = self.tgt.copy()
            else:
                tgt = np.zeros((self.depth, self.chunk, k), np.int32)
                tgt[..., 0] = self.ctx
                flat = tgt.reshape(-1, k)
                flat[:, 1:] = sk.draw_negatives(
                    m._rng, m._table, flat[:, 0:1], k - 1,
                    m.vocab.num_words())
            prep = ("perpair", self.cen.copy(), tgt,
                    self.nv.copy(), self.lrs.copy())
        self.d = 0
        self.sink(prep)


class SequenceVectors:
    """Builder-configured embedding trainer (reference:
    SequenceVectors.Builder)."""

    def __init__(self,
                 layer_size: int = 100,
                 window_size: int = 5,
                 min_word_frequency: int = 1,
                 iterations: int = 1,
                 epochs: int = 1,
                 negative: int = 5,
                 use_hierarchic_softmax: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 sampling: float = 0.0,
                 batch_size: int = 512,
                 seed: int = 42,
                 stop_words: Iterable[str] = (),
                 use_cbow: bool = False,
                 device_pair_generation: bool = False,
                 shared_negatives: bool = True,
                 overlap_pairgen: bool = True,
                 pairgen: str = "auto",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._upload = Uploader(self.device)
        self.layer_size = layer_size
        self.window_size = window_size
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.epochs = epochs
        self.negative = negative if not use_hierarchic_softmax else 0
        self.use_hs = use_hierarchic_softmax
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.sampling = sampling
        self.batch_size = batch_size
        self.seed = seed
        self.stop_words = stop_words
        self.use_cbow = use_cbow
        # opt-in: generate (center, context) pairs ON DEVICE
        # (skipgram.token_draws + skipgram_token_update), removing the
        # host pair pipeline; not the default, as in the JAX package.
        self.device_pair_generation = device_pair_generation
        # Negative samples shared per 512-pair group (skipgram.py
        # _sg_update_shared): sharing turns the negative work into
        # batched products. Same negative DISTRIBUTION, different
        # per-pair draws; False restores per-pair negatives.
        self.shared_negatives = shared_negatives
        # Double-buffer host pair generation against device compute:
        # a producer thread prepares superchunk N+1
        # while the device trains on N. Identical math (same rng call
        # order); False restores the strictly serial loop.
        self.overlap_pairgen = overlap_pairgen
        # Host pair-generation backend:
        #   "auto"   — the fused subsample+walk+negatives pass
        #              (native/dl4j_native.cpp when built, else its
        #              bitwise-identical numpy fallback)
        #   "numpy"  — the fused pass, fallback pinned (the A/B bench's
        #              reference arm)
        #   "legacy" — the separate-stage numpy producer
        # The fused backends own a counter-based splitmix64 stream
        # seeded off ``seed`` (nlp/pairgen.py), so they are seeded-
        # reproducible but not pair-for-pair identical to "legacy".
        if pairgen not in ("auto", "numpy", "legacy"):
            raise ValueError(f"pairgen must be auto|numpy|legacy, "
                             f"got {pairgen!r}")
        self.pairgen = pairgen

        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng(seed)
        self._table: Optional[np.ndarray] = None
        self._max_code_len = 0

    # ---- vocab + tables --------------------------------------------------
    def build_vocab(self, sequences: Iterable[Sequence[str]],
                    special_tokens: Iterable[str] = ()):
        ctor = VocabConstructor(self.min_word_frequency, self.stop_words)
        self.vocab = ctor.build_vocab(
            (list(s) for s in sequences), special_tokens=special_tokens)
        if self.use_hs:
            Huffman(self.vocab.vocab_words()).build()
            self._max_code_len = max(
                (len(w.codes) for w in self.vocab.vocab_words()), default=1)
        return self

    def _init_tables(self):
        n, d = self.vocab.num_words(), self.layer_size
        rng = np.random.default_rng(self.seed)
        syn0 = ((rng.random((n, d)) - 0.5) / d).astype(np.float32)
        rows1 = max(n - 1, 1) if self.use_hs else n
        self.set_tables(syn0, np.zeros((rows1, d), np.float32))
        if not self.use_hs:
            self._table = self.vocab.unigram_table()
        else:
            self._ensure_hs_matrices()

    def set_tables(self, syn0, syn1):
        """Install ``syn0``/``syn1`` (numpy arrays or tensors) as tables
        the model owns on its device: always a copy, because the steps
        update the tables in place and must never write into the
        caller's arrays."""
        self.syn0 = torch.tensor(np.asarray(syn0, np.float32),
                                 device=self.device)
        self.syn1 = torch.tensor(np.asarray(syn1, np.float32),
                                 device=self.device)

    def _ensure_hs_matrices(self):
        """Device-resident Huffman-path matrices for the vectorized HS
        step (host loop ships only index pairs). Built lazily so models
        whose tables arrived WITHOUT _init_tables — deserialized models,
        DistributedWord2Vec workers — still fast-path correctly."""
        if getattr(self, "_hs_points", None) is not None:
            return
        if not self._max_code_len:
            self._max_code_len = max(
                (len(w.codes) for w in self.vocab.vocab_words()),
                default=1)
        pts, labs, hmask = sk.build_hs_matrices(
            self.vocab.vocab_words(), max(self._max_code_len, 1))
        self._hs_points, self._hs_labels, self._hs_mask = (
            torch.from_numpy(a).to(self.device) for a in (pts, labs, hmask))

    # ---- training --------------------------------------------------------
    def fit(self, sequences: Iterable[Sequence[str]]):
        if isinstance(sequences, list) and all(
                isinstance(s, list) for s in sequences):
            seqs = sequences   # host pairgen is the SGNS bound: don't
        else:                  # re-copy an already-materialized corpus
            seqs = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seqs)
        if self.syn0 is None:
            self._init_tables()
        total_words = max(
            1, sum(len(s) for s in seqs) * self.epochs * self.iterations)
        if (self.use_cbow and self._fast_hooks_ok()
                and hasattr(self, "_fit_fast_cbow")):
            return self._fit_fast_cbow(seqs, total_words)
        if self._fast_sgns_ok():
            if self.device_pair_generation:
                if (not self.use_hs and self.sampling == 0.0
                        and self.negative > 0):
                    return self._fit_tokens_sgns(seqs, total_words)
                import warnings
                warnings.warn(
                    "device_pair_generation only covers plain SGNS "
                    "(negative>0, sampling=0, no HS/CBOW); falling back "
                    "to the host pair pipeline", stacklevel=2)
            return self._fit_fast_sgns(seqs, total_words)
        k = self._k()
        batcher = sk.PairBatcher(self.batch_size, k)
        seen = 0
        for _epoch in range(self.epochs):
            for seq in seqs:
                idxs = self._indices(seq)
                for _it in range(self.iterations):
                    seen = self._train_sequence(
                        idxs, batcher, seen, total_words)
        self._flush(batcher, self._lr(seen, total_words))
        return self

    # ---- vectorized SGNS hot path ---------------------------------------
    def _fast_sgns_ok(self) -> bool:
        """The vectorized path covers plain skip-gram negative sampling.
        Word2Vec's overrides delegate here for non-CBOW, so it qualifies;
        ParagraphVectors/GloVe run their own fit loops and never reach
        this. Subclasses that customize pair generation must override
        ``_add_pair`` or ``_train_sequence`` — either disqualifies them
        automatically (the slow path's per-sequence hook is
        ``_train_sequence``, so a subclass overriding only that must not
        silently get generic SGNS behavior). A subclass whose override
        merely delegates (Word2Vec) can opt back in by setting
        ``_sgns_fast_path_safe = True`` on the override function."""
        return (not self.use_cbow and self._fast_hooks_ok())

    def _fast_hooks_ok(self) -> bool:
        """True when no subclass customizes pair generation (the
        condition for ANY vectorized path — SGNS, HS, or CBOW)."""
        ts = type(self)._train_sequence
        train_seq_ok = (ts is SequenceVectors._train_sequence
                        or getattr(ts, "_sgns_fast_path_safe", False))
        return (self.iterations == 1
                and type(self)._add_pair is SequenceVectors._add_pair
                and train_seq_ok)

    def _fit_tokens_sgns(self, seqs, total_words: int):
        """Device-side pair generation: the host ships padded (S, L)
        token-id matrices; the draws (``skipgram.token_draws``, a
        ``torch.Generator`` on the model's device seeded by
        ``token_seed(seed, flush)``), window expansion, negative
        sampling and the update all run on the device. Used for plain
        SGNS without subsampling.

        Sentences longer than the row width are chunked and windows do
        not cross chunk boundaries — the same truncation word2vec.c
        applies at MAX_SENTENCE_LENGTH (its sentences split at 1000
        tokens); with L<=512 the lost boundary pairs are <=W(W+1) per
        chunk."""
        W = self.window_size
        # row width: fit the longest sentence piece (cap 512) — padding
        # slots still compute masked pairs, so loose rows burn device
        # time (40-token sentences in 128-wide rows = 3x waste)
        max_len = max((len(s) for s in seqs), default=2)
        L = int(min(512, max(8, max_len)))
        rows_per_epoch = sum((len(s) + L - 1) // L for s in seqs) or 1
        est_rows = rows_per_epoch * self.epochs
        # flush sizing: ~256k pair slots amortizes dispatch overhead
        # without blowing up the clip's sort/cumsum working set; shrink
        # for small corpora so they still get >=~64 optimizer steps
        budget_rows = max(4, 262144 // (L * 2 * W))
        S = int(np.clip(est_rows // 64, 4, budget_rows))
        buf = np.zeros((S, L), np.int32)
        lens = np.zeros(S, np.int32)
        # host table -> device, once per fit
        table_dev = torch.from_numpy(
            np.asarray(self._table, np.int32)).to(self.device)
        gen = torch.Generator(device=self.device)
        fill = 0
        seen = 0
        n_flush = 0

        def flush(n):
            nonlocal fill, n_flush
            if n == 0:
                return
            if n < S:
                lens[n:] = 0
            lr = self._lr(seen, total_words)
            tokens, lengths = self._upload(buf, lens)
            gen.manual_seed(token_seed(self.seed, n_flush))
            b, negs = sk.token_draws(tokens.shape, table_dev, window=W,
                                     n_neg=self.negative, generator=gen)
            sk.skipgram_token_update(self.syn0, self.syn1, tokens, lengths,
                                     b, negs, lr, window=W,
                                     n_neg=self.negative)
            n_flush += 1
            fill = 0

        for _epoch in range(self.epochs):
            for seq in seqs:
                idxs = np.asarray(self._indices(seq), np.int32)
                seen += len(idxs)
                for lo in range(0, len(idxs), L):
                    piece = idxs[lo:lo + L]
                    if len(piece) < 2:
                        continue
                    buf[fill, :len(piece)] = piece
                    lens[fill] = len(piece)
                    fill += 1
                    if fill == S:
                        flush(S)
        flush(fill)
        return self

    def _dispatch_chunks(self, prep):
        """Run one prepared superchunk on the device: its arrays are
        uploaded, then its chunk steps queue in order. Pure consumer: all
        host randomness already happened in _PairStream."""
        kind, arrays = prep[0], self._upload(*prep[1:])
        if kind == "hs":
            cen, ctx, nv, lrs = arrays
            sk.skipgram_hs_scan_step(
                self.syn0, self.syn1, cen, ctx, self._hs_points,
                self._hs_labels, self._hs_mask, nv, lrs)
        elif kind == "shared":
            cen, ctx, nv, lrs, negs = arrays
            sk.skipgram_scan_step_shared(self.syn0, self.syn1, cen, ctx,
                                         negs, nv, lrs)
        else:
            cen, tgt, nv, lrs = arrays
            sk.skipgram_scan_step(self.syn0, self.syn1, cen, tgt, nv, lrs)

    def _run_overlapped(self, produce, queue_depth: int = 2):
        """Double-buffered fit loop (the reference
        overlaps via trainer threads, SequenceVectors.java:193): a
        producer thread runs ``produce(sink)`` — all host pair
        generation, numpy slab ops release the GIL — pushing prepared
        superchunks into a bounded queue while this thread drains
        device dispatches. Bitwise-identical to the serial path: the
        producer makes the same rng calls in the same order, and
        dispatch order is FIFO."""
        import queue as _queue
        import threading

        q: "_queue.Queue" = _queue.Queue(maxsize=queue_depth)
        done = object()
        stop = threading.Event()

        class _Stop(BaseException):
            pass

        def sink(prep):
            if stop.is_set():       # consumer died: end pairgen NOW,
                raise _Stop()       # not after the remaining corpus
            q.put(prep)

        def producer():
            try:
                produce(sink)
                q.put(done)
            except _Stop:
                q.put(done)
            except BaseException as e:          # surface in consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True,
                             name="dl4j-pairgen")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                self._dispatch_chunks(item)
        finally:
            # consumer died mid-stream: signal the producer (it aborts
            # at its next sealed superchunk) and drain until its
            # terminal token so a q.put can't deadlock against join()
            stop.set()
            while t.is_alive():
                try:
                    item = q.get(timeout=0.1)
                except _queue.Empty:
                    continue
                if item is done or isinstance(item, BaseException):
                    break
            t.join()

    def _pair_chunk_size(self, est_pairs: int) -> int:
        """Chunk sizing shared by the vectorized pair paths: large chunks
        amortize per-dispatch cost; update staleness within a chunk is the same
        hogwild-style race the reference's multithreaded native loop
        accepts (SURVEY §3.6). Scaled to the corpus so small corpora
        still get ≥~64 sequential optimizer steps per fit. Rounded up
        to the shared-negative group size so the grouped kernel's
        [G, group] reshape always divides."""
        c = int(np.clip(est_pairs // 64, self.batch_size, 65536))
        g = sk.SHARED_NEG_GROUP
        return -(-c // g) * g

    def _encode_corpus_flat(self, seqs):
        """One host pass over the corpus: vocab lookup into a flat int32
        id array plus the sequence id of every surviving token; everything
        downstream is corpus-level numpy, with no per-sequence loop."""
        import itertools
        lookup = self.vocab._by_word
        lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
        total = int(lens.sum())
        # stream the corpus through map(dict.get, tokens, repeat(-1))
        # — an index dict keeps the whole lookup in C (map feeds get's
        # default from the second iterable). Cached on the vocab object: lookup dicts
        # outlive fits, rebuilds swap the vocab instance.
        by_idx = getattr(self.vocab, "_index_by_word", None)
        if by_idx is None:
            by_idx = {w: vw.index for w, vw in lookup.items()}
            self.vocab._index_by_word = by_idx
        idx = np.fromiter(
            map(by_idx.get, itertools.chain.from_iterable(seqs),
                itertools.repeat(-1)), np.int32, total)
        keep = idx >= 0
        seq_id = np.repeat(np.arange(len(seqs)), lens)[keep]
        return idx[keep], seq_id

    def _subsample_mask(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized frequent-word subsampling (word2vec.c's keep
        probability), redrawn per epoch like the sequential path. The
        per-index counts array is cached — vocab counts are fixed for
        the whole fit."""
        cached = getattr(self, "_counts_arr", None)
        # keyed on vocab object identity: a rebuilt vocab of equal SIZE
        # must not reuse stale frequencies
        if cached is None or cached[0] is not self.vocab:
            counts = np.zeros(self.vocab.num_words(), np.float64)
            for vw in self.vocab.vocab_words():
                counts[vw.index] = vw.count
            self._counts_arr = cached = (self.vocab, counts)
        counts = cached[1]
        total = max(1, self.vocab.total_word_count)
        f = counts[ids] / total
        keep_p = (np.sqrt(f / self.sampling) + 1) * self.sampling \
            / np.maximum(f, 1e-300)
        return self._rng.random(len(ids)) < keep_p

    def _window_slabs(self, ids_all, seq_all, slab: int = 1 << 20,
                      extras=None):
        """The ONE corpus-level randomized-window walk (word2vec.c's
        ``b`` per center): per epoch — subsample, per-token positions,
        effective windows — then ~1M-token slabs, each yielding
        ``(ids, lo, hi, grid, valid)`` where ``grid`` is the clipped
        (slab, 2W) context-position grid and ``valid`` its mask. An
        epoch too short to window yields ``(ids, 0, n, None, None)``
        (token progress only). SGNS flattens the valid cells into
        pairs; CBOW consumes the rows whole — one implementation, one
        anneal-accounting contract.

        ``extras``: optional tuple of per-token corpus-level arrays
        (same length as ``ids_all``) that must ride along through the
        per-epoch subsample filter — e.g. DBOW's per-token label rows.
        When given, each yield grows a sixth element: the tuple of
        ``[lo:hi]`` slab slices of the filtered extras."""
        W = self.window_size
        offsets = np.concatenate([np.arange(-W, 0),
                                  np.arange(1, W + 1)]).astype(np.int32)
        abs_off = np.abs(offsets)[None, :]
        for _epoch in range(self.epochs):
            if self.sampling > 0:
                m = self._subsample_mask(ids_all)
                ids = ids_all[m]
                seq_id = seq_all[m]
                ex = (tuple(e[m] for e in extras)
                      if extras is not None else None)
            else:
                ids, seq_id = ids_all, seq_all
                ex = extras
            n = len(ids)
            if n < 2:
                if extras is not None:
                    yield ids, 0, n, None, None, ex
                else:
                    yield ids, 0, n, None, None
                continue
            pos, length = _corpus_positions(seq_id)
            # randomized effective window per center (word2vec.c's b)
            w_eff = (self._rng.integers(1, W + 1, size=n).astype(np.int32)
                     if W > 1 else np.ones(n, np.int32))
            for lo in range(0, n, slab):
                hi = min(n, lo + slab)
                o = offsets[None, :]
                po = pos[lo:hi, None] + o
                valid = ((abs_off <= w_eff[lo:hi, None])
                         & (po >= 0)
                         & (po < length[lo:hi, None]))
                grid = np.arange(lo, hi, dtype=np.int32)[:, None] + o
                np.clip(grid, 0, n - 1, out=grid)
                if extras is not None:
                    yield (ids, lo, hi, grid, valid,
                           tuple(e[lo:hi] for e in ex))
                else:
                    yield ids, lo, hi, grid, valid

    def _fused_n_neg(self, chunk: int) -> int:
        """Per-pair negative count the FUSED producers draw on their
        counter streams — 0 when the flush-time path owns negatives
        (HS has none; the shared-negatives mode keeps its grouped
        ``_rng`` draws, which turn negative work into batched products)."""
        if self.use_hs or self.negative <= 0:
            return 0
        if getattr(self, "shared_negatives", False) \
                and chunk % sk.SHARED_NEG_GROUP == 0:
            return 0
        return self.negative

    def _fit_fast_sgns(self, seqs, total_words: int):
        """Whole-corpus vectorized skip-gram (negative sampling OR
        hierarchical softmax): ONE vocab-lookup pass flattens the corpus
        (``_encode_corpus_flat``), then pair generation runs as
        corpus-level numpy over an offsets grid in ~1M-token slabs —
        no per-sequence Python (``_window_slabs``). Negatives are one
        table gather per chunk, Huffman paths are gathered on device
        from precomputed matrices; each superchunk is one uploaded,
        in-place scanned device step — the batched version of the reference's
        AggregateSkipGram batching (SkipGram.java:176-186).

        ``pairgen != "legacy"`` swaps the producer for the fused
        subsample+walk+negatives pass (nlp/pairgen.py, native when
        built) — same _PairStream consumer, same anneal accounting."""
        W = self.window_size
        chunk = self._pair_chunk_size(total_words * (W + 1))
        ids_all, seq_all = self._encode_corpus_flat(seqs)

        if self.pairgen != "legacy":
            from deeplearning4j_tpu_torch.nlp import pairgen as pg
            walker = pg.CorpusWalker(
                self, ids_all, seq_all,
                force_numpy=self.pairgen == "numpy")
            n_neg = self._fused_n_neg(chunk)

            def produce(sink):
                stream = _PairStream(self, chunk, total_words,
                                     sink=sink, n_neg=n_neg)
                for ep in range(self.epochs):
                    view = walker.epoch(ep)
                    if view.n < 2:
                        stream.seen += view.n
                        continue
                    pair_base = 0       # NEG streams are per-epoch
                    for lo, hi in view.slab_bounds():
                        c, x, negs = view.walk(lo, hi, n_neg=n_neg,
                                               pair_base=pair_base)
                        pair_base += len(c)
                        stream.push(c, x, tokens=hi - lo, negs=negs)
                stream.finish()
        else:
            def produce(sink):
                stream = _PairStream(self, chunk, total_words, sink=sink)
                for ids, lo, hi, grid, valid in self._window_slabs(
                        ids_all, seq_all):
                    if valid is None:
                        stream.seen += hi - lo
                        continue
                    centers = np.repeat(ids[lo:hi], valid.sum(axis=1))
                    stream.push(centers, ids[grid[valid]],
                                tokens=hi - lo)
                stream.finish()

        if self.overlap_pairgen:
            self._run_overlapped(produce)
        else:
            produce(None)      # _PairStream defaults to inline dispatch
        return self

    def _k(self) -> int:
        return (self._max_code_len if self.use_hs else 1 + self.negative)

    def _lr(self, seen: int, total: int) -> float:
        frac = min(1.0, seen / total)
        return max(self.min_learning_rate,
                   self.learning_rate * (1.0 - frac))

    def _indices(self, seq: Sequence[str]) -> List[int]:
        """Vocab lookup + frequent-word subsampling (word2vec.c style;
        reference applies sampling in SequenceVectors' transformer)."""
        lookup = self.vocab._by_word
        if self.sampling <= 0:
            # one dict-hit comprehension, no per-token method calls
            return [vw.index for vw in map(lookup.get, seq)
                    if vw is not None]
        out = []
        total = max(1, self.vocab.total_word_count)
        for tok in seq:
            vw = lookup.get(tok)
            if vw is None:
                continue
            f = vw.count / total
            keep = (np.sqrt(f / self.sampling) + 1) * self.sampling / f
            if self._rng.random() > keep:
                continue
            out.append(vw.index)
        return out

    def _window_bounds(self, pos: int, n: int) -> Tuple[int, int]:
        """Randomized effective window (word2vec.c's ``b = rng % window``):
        the one shared implementation for SkipGram/CBOW/DM paths."""
        window = self.window_size
        b = int(self._rng.integers(window)) if window > 1 else 0
        return (max(0, pos - (window - b)),
                min(n, pos + (window - b) + 1))

    def _train_sequence(self, idxs: List[int], batcher: sk.PairBatcher,
                        seen: int, total: int) -> int:
        for pos, center in enumerate(idxs):
            lo, hi = self._window_bounds(pos, len(idxs))
            for cpos in range(lo, hi):
                if cpos == pos:
                    continue
                self._add_pair(center, idxs[cpos], batcher, seen, total)
            seen += 1
        return seen

    def _add_pair(self, center: int, context: int, batcher: sk.PairBatcher,
                  seen: int, total: int):
        """SkipGram: center predicts context → (row=center, target=context).
        word2vec.c trains syn0[context] against syn1[center-path]; either
        orientation is symmetric over the corpus."""
        if self.use_hs:
            targets, labels = sk.hs_targets(
                self.vocab.element_at_index(context))
        else:
            targets, labels = sk.negative_sample_targets(
                context, self._table, self.negative, self._rng)
        if batcher.add(center, targets, labels):
            self._flush(batcher, self._lr(seen, total))

    def _flush(self, batcher: sk.PairBatcher, lr: float):
        if batcher.n == 0 and batcher.mask.sum() == 0:
            return
        centers, targets, labels, mask, _n = batcher.take()
        sk.skipgram_step(self.syn0, self.syn1,
                         *self._upload(centers, targets, labels, mask), lr)

    # ---- lookup API (reference: WordVectors interface) -------------------
    @property
    def word_vectors_matrix(self) -> np.ndarray:
        return host_array(self.syn0)

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def get_word_vector(self, word: str) -> np.ndarray:
        idx = self.vocab.index_of(word)
        if idx < 0:
            raise KeyError(word)
        return host_array(self.syn0[idx])

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        na, nb = np.linalg.norm(va), np.linalg.norm(vb)
        if na == 0 or nb == 0:
            return 0.0
        return float(va @ vb / (na * nb))

    def words_nearest(self, word, top_n: int = 10) -> List[str]:
        """Cosine top-k on the device (reference: wordsNearest via
        BasicModelUtils; one matrix-vector product)."""
        if isinstance(word, str):
            v = torch.from_numpy(self.get_word_vector(word))
            exclude = {self.vocab.index_of(word)}
        else:
            v = torch.from_numpy(np.array(word, np.float32))
            exclude = set()
        v = v.to(self.device)
        m = self.syn0 / torch.clamp(
            torch.linalg.vector_norm(self.syn0, dim=1, keepdim=True),
            min=1e-9)
        sims = m @ (v / torch.clamp(torch.linalg.vector_norm(v), min=1e-9))
        order = torch.argsort(-sims, stable=True).cpu().numpy()
        out = []
        for idx in order:
            if int(idx) in exclude:
                continue
            out.append(self.vocab.word_at_index(int(idx)))
            if len(out) >= top_n:
                break
        return out

    def words_nearest_sum(self, positive: List[str], negative: List[str],
                          top_n: int = 10) -> List[str]:
        v = sum(self.get_word_vector(w) for w in positive)
        for w in negative:
            v = v - self.get_word_vector(w)
        out = self.words_nearest(v, top_n + len(positive) + len(negative))
        skip = set(positive) | set(negative)
        return [w for w in out if w not in skip][:top_n]
