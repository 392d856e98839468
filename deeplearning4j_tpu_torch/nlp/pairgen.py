"""Fused host pair generation for the embedding producers.

The port's copy of the JAX package's ``nlp/pairgen.py``: the same
counter streams over the same native library (``utils/native.py``), so
both packages hand their device steps bitwise the same pairs and
negatives for the same seed. The generation engine's counter-mode
sampling keys (``generation/speculative.py:counter_keys``) are built
from ``GOLDEN``, ``M1``, ``M2`` and ``_mix_np``.

The negative draws are the loop the reference keeps native
(SkipGram.java:176, SURVEY §2.14's libnd4j host runtime). This module
makes ONE pass fusing frequent-word subsampling, the randomized window
walk and the negative-table draws (the work
``SequenceVectors._window_slabs`` + ``skipgram.draw_negatives`` did as
separate numpy stages) in ``native/dl4j_native.cpp``, with a
bitwise-identical numpy fallback so the framework works — and trains the
same model — without a toolchain.

PRNG: counter-based splitmix64. Every uniform is ``mix(seed + (k+1) *
GOLDEN)`` for a *counter* k, so there is no sequential generator state
to keep in lockstep between C and numpy — equal (seed, counter) means
equal draw by construction, which is what makes the native/fallback
bitwise-equality contract trivial to hold and to test. Counters are
deterministic functions of corpus position:

- subsample: the token's flat-corpus index
- window ``b``: the kept-token index t
- negatives: ``pair_index * n_neg + slot`` on the primary stream, the
  SAME counter on the redraw stream; a double collision cycles to
  ``(positive + 1) % max(n_words, 2)`` (draw_negatives' policy)

Per-epoch stream seeds are derived host-side (``stream_seed``) and the
final uint64 handed to C, so the two implementations never re-derive
anything independently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.utils import native

GOLDEN = 0x9E3779B97F4A7C15
M1 = 0xBF58476D1CE4E5B9
M2 = 0x94D049BB133111EB
_MASK = (1 << 64) - 1
_U53 = 1.0 / 9007199254740992.0          # 2**-53

# per-epoch stream phases (see stream_seed)
PHASE_SUB, PHASE_WIN, PHASE_NEG, PHASE_NEG2 = 1, 2, 3, 4

# walk slab: smaller than _window_slabs' 1<<20 because the fused path
# also carries an (n_pairs, n_neg) int32 negatives buffer per slab
SLAB = 1 << 17


# ---------------------------------------------------------------------------
# splitmix64, twice: scalar Python (seed derivation) and vectorized
# numpy uint64 (the fallback draw streams — unsigned wraparound matches
# C's modular arithmetic bit for bit).
# ---------------------------------------------------------------------------

def _mix_int(z: int) -> int:
    z &= _MASK
    z ^= z >> 30
    z = (z * M1) & _MASK
    z ^= z >> 27
    z = (z * M2) & _MASK
    z ^= z >> 31
    return z


def stream_seed(base: int, epoch: int, phase: int) -> int:
    """The per-(epoch, phase) stream seed — computed HERE for both
    backends, so C never derives seeds on its own."""
    return _mix_int(_mix_int((base + GOLDEN * (epoch + 1)) & _MASK)
                    ^ ((phase * M2) & _MASK))


def base_seed(model_seed: int) -> int:
    """The fused producer's root seed, split off the model seed so the
    fused streams are independent of the model's ``_rng`` consumption."""
    return _mix_int((model_seed & _MASK) ^ 0x5041495247454E00)  # "PAIRGEN"


def _mix_np(z: np.ndarray) -> np.ndarray:
    z ^= z >> np.uint64(30)
    z *= np.uint64(M1)
    z ^= z >> np.uint64(27)
    z *= np.uint64(M2)
    z ^= z >> np.uint64(31)
    return z


def draws_at(seed: int, k: np.ndarray) -> np.ndarray:
    """Vectorized draw(seed, k) for a uint64 counter array."""
    k = np.asarray(k, np.uint64)  # host-sync-ok: host counter array
    return _mix_np(np.uint64(seed)
                   + (k + np.uint64(1)) * np.uint64(GOLDEN))


def unit(draw: np.ndarray) -> np.ndarray:
    """53-bit uniform in [0,1) — same construction as C's sm_unit."""
    return (draw >> np.uint64(11)).astype(np.float64) * _U53


def range_reduce(draw: np.ndarray, m: int) -> np.ndarray:
    """Draw -> [0, m), m < 2^32: multiply-shift on the top 32 bits —
    C's sm_range, chosen over '%' because a hardware divide per draw
    dominates the native negative-sampling loop. top32 * m < 2^64, so
    plain uint64 arithmetic here is bitwise-identical to C."""
    return ((draw >> np.uint64(32)) * np.uint64(m)) >> np.uint64(32)


def sm64_fill(seed: int, start: int, n: int, *,
              force_numpy: bool = False) -> np.ndarray:
    """Raw draws at counters [start, start+n) — the parity probe."""
    if not force_numpy:
        out = native.sm64_fill(seed, start, n)
        if out is not None:
            return out
    return draws_at(seed, np.arange(start, start + n, dtype=np.uint64))


# ---------------------------------------------------------------------------
# Fused kernels: native when available, numpy fallback bitwise-equal.
# ---------------------------------------------------------------------------

def keep_probs(vocab, sampling: float) -> np.ndarray:
    """Per-word keep probability (word2vec.c's subsampling formula) —
    the per-token ``_subsample_mask`` arithmetic hoisted to one
    per-vocab-word precompute (values > 1 simply always keep)."""
    counts = np.zeros(vocab.num_words(), np.float64)
    for vw in vocab.vocab_words():
        counts[vw.index] = vw.count
    total = max(1, vocab.total_word_count)
    f = counts / total
    return (np.sqrt(f / sampling) + 1) * sampling / np.maximum(f, 1e-300)


def subsample(ids: np.ndarray, keep_p: np.ndarray, seed: int, *,
              force_numpy: bool = False) -> np.ndarray:
    """Boolean keep mask over the flat corpus, counter = token index."""
    if not force_numpy:
        out = native.pairgen_subsample(ids, keep_p, seed)
        if out is not None:
            return out
    u = unit(draws_at(seed, np.arange(len(ids), dtype=np.uint64)))
    return u < keep_p[ids]


def negatives(table: np.ndarray, positive: np.ndarray, n_neg: int,
              n_words: int, nseed: int, n2seed: int, pair_base: int, *,
              force_numpy: bool = False) -> np.ndarray:
    """(n, n_neg) negative draws for pairs [pair_base, pair_base+n)."""
    if not force_numpy:
        out = native.pairgen_negatives(table, positive, n_neg, n_words,
                                       nseed, n2seed, pair_base)
        if out is not None:
            return out
    n = len(positive)
    q = (np.arange(pair_base, pair_base + n, dtype=np.uint64)[:, None]
         * np.uint64(n_neg)
         + np.arange(n_neg, dtype=np.uint64)[None, :])
    tlen = len(table)
    neg = table[range_reduce(draws_at(nseed, q), tlen)
                .astype(np.int64)].astype(np.int32)
    pos = np.ascontiguousarray(positive, np.int32).reshape(-1, 1)
    coll = neg == pos
    if coll.any():
        # redraw ONLY colliding cells, from the second stream at the
        # SAME counter — the property that keeps this vectorizable
        q2 = np.broadcast_to(q, coll.shape)[coll]
        redrawn = table[range_reduce(draws_at(n2seed, q2), tlen)
                        .astype(np.int64)]
        neg[coll] = redrawn.astype(np.int32)
        cyc = max(n_words, 2)
        neg = np.where(neg == pos,
                       ((pos + 1) % cyc).astype(np.int32), neg)
    return neg


def _window_geometry(pos: np.ndarray, length: np.ndarray, lo: int,
                     hi: int, window: int, wseed: int,
                     n_total: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (slab, 2W) clipped context grid and validity mask — the same
    offsets-grid construction _window_slabs used, with ``b`` from the
    WIN counter stream instead of the model rng."""
    t = np.arange(lo, hi, dtype=np.int64)
    if window > 1:
        b = (np.uint64(1)
             + range_reduce(draws_at(wseed, t.astype(np.uint64)),
                            window)).astype(np.int32)
    else:
        b = np.ones(hi - lo, np.int32)
    offsets = np.concatenate([np.arange(-window, 0),
                              np.arange(1, window + 1)]).astype(np.int32)
    po = pos[lo:hi, None] + offsets[None, :]
    valid = ((np.abs(offsets)[None, :] <= b[:, None])
             & (po >= 0) & (po < length[lo:hi, None]))
    grid = t[:, None] + offsets[None, :]
    np.clip(grid, 0, n_total - 1, out=grid)
    return grid, valid


def walk(ids: np.ndarray, pos: np.ndarray, length: np.ndarray, lo: int,
         hi: int, window: int, wseed: int, *,
         table: Optional[np.ndarray] = None, n_neg: int = 0,
         n_words: int = 0, nseed: int = 0, n2seed: int = 0,
         pair_base: int = 0, force_numpy: bool = False
         ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The fused SGNS/HS/DBOW window walk over kept-token slab [lo, hi):
    returns (centers, contexts, negs) with negs None when n_neg == 0.
    Pair order is ascending offset per center — identical to the numpy
    offsets-grid flatten. ``pair_base`` is the epoch-global pair counter
    feeding the NEG streams."""
    cap = (hi - lo) * 2 * window
    if not force_numpy and native.pairgen_available():
        out_c = np.empty(cap, np.int32)
        out_x = np.empty(cap, np.int32)
        out_n = np.empty((cap, n_neg), np.int32) if n_neg > 0 else None
        got = native.pairgen_walk(ids, pos, length, lo, hi, window,
                                  wseed, table, n_neg, n_words, nseed,
                                  n2seed, pair_base, out_c, out_x, out_n)
        if got is not None:
            return (out_c[:got], out_x[:got],
                    out_n[:got] if out_n is not None else None)
    grid, valid = _window_geometry(pos, length, lo, hi, window, wseed,
                                   len(ids))
    centers = np.repeat(ids[lo:hi], valid.sum(axis=1))
    contexts = ids[grid[valid]]
    negs = None
    if n_neg > 0:
        negs = negatives(table, contexts, n_neg, n_words, nseed, n2seed,
                         pair_base, force_numpy=True)
    return centers, contexts, negs


def walk_cbow(ids: np.ndarray, pos: np.ndarray, length: np.ndarray,
              lo: int, hi: int, window: int, wseed: int, *,
              table: Optional[np.ndarray] = None, n_neg: int = 0,
              n_words: int = 0, nseed: int = 0, n2seed: int = 0,
              row_base: int = 0, force_numpy: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                         Optional[np.ndarray]]:
    """The fused CBOW row walk: returns (ctx, cmask, centers, negs) for
    the centers in [lo, hi) that have >= 1 valid context. ``row_base``
    is the epoch-global EMITTED-row counter (skipped centers do not
    advance it)."""
    cw = 2 * window
    if not force_numpy and native.pairgen_available():
        cap = hi - lo
        out_ctx = np.empty((cap, cw), np.int32)
        out_m = np.empty((cap, cw), np.float32)
        out_c = np.empty(cap, np.int32)
        out_n = np.empty((cap, n_neg), np.int32) if n_neg > 0 else None
        got = native.pairgen_walk_cbow(ids, pos, length, lo, hi, window,
                                       wseed, table, n_neg, n_words,
                                       nseed, n2seed, row_base, out_ctx,
                                       out_m, out_c, out_n)
        if got is not None:
            return (out_ctx[:got], out_m[:got], out_c[:got],
                    out_n[:got] if out_n is not None else None)
    grid, valid = _window_geometry(pos, length, lo, hi, window, wseed,
                                   len(ids))
    keep = valid.any(axis=1)
    ctx = ids[grid][keep]
    cmask = valid[keep].astype(np.float32)
    centers = ids[lo:hi][keep]
    negs = None
    if n_neg > 0:
        negs = negatives(table, centers, n_neg, n_words, nseed, n2seed,
                         row_base, force_numpy=True)
    return ctx, cmask, centers, negs


# ---------------------------------------------------------------------------
# The model-facing walker: per-fit precompute + per-epoch subsampled
# views, mirroring _window_slabs' anneal-accounting contract.
# ---------------------------------------------------------------------------

def _positions(seq_id: np.ndarray):
    # deferred: sequence_vectors imports this module lazily inside its
    # fused producers, so a top-level import here would be circular
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import _corpus_positions
    return _corpus_positions(seq_id)


class EpochView:
    """One epoch's kept corpus: ids/pos/length after the SUB-stream
    subsample, plus the epoch's WIN/NEG/NEG2 stream seeds. ``n < 2``
    means the epoch is too short to window (producers advance their
    token accounting and move on, like _window_slabs' degenerate
    yield)."""

    def __init__(self, walker: "CorpusWalker", epoch: int):
        w = self.walker = walker
        self.wseed = stream_seed(w.base, epoch, PHASE_WIN)
        self.nseed = stream_seed(w.base, epoch, PHASE_NEG)
        self.n2seed = stream_seed(w.base, epoch, PHASE_NEG2)
        if w.keep_p is not None:
            m = subsample(w.ids_all, w.keep_p,
                          stream_seed(w.base, epoch, PHASE_SUB),
                          force_numpy=w.force_numpy)
            self.ids = w.ids_all[m]
            seq_id = w.seq_all[m]
            self.extras = (tuple(e[m] for e in w.extras)
                           if w.extras is not None else None)
        else:
            self.ids, seq_id = w.ids_all, w.seq_all
            self.extras = w.extras
        self.n = len(self.ids)
        if self.n >= 2:
            self.pos, self.length = _positions(seq_id)
        else:
            self.pos = self.length = None

    def slab_bounds(self):
        for lo in range(0, self.n, self.walker.slab):
            yield lo, min(self.n, lo + self.walker.slab)

    def walk(self, lo: int, hi: int, *, n_neg: int = 0,
             pair_base: int = 0):
        w = self.walker
        out = walk(self.ids, self.pos, self.length, lo, hi, w.window,
                   self.wseed, table=w.table, n_neg=n_neg,
                   n_words=w.n_words, nseed=self.nseed,
                   n2seed=self.n2seed, pair_base=pair_base,
                   force_numpy=w.force_numpy)
        w._count(hi - lo, len(out[0]))
        return out

    def walk_cbow(self, lo: int, hi: int, *, n_neg: int = 0,
                  row_base: int = 0):
        w = self.walker
        out = walk_cbow(self.ids, self.pos, self.length, lo, hi,
                        w.window, self.wseed, table=w.table,
                        n_neg=n_neg, n_words=w.n_words,
                        nseed=self.nseed, n2seed=self.n2seed,
                        row_base=row_base, force_numpy=w.force_numpy)
        w._count(hi - lo, len(out[2]))
        return out

    def negatives(self, positive: np.ndarray, n_neg: int,
                  pair_base: int) -> np.ndarray:
        """NEG-stream draws for producer-shaped pairs outside the walk
        (DBOW's label rows), sharing the epoch's global pair counter."""
        w = self.walker
        return negatives(w.table, positive, n_neg, w.n_words,
                         self.nseed, self.n2seed, pair_base,
                         force_numpy=w.force_numpy)


class CorpusWalker:
    """Per-fit fused pair generator. Owns the precompute (keep
    probabilities, int32 unigram table, stream base seed) and hands out
    per-epoch ``EpochView``s; the mode-specific producers in nlp/ drive
    the slab loop and feed _PairStream. ``force_numpy=True`` pins the
    bitwise-identical fallback (the ``pairgen="numpy"`` knob and the
    A/B bench's reference arm)."""

    def __init__(self, model, ids_all: np.ndarray, seq_all: np.ndarray,
                 *, extras=None, slab: int = SLAB,
                 force_numpy: bool = False):
        self.ids_all = np.ascontiguousarray(ids_all, np.int32)
        self.seq_all = seq_all
        self.extras = extras
        self.slab = slab
        self.force_numpy = force_numpy or not native.pairgen_available()
        self.window = model.window_size
        self.n_words = model.vocab.num_words()
        self.base = base_seed(model.seed)
        self.keep_p = (keep_probs(model.vocab, model.sampling)
                       if model.sampling > 0 else None)
        tbl = getattr(model, "_table", None)
        self.table = (np.ascontiguousarray(tbl, np.int32)
                      if tbl is not None else None)
        from deeplearning4j_tpu_torch.observe.registry import default_registry
        reg = default_registry()
        self._c_tokens = reg.counter(
            "dl4j_pairgen_tokens_total",
            "corpus tokens walked by the fused pair generator")
        self._c_pairs = reg.counter(
            "dl4j_pairgen_pairs_total",
            "(center, context) pairs / CBOW rows emitted by the fused "
            "pair generator")
        self._path = "numpy" if self.force_numpy else "native"

    def _count(self, tokens: int, pairs: int):
        # telemetry counts are plain host ints
        self._c_tokens.inc(float(tokens),  # host-sync-ok: host int
                           path=self._path)
        self._c_pairs.inc(float(pairs),  # host-sync-ok: host int
                          path=self._path)

    def epoch(self, epoch: int) -> EpochView:
        return EpochView(self, epoch)
