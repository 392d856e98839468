"""GloVe: global co-occurrence embeddings.

The port of the JAX package's ``nlp/glove.py`` (reference:
models/glove/, Glove.java + the co-occurrence pipeline, SURVEY §2.7).
Co-occurrence counts are accumulated on the host (the JAX package's
numpy code), then training runs AdaGrad steps over shuffled batches of
(word_i, word_j, log X_ij) triples on the model's device. The triples
are uploaded once per fit and each epoch's permutation once per epoch;
the loss stays on the device and the epoch's sum is read once, in
float64.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import skipgram as sk
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors


@torch.no_grad()
def _glove_step(w, wc, b, bc, gw, gwc, gb, gbc, rows, cols, logx, weight,
                lr):
    """AdaGrad step on J = Σ f(X_ij)(w_i·w̃_j + b_i + b̃_j − log X_ij)²,
    in place on the tables and accumulators; returns the batch loss (a
    device scalar). Duplicate rows of a batch are summed in a fixed order
    (``skipgram._segment_add``), and every accumulator takes all of its
    batch's adds before any update reads it."""
    wi, wj = w[rows], wc[cols]                     # [B, D]
    diff = torch.sum(wi * wj, -1) + b[rows] + bc[cols] - logx   # [B]
    fdiff = weight * diff
    dwi = fdiff[:, None] * wj
    dwj = fdiff[:, None] * wi
    sk._segment_add(gw, rows, dwi * dwi)
    sk._segment_add(gwc, cols, dwj * dwj)
    sk._segment_add(gb, rows, fdiff * fdiff)
    sk._segment_add(gbc, cols, fdiff * fdiff)
    sk._segment_add(w, rows, -lr * dwi / torch.sqrt(gw[rows] + 1e-8))
    sk._segment_add(wc, cols, -lr * dwj / torch.sqrt(gwc[cols] + 1e-8))
    sk._segment_add(b, rows, -lr * fdiff / torch.sqrt(gb[rows] + 1e-8))
    sk._segment_add(bc, cols, -lr * fdiff / torch.sqrt(gbc[cols] + 1e-8))
    return 0.5 * torch.sum(weight * diff * diff)


class Glove(SequenceVectors):
    """reference: Glove.Builder — xMax/alpha weighting, symmetric window
    co-occurrences, AdaGrad."""

    def __init__(self, x_max: float = 100.0, alpha: float = 0.75,
                 symmetric: bool = True, shuffle: bool = True, **kwargs):
        kwargs.setdefault("learning_rate", 0.05)
        super().__init__(**kwargs)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.shuffle = shuffle
        self.last_loss = None
        self.epoch_losses: List[float] = []

    def _cooccurrences(self, seqs: List[List[int]]
                       ) -> Dict[Tuple[int, int], float]:
        """Distance-weighted co-occurrence counts, vectorized: per
        sequence the left-context pairs come from an offsets grid, then
        one np.unique + bincount reduces all (wi, wj, 1/d) triples —
        the per-pair Python loop collapsed to numpy (same counts)."""
        v = max(self.vocab.num_words(), 1)
        offs = np.arange(1, self.window_size + 1)
        # periodic reduction bounds peak memory at O(unique pairs +
        # reduce_every) instead of materializing every windowed pair of
        # the corpus before one global unique
        reduce_every = 2_000_000
        acc_keys = np.empty(0, np.int64)
        acc_wts = np.empty(0, np.float64)
        pend_k: List[np.ndarray] = []
        pend_w: List[np.ndarray] = []
        pending = 0

        def reduce_pending():
            nonlocal acc_keys, acc_wts, pend_k, pend_w, pending
            if not pend_k:
                return
            keys = np.concatenate([acc_keys] + pend_k)
            wts = np.concatenate([acc_wts] + pend_w)
            acc_keys, inv = np.unique(keys, return_inverse=True)
            acc_wts = np.bincount(inv, weights=wts)
            pend_k, pend_w, pending = [], [], 0

        for idxs in seqs:
            idxs = np.asarray(idxs, np.int64)
            n = len(idxs)
            if n < 2:
                continue
            grid = np.arange(n)[:, None] - offs[None, :]
            valid = grid >= 0
            wi = np.repeat(idxs, valid.sum(axis=1))
            wj = idxs[grid[valid]]
            inc = 1.0 / np.broadcast_to(
                offs, valid.shape)[valid].astype(np.float64)
            pend_k.append(wi * v + wj)
            pend_w.append(inc)
            pending += len(wi)
            if self.symmetric:
                pend_k.append(wj * v + wi)
                pend_w.append(inc)
                pending += len(wi)
            if pending >= reduce_every:
                reduce_pending()
        reduce_pending()
        return {(int(k // v), int(k % v)): float(s)
                for k, s in zip(acc_keys, acc_wts)}

    def fit(self, sequences: Iterable[Sequence[str]]):
        # materialize BEFORE type-sniffing, without list()-ing strings —
        # list("cat") is ['c','a','t'] and would build a character vocab
        seqs = list(sequences)
        if seqs and isinstance(seqs[0], str):
            seqs = [s.split() for s in seqs]
        else:
            seqs = [list(s) for s in seqs]
        if self.vocab is None:
            self.build_vocab(seqs)
        idx_seqs = [self._indices(s) for s in seqs]
        co = self._cooccurrences(idx_seqs)
        if not co:
            raise ValueError("empty co-occurrence set")
        rows = np.fromiter((k[0] for k in co), np.int32, len(co))
        cols = np.fromiter((k[1] for k in co), np.int32, len(co))
        xs = np.fromiter(co.values(), np.float32, len(co))
        logx = np.log(xs)
        weight = np.minimum((xs / self.x_max) ** self.alpha, 1.0)

        n, d = self.vocab.num_words(), self.layer_size
        rng = np.random.default_rng(self.seed)
        dev = self.device

        def table(a):
            return torch.tensor(a, device=dev)

        w = table(((rng.random((n, d)) - 0.5) / d).astype(np.float32))
        wc = table(((rng.random((n, d)) - 0.5) / d).astype(np.float32))
        b = torch.zeros(n, dtype=torch.float32, device=dev)
        bc = torch.zeros(n, dtype=torch.float32, device=dev)
        gw = torch.full((n, d), 1e-8, dtype=torch.float32, device=dev)
        gwc = torch.full((n, d), 1e-8, dtype=torch.float32, device=dev)
        gb = torch.full((n,), 1e-8, dtype=torch.float32, device=dev)
        gbc = torch.full((n,), 1e-8, dtype=torch.float32, device=dev)

        bs = self.batch_size
        m = len(rows)
        # the last batch is padded with copies of triple 0 at weight 0
        m_pad = -(-m // bs) * bs
        rows_d, cols_d, logx_d, weight_d = self._upload(
            rows, cols, logx, weight)
        live = torch.arange(m_pad, device=dev) < m
        order = np.arange(m)
        self.epoch_losses = []
        for _ep in range(max(1, self.epochs) * max(1, self.iterations)):
            if self.shuffle:
                rng.shuffle(order)
            (sel_all,) = self._upload(np.concatenate(
                [order, np.zeros(m_pad - m, np.int64)]))
            total = torch.zeros((), dtype=torch.float64, device=dev)
            for s in range(0, m_pad, bs):
                sel = sel_all[s:s + bs]
                loss = _glove_step(
                    w, wc, b, bc, gw, gwc, gb, gbc, rows_d[sel],
                    cols_d[sel], logx_d[sel],
                    torch.where(live[s:s + bs], weight_d[sel], 0.0),
                    self.learning_rate)
                total += loss
            self.last_loss = float(total) / m
            self.epoch_losses.append(self.last_loss)
        # final vectors: w + w̃ (standard GloVe export)
        self.syn0 = w + wc
        self.syn1 = wc
        return self
