"""Batched SkipGram / CBOW device steps in PyTorch.

The port of the JAX package's ``nlp/skipgram.py`` (reference: the native
aggregate ops ``AggregateSkipGram`` / ``AggregateCBOW``,
models/embeddings/learning/impl/elements/SkipGram.java:176,271). The JAX
package leaves these steps to XLA, so here they are plain PyTorch: one
batch gathers the center rows of ``syn0`` and the target rows (negative
samples or Huffman inner nodes) of ``syn1``, computes every pair's
sigmoid gradient at once, and scatters the updates back. The tables are
updated in place (the JAX package donates them).

The math (per pair, label y ∈ {0,1}, lr α):
    g = (y − σ(syn0[c]·syn1[t])) · α
    syn1[t] += g · syn0[c]
    syn0[c] += g · syn1[t]        (pre-update value, as in word2vec.c)

Duplicate rows of a batch are summed, and each row's TOTAL update is
norm-clipped at ``_CLIP_COEF·lr·sqrt(D)`` (``_clipped_scatter``; the JAX
package's module docstring says why: k duplicate updates computed from
the same pre-update row overshoot where word2vec.c's sequential updates
would saturate). Every step keeps static shapes and never reads a value
back to the host, so a superchunk's steps queue on the card without a
sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Divergence-guard clip, scaled with lr and layer size (the JAX
# package's _CLIP_COEF).
_CLIP_COEF = 4.0


def _max_row_norm(lr, d: int):
    return _CLIP_COEF * lr * float(np.sqrt(np.float32(d)))


_SCAN_BLOCK = 256


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of ``x`` (b, D) along dim 0, by blocks: a
    running sum within blocks of ``_SCAN_BLOCK`` rows (one thread a
    column of a block on the card), then the blocks' totals. A fixed
    order, so the same bits on every run, and parallel where a single
    running sum down 2M rows would run one thread a column."""
    b = x.shape[0]
    nblk = -(-b // _SCAN_BLOCK)
    xp = x.new_zeros((nblk * _SCAN_BLOCK,) + tuple(x.shape[1:]))
    xp[:b] = x
    within = torch.cumsum(xp.view((nblk, _SCAN_BLOCK) + tuple(x.shape[1:])),
                          dim=1)
    tot = within[:, -1]
    before = torch.cumsum(tot, dim=0) - tot
    return (within + before[:, None]).view(xp.shape)[:b]


def _segment_totals(idx: torch.Tensor, upd: torch.Tensor):
    """(sorted idx, every element's segment total). A stable sort puts a
    row's duplicates next to each other in their batch order; a segment's
    total is the difference of a float64 running sum at its ends (the
    JAX package's construction, which takes it in float32 and so loses
    the low bits of a small row's total next to large ones: GloVe's
    AdaGrad accumulators start at 1e-8, and a frequent word's thousands
    of duplicates are the largest part of a full-width superchunk's
    rounding noise; ``tools/emb_noise.py`` measures it). Segment bounds
    come from scatters to unique slots past the batch (a dump area), so
    every step is static in shape, free of atomics and host syncs, and
    the same on every run."""
    b = idx.shape[0]
    dev = idx.device
    order = torch.argsort(idx, stable=True)
    sid = idx[order]
    pos = torch.arange(b, device=dev)
    change = sid[1:] != sid[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, change])
    last = torch.cat([change, one])
    seg = torch.cumsum(first, 0) - 1                 # segment of each row
    bounds = torch.empty((2, 2 * b), dtype=torch.long, device=dev)
    bounds[0].index_put_((torch.where(first, seg, b + pos),), pos)
    bounds[1].index_put_((torch.where(last, seg, b + pos),), pos)
    start, end = bounds[0][seg], bounds[1][seg]
    cs = _running_sum(upd[order].to(torch.float64))
    lead = (start > 0).view((b,) + (1,) * (upd.dim() - 1))
    lo = torch.where(lead, cs[torch.clamp(start - 1, min=0)], 0.0)
    return sid, cs[end] - lo


def _write_rows(table: torch.Tensor, sid: torch.Tensor,
                step: torch.Tensor):
    """table[row] += step, written by every element of the row's segment:
    the elements of a segment carry the same total, so each writes the
    same bits and the result does not depend on which duplicate write of
    ``index_put_`` lands last. No dump rows past the table and no copy
    of it."""
    table.index_put_((sid,), table[sid] + step.to(table.dtype))


def _clipped_scatter(table: torch.Tensor, idx: torch.Tensor,
                     upd: torch.Tensor, max_norm) -> torch.Tensor:
    """table[idx] += upd in place, each destination row receiving its
    TOTAL update from the batch, norm-clipped at ``max_norm``: one add
    per live row, summed in a fixed order, with no dense [V, D]
    temporary (the cost scales with the batch, not the vocabulary)."""
    sid, total = _segment_totals(idx, upd)
    norm = torch.linalg.vector_norm(total, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    _write_rows(table, sid, total * scale)
    return table


def _segment_add(table: torch.Tensor, idx: torch.Tensor,
                 upd: torch.Tensor) -> torch.Tensor:
    """table[idx] += upd in place with duplicates summed in a fixed order
    before the one add per row (GloVe's AdaGrad accumulators and rows)."""
    sid, total = _segment_totals(idx, upd)
    _write_rows(table, sid, total)
    return table


@torch.no_grad()
def skipgram_step(syn0: torch.Tensor, syn1: torch.Tensor,
                  centers: torch.Tensor,      # [B] int
                  targets: torch.Tensor,      # [B, K] int
                  labels: torch.Tensor,       # [B, K] f32 (1=pos, 0=neg)
                  mask: torch.Tensor,         # [B, K] f32
                  lr) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched SkipGram update (negative sampling or hierarchical
    softmax: the same math, different targets and labels)."""
    h = syn0[centers]                                  # [B, D]
    w = syn1[targets]                                  # [B, K, D]
    logits = torch.einsum("bd,bkd->bk", h, w)
    g = (labels - torch.sigmoid(logits)) * mask * lr   # [B, K]
    dh = torch.einsum("bk,bkd->bd", g, w)
    dw = g[..., None] * h[:, None, :]
    d = syn0.shape[1]
    mr = _max_row_norm(lr, d)
    _clipped_scatter(syn1, targets.reshape(-1), dw.reshape(-1, d), mr)
    _clipped_scatter(syn0, centers, dh, mr)
    return syn0, syn1



def skipgram_hs_step(syn0, syn1, centers, contexts, points_mat, labels_mat,
                     hs_mask, row_valid, lr):
    """Hierarchical-softmax SkipGram with the Huffman-path gathers done on
    the device from per-word matrices (the host ships index pairs)."""
    mask = hs_mask[contexts] * row_valid[:, None]
    return skipgram_step(syn0, syn1, centers, points_mat[contexts],
                         labels_mat[contexts], mask, lr)


def build_hs_matrices(vocab_words, max_len: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points, labels=1-codes, mask) matrices padded to ``max_len`` for
    the device-side HS gather (rows indexed by word index)."""
    v = len(vocab_words)
    points = np.zeros((v, max_len), np.int32)
    labels = np.zeros((v, max_len), np.float32)
    mask = np.zeros((v, max_len), np.float32)
    for i, vw in enumerate(vocab_words):
        n = min(len(vw.points), max_len)
        points[i, :n] = vw.points[:n]
        labels[i, :n] = 1.0 - np.asarray(vw.codes[:n], np.float32)
        mask[i, :n] = 1.0
    return points, labels, mask


@torch.no_grad()
def cbow_step(syn0: torch.Tensor, syn1: torch.Tensor,
              context: torch.Tensor,       # [B, W] int context rows
              context_mask: torch.Tensor,  # [B, W] f32
              targets: torch.Tensor,       # [B, K] int
              labels: torch.Tensor,        # [B, K] f32
              mask: torch.Tensor,          # [B, K] f32
              lr) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched CBOW update: h = mean of the context rows; the syn0
    gradient goes back to every context word (reference: CBOW.java)."""
    cvecs = syn0[context]                                   # [B, W, D]
    denom = torch.clamp(context_mask.sum(-1, keepdim=True), min=1.0)
    h = (cvecs * context_mask[..., None]).sum(1) / denom    # [B, D]
    w = syn1[targets]
    logits = torch.einsum("bd,bkd->bk", h, w)
    g = (labels - torch.sigmoid(logits)) * mask * lr
    dh = torch.einsum("bk,bkd->bd", g, w) / denom
    dw = g[..., None] * h[:, None, :]
    d = syn0.shape[1]
    mr = _max_row_norm(lr, d)
    _clipped_scatter(syn1, targets.reshape(-1), dw.reshape(-1, d), mr)
    dctx = (dh[:, None, :] * context_mask[..., None]).reshape(-1, d)
    _clipped_scatter(syn0, context.reshape(-1), dctx, mr)
    return syn0, syn1



def cbow_hs_step(syn0, syn1, context, context_mask, centers, points_mat,
                 labels_mat, hs_mask, row_valid, lr):
    """Hierarchical-softmax CBOW with the Huffman-path gather on the
    device (the host ships context ids and center ids)."""
    mask = hs_mask[centers] * row_valid[:, None]
    return cbow_step(syn0, syn1, context, context_mask, points_mat[centers],
                     labels_mat[centers], mask, lr)


# ---- scanned multi-chunk steps -------------------------------------------
# A superchunk of D chunks is applied in order, each with its own lr and
# valid-row count (the JAX package's lax.scan); the loop queues every
# chunk's ops without reading anything back.

def _row_mask(b: int, k: int, nv: torch.Tensor) -> torch.Tensor:
    """(B, K) float mask of rows below the chunk's valid count."""
    rows = torch.arange(b, device=nv.device)[:, None] < nv
    return rows.to(torch.float32).expand(b, k)


def _pos_labels(b: int, k: int, device) -> torch.Tensor:
    labels = torch.zeros((b, k), dtype=torch.float32, device=device)
    labels[:, 0] = 1.0
    return labels


def skipgram_scan_step(syn0, syn1,
                       centers,   # [D, B] int
                       targets,   # [D, B, K] int (col 0 = positive)
                       n_valid,   # [D] int
                       lrs):      # [D] f32
    b, k = targets.shape[1], targets.shape[2]
    labels = _pos_labels(b, k, syn0.device)
    for i in range(centers.shape[0]):
        skipgram_step(syn0, syn1, centers[i], targets[i], labels,
                      _row_mask(b, k, n_valid[i]), lrs[i])
    return syn0, syn1


def skipgram_hs_scan_step(syn0, syn1,
                          centers,     # [D, B] int
                          contexts,    # [D, B] int
                          points_mat, labels_mat, hs_mask,
                          n_valid, lrs):
    b = centers.shape[1]
    k = points_mat.shape[1]
    for i in range(centers.shape[0]):
        ctx = contexts[i]
        mask = hs_mask[ctx] * _row_mask(b, k, n_valid[i])
        skipgram_step(syn0, syn1, centers[i], points_mat[ctx],
                      labels_mat[ctx], mask, lrs[i])
    return syn0, syn1


def cbow_scan_step(syn0, syn1,
                   context,       # [D, B, W] int
                   context_mask,  # [D, B, W] f32
                   targets,       # [D, B, K] int (col 0 = positive)
                   n_valid, lrs):
    b, k = targets.shape[1], targets.shape[2]
    labels = _pos_labels(b, k, syn0.device)
    for i in range(context.shape[0]):
        cbow_step(syn0, syn1, context[i], context_mask[i], targets[i],
                  labels, _row_mask(b, k, n_valid[i]), lrs[i])
    return syn0, syn1


def cbow_hs_scan_step(syn0, syn1,
                      context,       # [D, B, W] int
                      context_mask,  # [D, B, W] f32
                      centers,       # [D, B] int
                      points_mat, labels_mat, hs_mask,
                      n_valid, lrs):
    b = centers.shape[1]
    k = points_mat.shape[1]
    for i in range(context.shape[0]):
        cen = centers[i]
        mask = hs_mask[cen] * _row_mask(b, k, n_valid[i])
        cbow_step(syn0, syn1, context[i], context_mask[i], points_mat[cen],
                  labels_mat[cen], mask, lrs[i])
    return syn0, syn1


# ---- pair generation on the device ----------------------------------------

def token_draws(tokens_shape, table: torch.Tensor, *, window: int,
                n_neg: int, generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random half of ``skipgram_token_step``: each center's effective
    window ``b`` in [1, window] (word2vec.c's ``b``) and ``n_neg``
    unigram-table negatives per pair slot, drawn by ``generator`` on the
    table's device. (The JAX package draws with ``jax.random``; the two
    streams differ, so the update is tested on the JAX package's draws.)"""
    s, l = tokens_shape
    dev = table.device
    b = torch.randint(1, window + 1, (s, l), generator=generator,
                      device=dev)
    draw = torch.randint(0, table.shape[0], (s * l * 2 * window, n_neg),
                         generator=generator, device=dev)
    return b, table[draw]


@torch.no_grad()
def skipgram_token_update(syn0: torch.Tensor, syn1: torch.Tensor,
                          tokens: torch.Tensor,    # (S, L) int, padded
                          lengths: torch.Tensor,   # (S,) int valid lengths
                          b: torch.Tensor,         # (S, L) windows
                          negs: torch.Tensor,      # (S·L·2W, n_neg) int
                          lr, *, window: int, n_neg: int):
    """SGNS over raw token-id sentences, given the draws: the (center,
    context) grid, the collision cycling of the negatives and the update
    (``skipgram_step``). The host ships only padded int32 sentences."""
    s, l = tokens.shape
    dev = tokens.device
    pos = torch.arange(l, device=dev)
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])   # (2W,)
    grid = (pos[None, :, None] + offs[None, None, :]).expand(
        s, l, 2 * window)
    lens = lengths[:, None, None]
    valid = ((offs.abs()[None, None, :] <= b[..., None])
             & (grid >= 0) & (grid < lens) & (pos[None, :, None] < lens))
    centers = tokens[:, :, None].expand(valid.shape).reshape(-1)
    ctx_idx = torch.clamp(grid, 0, l - 1)
    contexts = torch.gather(tokens, 1,
                            ctx_idx.reshape(s, -1)).reshape(-1)
    mask_row = valid.reshape(-1).to(torch.float32)
    p = centers.shape[0]
    # a negative colliding with the positive would train the same target
    # toward both labels: cycle it (word2vec.c skips; same effect)
    vmax = max(syn1.shape[0], 2)
    negs = torch.where(negs == contexts[:, None], (negs + 1) % vmax, negs)
    targets = torch.cat([contexts[:, None], negs.to(contexts.dtype)], 1)
    labels = _pos_labels(p, 1 + n_neg, dev)
    mask = mask_row[:, None].expand(p, 1 + n_neg)
    return skipgram_step(syn0, syn1, centers, targets, labels, mask, lr)


@torch.no_grad()
def infer_step(docvec: torch.Tensor,        # [D] the one trainable vector
               syn1: torch.Tensor,          # frozen
               targets: torch.Tensor,       # [P, K]
               labels: torch.Tensor,
               mask: torch.Tensor,
               lr) -> torch.Tensor:
    """ParagraphVectors.inferVector's inner step, in place on ``docvec``:
    one new doc vector trained against a frozen syn1. The whole P·K pair
    sum lands on one row computed from the same pre-update vector, so it
    is clipped like ``_clipped_scatter``'s totals."""
    w = syn1[targets]                                   # [P, K, D]
    logits = torch.einsum("d,pkd->pk", docvec, w)
    g = (labels - torch.sigmoid(logits)) * mask * lr
    upd = torch.einsum("pk,pkd->d", g, w).to(torch.float32)
    norm = torch.clamp(torch.linalg.vector_norm(upd), min=1e-12)
    upd = upd * torch.clamp(_max_row_norm(lr, docvec.shape[0]) / norm,
                            max=1.0)
    docvec.add_(upd.to(docvec.dtype))
    return docvec


class PairBatcher:
    """Host-side accumulator of (center, targets, labels) rows, flushed to
    the device step when full (reference: SkipGram.java:176-186)."""

    def __init__(self, batch_size: int, k: int):
        self.batch_size = batch_size
        self.k = k
        self.centers = np.zeros(batch_size, np.int32)
        self.targets = np.zeros((batch_size, k), np.int32)
        self.labels = np.zeros((batch_size, k), np.float32)
        self.mask = np.zeros((batch_size, k), np.float32)
        self.n = 0

    def add(self, center: int, targets: np.ndarray, labels: np.ndarray):
        i = self.n
        kk = min(len(targets), self.k)
        self.centers[i] = center
        self.targets[i, :kk] = targets[:kk]
        self.labels[i, :kk] = labels[:kk]
        self.mask[i, :kk] = 1.0
        if kk < self.k:
            self.targets[i, kk:] = 0
            self.labels[i, kk:] = 0.0
            self.mask[i, kk:] = 0.0
        self.n += 1
        return self.n >= self.batch_size

    def take(self):
        out = (self.centers.copy(), self.targets.copy(),
               self.labels.copy(), self.mask.copy(), self.n)
        # zero masks beyond fill point so a partial flush is inert
        if self.n < self.batch_size:
            out[3][self.n:] = 0.0
        self.n = 0
        self.mask[:] = 0.0
        return out


def draw_negatives(rng: np.random.Generator, table: np.ndarray,
                   pos: np.ndarray, n_neg: int,
                   n_words: int) -> np.ndarray:
    """(n, n_neg) negatives from the unigram^0.75 table for positive
    column ``pos`` (n, 1): collisions with the positive are redrawn
    once, then cycled to (pos+1) mod vocab."""
    n = pos.shape[0]
    negs = table[rng.integers(0, len(table), (n, n_neg),
                              dtype=np.uint32)]
    bad = np.nonzero(negs == pos)
    if bad[0].size:
        redraw = table[rng.integers(0, len(table), bad[0].size)]
        pb = pos[bad[0], 0]
        still = redraw == pb
        redraw[still] = (pb[still] + 1) % max(n_words, 2)
        negs[bad] = redraw
    return negs


def window_grid(n: int, window: int, rng: np.random.Generator
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Randomized-effective-window offsets grid (word2vec.c's ``b``):
    (grid positions (n, 2W), validity mask (n, 2W))."""
    offsets = np.concatenate([np.arange(-window, 0),
                              np.arange(1, window + 1)])
    eff = (rng.integers(1, window + 1, n) if window > 1
           else np.ones(n, np.int64))
    grid = np.arange(n)[:, None] + offsets[None, :]
    valid = ((np.abs(offsets)[None, :] <= eff[:, None])
             & (grid >= 0) & (grid < n))
    return grid, valid


def negative_sample_targets(pos: int, table: np.ndarray, n_neg: int,
                            rng: np.random.Generator
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """1 positive + n_neg negatives drawn from the unigram^0.75 table;
    negatives colliding with the positive are redrawn, then cycled."""
    negs = table[rng.integers(0, len(table), n_neg)]
    for _ in range(4):
        bad = negs == pos
        if not bad.any():
            break
        negs[bad] = table[rng.integers(0, len(table), int(bad.sum()))]
    if (negs == pos).any():  # tiny vocab: fall back to cycling indices
        n_words = int(table.max()) + 1
        negs[negs == pos] = (pos + 1) % max(n_words, 2)
    targets = np.concatenate(([pos], negs)).astype(np.int32)
    labels = np.zeros(1 + n_neg, np.float32)
    labels[0] = 1.0
    return targets, labels


def hs_targets(vw, max_len: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Hierarchical-softmax targets: Huffman inner nodes with label
    1−code (word2vec convention)."""
    points = np.asarray(vw.points, np.int32)
    labels = 1.0 - np.asarray(vw.codes, np.float32)
    if max_len is not None:
        points, labels = points[:max_len], labels[:max_len]
    return points, labels


# ---------------------------------------------------------------------------
# shared-negative-sample SkipGram (the Word2Vec SGNS default)
# ---------------------------------------------------------------------------

SHARED_NEG_GROUP = 512


@torch.no_grad()
def _sg_update_shared(syn0, syn1,
                      centers,     # [B] int
                      contexts,    # [B] int
                      negs,        # [G, NEG] int, B % G == 0
                      nv,          # scalar valid rows
                      lr):
    """SkipGram with one negative set shared by each group of ``B/G``
    consecutive pairs: the negative work becomes three batched products
    over [G, group, D] blocks, and only the positive context and center
    rows are gathered and scattered per pair (the JAX package's
    ``_sg_update_shared`` says why). Negatives are drawn without
    excluding each pair's positive."""
    b = centers.shape[0]
    d = syn0.shape[1]
    g, n_neg = negs.shape
    group = b // g
    valid = (torch.arange(b, device=syn0.device) < nv).to(torch.float32)
    h = syn0[centers]                                  # [B, D]
    wt = syn1[contexts]                                # [B, D]
    lp = torch.sum(h * wt, dim=-1)
    gp = (1.0 - torch.sigmoid(lp)) * valid * lr        # [B]
    dh = gp[:, None] * wt
    dwt = gp[:, None] * h
    wn = syn1[negs.reshape(-1)].reshape(g, n_neg, d)   # [G, NEG, D]
    hg = h.reshape(g, group, d)
    ln = torch.bmm(hg, wn.transpose(1, 2))             # [G, group, NEG]
    gn = (-torch.sigmoid(ln)) * valid.reshape(g, group, 1) * lr
    dh = dh + torch.bmm(gn, wn).reshape(b, d)
    dwn = torch.bmm(gn.transpose(1, 2), hg)            # [G, NEG, D]
    mr = _max_row_norm(lr, d)
    _clipped_scatter(syn1, contexts, dwt, mr)
    _clipped_scatter(syn1, negs.reshape(-1), dwn.reshape(-1, d), mr)
    _clipped_scatter(syn0, centers, dh, mr)
    return syn0, syn1


def skipgram_scan_step_shared(syn0, syn1,
                              centers,   # [D, B] int
                              contexts,  # [D, B] int
                              negs,      # [D, G, NEG] int
                              n_valid,   # [D] int
                              lrs):      # [D] f32
    for i in range(centers.shape[0]):
        _sg_update_shared(syn0, syn1, centers[i], contexts[i], negs[i],
                          n_valid[i], lrs[i])
    return syn0, syn1
