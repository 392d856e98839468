"""Distance + top-k over one corpus shard.

The port of the JAX package's ``retrieval/kernels.py``. There each
function is jitted XLA, a distance matmul in the expanded-quadratic form
(``d² = |q|² - 2·q·cᵀ + |c|²``) followed by ``lax.top_k``, and reaches no
Pallas kernel; here each is the same arithmetic in plain torch on the
tensors' device, so the only device→host transfer per (query batch,
shard) is k ids + k distances.

Precision arms:

- **f32** — exact squared-L2 over the float corpus.
- **int8** — the corpus shard is per-row symmetric int8; the query batch
  is quantized per row on the device (``torch.round`` half-to-even, as
  ``jnp.round``), and the int8 x int8 cross term is the exact int32
  accumulator of ``ops/quantize._int_matmul`` (the integer operands in
  f32 chunks of at most ``INT8_EXACT_K``, each exact, added in int32),
  dequantized by ``q_scale[b]·row_scale[n]``.

IVF arms route through k-means centroids: the ``nprobe`` nearest
clusters per query, then a running top-k carry over the probes in the
JAX order — the carry first, then the probes in rank order, each
cluster's rows in their layout order. Probes are taken a few at a time
(``_PROBE_CHUNK_BYTES``); since the carry is kept sorted by the same total
order (distance, then carry, probe and row position), the chunked
merge returns the JAX scan's answer. Padded rows carry ``+inf``
distance and id -1 and never enter the top-k ahead of a real row.

Ties: ``lax.top_k`` returns the lower position first among equal values;
``torch.topk``'s order among ties is unspecified. :func:`topk_smallest`
therefore selects on a 64-bit key, the distance's order-preserving
integer image in the high half and the position in the low half, so
every key is distinct and the order is the JAX one on any device.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.quantize import (INT8_EXACT_K, Q_MAX,
                                                   _int_matmul)

# the gathered [B, P, M, D] block of one probe chunk stays under this
_PROBE_CHUNK_BYTES = 1 << 28


def topk_smallest(d2: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row of f32 ``d2`` [B, R],
    ascending, the lower position first among equal values (the order
    of ``lax.top_k(-d2, k)``). Returns ``(values [B, k], positions
    [B, k] int64)``."""
    d2 = d2 + 0.0                       # -0.0 -> +0.0: equal values tie
    bits = d2.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int64)
    _, idx = torch.topk(key * (1 << 32) + pos, k, dim=1, largest=False,
                        sorted=True)
    return torch.gather(d2, 1, idx), idx


def _quantize_queries(q: torch.Tensor):
    """Per-row symmetric int8 quantization of the query batch:
    scale[b] = absmax(q[b])/127 (dead rows scale 1). Returns
    ``(q_int8 [B, D], scales f32 [B, 1])``."""
    amax = torch.amax(torch.abs(q), dim=1, keepdim=True)      # [B, 1]
    scale = torch.where(amax > 0, amax, float(Q_MAX)) / float(Q_MAX)
    qq = torch.clamp(torch.round(q / scale), -Q_MAX, Q_MAX)
    return qq.to(torch.int8), scale


def brute_topk_f32(q, corpus, c2, ids, k: int):
    """Exact brute force: ``q`` [B, D] f32 against one f32 shard [R, D]
    with precomputed row norms ``c2`` [R] (``+inf`` on padding rows) and
    global ids ``ids`` [R] int32 (-1 on padding). Returns (distances
    [B, k] f32 ascending, global ids [B, k] int32)."""
    q2 = torch.sum(q * q, dim=1, keepdim=True)               # [B, 1]
    d2 = q2 - 2.0 * (q @ corpus.T) + c2[None, :]             # [B, R]
    d, pos = topk_smallest(d2, k)
    return d, ids[pos]


def brute_topk_int8(q, corpus_q, row_scales, c2, ids, k: int):
    """Int8 brute force: the exact int32 cross term, dequant-rescale
    fused into the distance. ``c2`` is the row norm of the DEQUANTIZED
    shard (computed at index build) so the distance algebra is
    self-consistent with the quantized cross term."""
    q2 = torch.sum(q * q, dim=1, keepdim=True)               # [B, 1]
    qq, q_scale = _quantize_queries(q)
    dots = _int_matmul(qq.to(torch.float32),
                       corpus_q.to(torch.float32).T)         # [B, R] int32
    dots = dots.to(torch.float32) * (q_scale * row_scales[None, :])
    d2 = q2 - 2.0 * dots + c2[None, :]
    d, pos = topk_smallest(d2, k)
    return d, ids[pos]


def _int_cluster_dots(qq: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """``einsum("bd,bpmd->bpm")`` of int8 queries [B, D] and gathered
    int8 cluster rows [B, P, M, D] as the exact int32 accumulator (D in
    chunks of at most ``INT8_EXACT_K``, each exact in f32)."""
    if qq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int8 product: TF32 is on, which rounds the "
                           "f32 products; set torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    acc = None
    for lo in range(0, qq.shape[1], INT8_EXACT_K):
        a = sub[..., lo:lo + INT8_EXACT_K].to(torch.float32)
        b = qq[:, None, lo:lo + INT8_EXACT_K, None].to(torch.float32)
        part = torch.matmul(a, b)[..., 0].to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _ivf_scan(q, q2, probes, body_d2, c_c2, c_ids, k: int, nprobe: int):
    """Shared IVF probe loop: a running top-k carry over the top-
    ``nprobe`` clusters, as many probes a step as keep the gathered
    block under ``_PROBE_CHUNK_BYTES``. ``body_d2(cp)`` returns the
    [B, P, M] distance block (without the row norms) of the probed
    clusters ``cp`` [B, P]."""
    b, d = q.shape
    chunk = max(1, _PROBE_CHUNK_BYTES // (b * c_c2.shape[1] * d * 4))
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32,
                        device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for lo in range(0, nprobe, chunk):
        cp = probes[:, lo:lo + chunk]                        # [B, P]
        d2 = body_d2(cp) + c_c2[cp]                          # [B, P, M]
        cat_d = torch.cat([best_d, d2.reshape(b, -1)], dim=1)
        cat_i = torch.cat([best_i, c_ids[cp].reshape(b, -1)], dim=1)
        best_d, pos = topk_smallest(cat_d, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_d, best_i


def _route(q, q2, centroids, nprobe: int):
    """The ``nprobe`` nearest centroids of each query [B, nprobe]."""
    cent2 = torch.sum(centroids * centroids, dim=1)[None, :]
    cd2 = q2 - 2.0 * (q @ centroids.T) + cent2               # [B, K]
    return topk_smallest(cd2, nprobe)[1]


def ivf_topk_f32(q, centroids, clustered, c_c2, c_ids, k: int,
                 nprobe: int):
    """IVF-routed f32 search: ``centroids`` [K, D], ``clustered``
    [K, M, D] (cluster-major padded corpus), ``c_c2`` [K, M] row norms
    (``+inf`` padding), ``c_ids`` [K, M] global ids (-1 padding).
    Probes the ``nprobe`` nearest clusters per query."""
    q2 = torch.sum(q * q, dim=1, keepdim=True)               # [B, 1]
    probes = _route(q, q2, centroids, nprobe)

    def body(cp):
        sub = clustered[cp]                                  # [B, P, M, D]
        dots = torch.matmul(sub, q[:, None, :, None])[..., 0]
        return q2[:, :, None] - 2.0 * dots

    return _ivf_scan(q, q2, probes, body, c_c2, c_ids, k, nprobe)


def ivf_topk_int8(q, centroids, clustered_q, c_scales, c_c2, c_ids,
                  k: int, nprobe: int):
    """IVF-routed int8 search: centroid routing stays f32 (K·D is tiny
    next to the corpus), the per-cluster distance block takes the exact
    int32 cross term with fused dequant like :func:`brute_topk_int8`."""
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    probes = _route(q, q2, centroids, nprobe)
    qq, q_scale = _quantize_queries(q)

    def body(cp):
        dots = _int_cluster_dots(qq, clustered_q[cp])        # [B, P, M]
        return q2[:, :, None] - 2.0 * (
            dots.to(torch.float32) * (q_scale[:, :, None] * c_scales[cp]))

    return _ivf_scan(q, q2, probes, body, c_c2, c_ids, k, nprobe)
