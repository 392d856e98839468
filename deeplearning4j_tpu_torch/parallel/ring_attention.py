"""Sequence parallelism: exact attention over a sequence split across ranks.

The port of the JAX package's ``parallel/ring_attention.py``. Each rank
of a mesh axis holds a T/P slice of the sequence (its rows of q, k, v
and of the key mask, in axis order); the functions take and return this
rank's slices.

- ``ring_self_attention``: K/V blocks go one hop around the ring a step
  (``mesh.ppermute_chained``: a paired send and receive) while each rank
  folds its queries' attention over the block into an online softmax
  (running max and denominator, as flash attention does). After P steps
  every query has seen every key. Causal masking is by global positions,
  masked scores take the large finite ``_NEG`` (-inf would give NaN in
  the backward of a fully masked row), and a row with no valid key comes
  out as zeros. The body is plain torch einsums, as in the JAX package,
  where it runs outside any Pallas kernel: it adds no kernel and no
  launch. Autograd cannot follow a tensor into another process, so each
  hop is an autograd Function whose backward is the reverse hop; the
  hops are chained (a hop's input is the previous hop's output), so every
  rank runs its backward hops in the same order and each backward send
  meets its receive.
- ``ulysses_self_attention``: one all-to-all trades the sequence split of
  q, k and v (packed into one message) for a head split, every rank runs
  ``ops.flash_attention.flash_attention`` on the whole sequence of its
  H/P heads (kernels 9-11 on the card), and one all-to-all trades back.
  The all-to-all's outputs are concatenated, so the kernel reads
  contiguous (N, T, H/P, Dh) tensors. The key mask is all-gathered. H
  must divide by P.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                                    all_to_all_chunks,
                                                    ppermute,
                                                    ppermute_chained)

SEQ_AXIS = "sp"

_NEG = float(torch.finfo(torch.float32).min) / 2


def ring_self_attention(q, k, v, mesh: Mesh, *, axis: str = SEQ_AXIS,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        batch_axis: Optional[str] = None):
    """Exact attention with q/k/v split along time over ``mesh[axis]``.

    q, k, v: (N, T/P, H, Dh), this rank's slice of the sequence (its
    batch rows under ``batch_axis``, which needs nothing more here).
    mask: (N, T/P) key-validity slice, or None. Returns this rank's
    (N, T/P, H, Dh) slice of the output."""
    ax = mesh.axis(axis)
    n_dev, my = ax.size, ax.index
    tl, dh = q.shape[1], q.shape[-1]
    acc_t = torch.promote_types(torch.float32, q.dtype)
    scale = 1.0 / float(dh) ** 0.5
    qf = q.to(acc_t)
    n, h = q.shape[0], q.shape[2]
    m = torch.full((n, h, tl), _NEG, dtype=acc_t, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=acc_t, device=q.device)
    kv = torch.stack([k, v])
    mask_c = mask
    qpos = my * tl + torch.arange(tl, device=q.device)
    for i in range(n_dev):
        src = (my - i) % n_dev                 # owner of this K/V block
        s = torch.einsum("nqhd,nkhd->nhqk", qf, kv[0].to(acc_t)) * scale
        if causal:
            kpos = src * tl + torch.arange(tl, device=q.device)
            s = torch.where(kpos[None, None, None, :]
                            <= qpos[None, None, :, None], s, _NEG)
        if mask_c is not None:
            s = torch.where(mask_c[:, None, None, :].to(torch.bool), s,
                            _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        # masked entries: exp underflows to 0 once m_new is O(1); a row
        # with every key masked (m_new == _NEG) is zeroed explicitly
        p = torch.where(s <= _NEG, 0.0, p)
        l = l * corr + p.sum(-1)
        acc = (acc * corr.transpose(1, 2)[..., None]
               + torch.einsum("nhqk,nkhd->nqhd", p, kv[1].to(acc_t)))
        m = m_new
        if i < n_dev - 1:
            kv = ppermute_chained(kv, kv, ax)
            if mask_c is not None:
                mask_c = ppermute(mask_c, ax)
    # (N, H, Tq) -> (N, Tq, H); rows with no valid key give zeros
    denom = l.transpose(1, 2)[..., None]
    out = torch.where(denom > 0, acc / torch.clamp(denom, min=1e-30), 0.0)
    return out.to(q.dtype)


def _a2a(x: torch.Tensor, ax, split_dim: int, cat_dim: int):
    """Split ``split_dim`` over the axis's ranks and gather ``cat_dim``
    from them (``lax.all_to_all(..., tiled=True)``)."""
    chunks = list(torch.chunk(x, ax.size, dim=split_dim))
    return torch.cat(all_to_all_chunks(chunks, ax), dim=cat_dim)


def ulysses_self_attention(q, k, v, mesh: Mesh, *, axis: str = SEQ_AXIS,
                           mask: Optional[torch.Tensor] = None,
                           causal: bool = False,
                           batch_axis: Optional[str] = None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style), the
    alternative to the ring: full-sequence attention through the flash
    kernels on H/P heads. q, k, v: (N, T/P, H, Dh) slices as for
    ``ring_self_attention``; H must divide by P."""
    ax = mesh.axis(axis)
    p = int(mesh.shape.get(axis, 1))
    if q.shape[2] % p:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible"
                         f" by the {axis!r} axis ({p})")
    # (3, N, T/P, H, Dh) -> (3, N, T, H/P, Dh): heads out, sequence in
    qkv = _a2a(torch.stack([q, k, v]), ax, split_dim=3, cat_dim=2)
    mg = None if mask is None else all_gather(
        mask.to(torch.float32).contiguous(), 1, ax.group)
    o = flash_attention(qkv[0], qkv[1], qkv[2], mask=mg, causal=causal)
    return _a2a(o, ax, split_dim=1, cat_dim=2)      # (N, T/P, H, Dh)
