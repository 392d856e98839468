"""Mixture-of-experts FFN with top-k routing, on one device.

The single-device half of the JAX package's ``parallel/moe.py``
(GShard/Switch-style dense dispatch): routing builds (tokens, experts,
capacity) dispatch and combine tensors, so the whole layer is three
einsums and the expert FFN, with static shapes and no gather or scatter.
Semantics kept from the JAX package:

- capacity is claimed in token order, by a cumulative sum over the
  tokens' (valid) choices;
- the k choices run in sequence, each seeing the per-expert counts the
  earlier ones left;
- ``argmax`` breaks ties by the first index (``torch.argmax`` does too);
- a masked (padding) token takes no slot, is left out of the aux and z
  statistics, and comes out as 0;
- a token past its expert's capacity is dropped (combine weight 0);
- the router (softmax, statistics, dispatch and combine weights) runs in
  float32 for f32 and bf16 inputs. A float64 input (a gradient check)
  keeps float64 there, where the JAX package's router truncates to
  float32: central differences at eps 1e-6 need the router's own
  rounding far below the step.

Expert parallelism: after ``set_default_mesh(mesh, axis)`` the experts
are split over the axis's ranks (rank j holds experts ``[j*E/P,
(j+1)*E/P)``: ``w_in``, ``b_in``, ``w_out``, ``b_out`` carry E/P
experts, ``gate_w`` all E) and each rank holds its own tokens. The router
runs on every rank over all tokens (the (T, E) logits are all-gathered,
their cotangent summed back over the axis), so capacity is claimed in the
global token order and the drops are the unsplit layer's. Each rank
scatters its tokens into the (E, C, d) capacity buffer, one all-to-all
sends each expert's slots to the rank holding it (a slot is claimed by
one token, so the sum of the received buffers is the unsplit one), the
rank runs its experts' FFN, and one all-to-all returns every expert's
output to every rank, which combines its tokens. The aux and z losses
are the whole batch's on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.parallel.mesh import (all_gather,
                                                    all_to_all_chunks,
                                                    gather_sum_from_axis)

EXPERT_AXIS = "expert"

_default_mesh = None
_default_axis: str = EXPERT_AXIS


def set_default_mesh(mesh, axis: str = EXPERT_AXIS) -> None:
    """Install the mesh whose ``axis`` splits the experts (None: every
    expert in this process). Training code sets it once; layers then split
    without threading a mesh through their (serializable) configs."""
    global _default_mesh, _default_axis
    _default_mesh = mesh
    _default_axis = axis


def _expert_axis():
    m = _default_mesh
    if m is None or int(m.shape.get(_default_axis, 1)) <= 1:
        return None
    return m.axis(_default_axis)


@dataclasses.dataclass
class MoEOutput:
    y: torch.Tensor              # (tokens..., d_out) combined expert outputs
    aux_loss: torch.Tensor       # load-balancing loss (scalar)
    router_z_loss: torch.Tensor  # router logit magnitude penalty (scalar)
    # (token, expert) assignments of this rank's tokens that found a
    # capacity slot (scalar); top_k times the valid tokens, less its sum
    # over the expert axis, is the number dropped
    dispatched: torch.Tensor


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def route_top_k(logits: torch.Tensor, k: int, capacity: int,
                token_mask: Optional[torch.Tensor] = None):
    """Top-k routing to dense dispatch/combine tensors.

    logits: (T, E). token_mask: optional (T,) validity mask: masked
    (padding) tokens are never dispatched, consume no expert capacity,
    and are excluded from the aux/z statistics. Returns (dispatch (T,E,C)
    0/1 float, combine (T,E,C) float, aux_loss, z_loss). Tokens
    overflowing an expert's capacity C are dropped (Switch semantics)."""
    t, e = logits.shape
    acc = torch.promote_types(torch.float32, logits.dtype)
    lf = logits.to(acc)
    probs = torch.softmax(lf, -1)
    tm = (torch.ones((t,), dtype=acc, device=logits.device)
          if token_mask is None else token_mask.reshape(-1).to(acc))
    n_valid = torch.clamp(tm.sum(), min=1.0)

    # aux loss (Switch eq. 4): E * sum_e(frac_tokens_e * mean_prob_e),
    # from the top-1 assignment over valid tokens only
    top1 = torch.argmax(probs, -1)
    frac = (F.one_hot(top1, e).to(acc) * tm[:, None]).sum(0) \
        / n_valid
    aux = e * torch.sum(frac * (probs * tm[:, None]).sum(0) / n_valid)
    z = torch.sum(torch.logsumexp(lf, -1) ** 2 * tm) / n_valid

    dispatch = torch.zeros((t, e, capacity), dtype=acc,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    valid = tm > 0
    masked = probs * tm[:, None]
    slots = torch.arange(capacity, device=logits.device)
    for _ in range(k):
        choice = torch.argmax(masked, -1)                        # (T,)
        gate = torch.gather(masked, 1, choice[:, None])[:, 0]
        sel = F.one_hot(choice, e).to(torch.int32)               # (T, E)
        # each token's place in its chosen expert's queue; padding tokens
        # neither advance the queue nor claim a slot
        sel_eff = sel * valid[:, None].to(torch.int32)
        pos_in_expert = (torch.cumsum(sel_eff, 0, dtype=torch.int32)
                         - sel_eff) + counts[None, :]
        pos = torch.sum(sel_eff * pos_in_expert, -1)             # (T,)
        keep = torch.logical_and(pos < capacity, valid)
        # one_hot(pos, capacity) with an out-of-range pos all zeros, as
        # jax.nn.one_hot gives it
        oh_pos = (pos[:, None] == slots[None, :]).to(acc)
        d = (sel_eff.to(acc)[:, :, None] * oh_pos[:, None, :]
             * keep[:, None, None].to(acc))
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        counts = counts + torch.sum(
            sel_eff * keep[:, None].to(torch.int32), 0, dtype=torch.int32)
        masked = masked * (1.0 - sel.to(acc))                # exclude chosen
    return dispatch, combine, aux, z


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor,
            w_in: torch.Tensor, b_in: torch.Tensor,
            w_out: torch.Tensor, b_out: torch.Tensor, *,
            top_k: int = 2, capacity_factor: float = 1.25,
            activation: Optional[Callable] = None,
            token_mask: Optional[torch.Tensor] = None) -> MoEOutput:
    """Mixture-of-experts FFN over the last dim of ``x``.

    x: (..., d_model); gate_w: (d_model, E); w_in: (E, d_model, d_ff);
    b_in: (E, d_ff); w_out: (E, d_ff, d_model); b_out: (E, d_model).
    token_mask: optional validity mask broadcastable to x.shape[:-1]
    (padding tokens are not routed; their output is 0). The default
    activation is tanh-approximated GELU, ``jax.nn.gelu``'s default."""
    if activation is None:
        activation = _gelu_tanh
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    e = gate_w.shape[-1]
    ax = _expert_axis()
    parts = 1 if ax is None else ax.size
    if w_in.shape[0] * parts != e:
        raise ValueError(f"{w_in.shape[0]} experts on each of {parts} "
                         f"ranks, but the router has {e}")
    t = xt.shape[0] * parts
    capacity = max(1, int(capacity_factor * top_k * t / e))

    flat_mask = None
    if token_mask is not None:
        flat_mask = torch.broadcast_to(token_mask,
                                       orig_shape[:-1]).reshape(-1)

    logits = xt @ gate_w.to(xt.dtype)
    if ax is not None:
        # every rank routes every token: capacity in the global order
        logits = gather_sum_from_axis(logits, ax, 0)
        if flat_mask is not None:
            flat_mask = all_gather(flat_mask.contiguous(), 0, ax.group)
    dispatch, combine, aux, z = route_top_k(logits, top_k, capacity,
                                            token_mask=flat_mask)
    if ax is not None:
        rows = slice(ax.index * xt.shape[0], (ax.index + 1) * xt.shape[0])
        dispatch, combine = dispatch[rows], combine[rows]
    dispatched = dispatch.sum()
    dispatch = dispatch.to(xt.dtype)
    combine = combine.to(xt.dtype)

    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    if ax is not None:
        # each rank's slots of each expert to the rank holding it
        expert_in = sum(all_to_all_chunks(
            list(torch.chunk(expert_in, parts, dim=0)), ax))
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, w_in)
                   + b_in[:, None, :].to(xt.dtype))
    expert_out = (torch.einsum("ecf,efd->ecd", h, w_out)
                  + b_out[:, None, :].to(xt.dtype))
    if ax is not None:
        # every expert's output back to every rank
        expert_out = torch.cat(all_to_all_chunks([expert_out] * parts, ax),
                               dim=0)
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return MoEOutput(y.reshape(orig_shape[:-1] + (y.shape[-1],)), aux, z,
                     dispatched)
