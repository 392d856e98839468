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

Expert parallelism (the expert mesh axis and its sharding constraints)
is the second half of ROADMAP queue 1 item 15: ``set_default_mesh``
raises naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

EXPERT_AXIS = "expert"


def set_default_mesh(mesh, axis: str = EXPERT_AXIS) -> None:
    """The JAX package installs a mesh for expert sharding here; the port
    has data parallelism (parallel/wrapper.py) but no sharding of a
    model over devices yet."""
    raise NotImplementedError(
        "parallel.moe.set_default_mesh: expert sharding over a mesh is "
        "not ported yet (ROADMAP.md, queue 1 item 15, its second half)")


@dataclasses.dataclass
class MoEOutput:
    y: torch.Tensor              # (tokens..., d_out) combined expert outputs
    aux_loss: torch.Tensor       # load-balancing loss (scalar)
    router_z_loss: torch.Tensor  # router logit magnitude penalty (scalar)


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
    t = xt.shape[0]
    e = gate_w.shape[-1]
    capacity = max(1, int(capacity_factor * top_k * t / e))

    flat_mask = None
    if token_mask is not None:
        flat_mask = torch.broadcast_to(token_mask,
                                       orig_shape[:-1]).reshape(-1)

    logits = xt @ gate_w.to(xt.dtype)
    dispatch, combine, aux, z = route_top_k(logits, top_k, capacity,
                                            token_mask=flat_mask)
    dispatch = dispatch.to(xt.dtype)
    combine = combine.to(xt.dtype)

    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, w_in)
                   + b_in[:, None, :].to(xt.dtype))
    expert_out = (torch.einsum("ecf,efd->ecd", h, w_out)
                  + b_out[:, None, :].to(xt.dtype))
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return MoEOutput(y.reshape(orig_shape[:-1] + (y.shape[-1],)), aux, z)
