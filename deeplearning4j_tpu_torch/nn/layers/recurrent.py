"""Recurrent layers.

The port of the JAX package's ``nn/layers/recurrent.py`` (reference:
deeplearning4j-nn/.../nn/layers/recurrent/, cell math in
LSTMHelpers.java:58), for the standard ``LSTM``:

- sequences are (N, T, F); the input projection x@Wx + b for all
  timesteps is one matmul outside the recurrence, and only h@Wh stays
  sequential;
- an LSTM with the default cell (gate-major [i|f|o|g] columns, sigmoid
  gates, tanh activation) runs its recurrence through ``lstm_fused``
  (ops/fused_lstm.py): one launch of the forward kernel per call on the
  card (the plain version for CPU tensors), whose backward is the second
  kernel; any other LSTM runs the plain per-tick loop of ``_cell``, the
  JAX package's ``lax.scan`` path;
- masking follows the reference: a masked tick keeps (h, c) and emits a
  zero output.

``GravesLSTM``, ``GravesBidirectionalLSTM``, ``SimpleRnn``,
``Bidirectional``, ``LastTimeStep`` and ``MaskZeroLayer`` are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType, RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import FeedForwardLayer
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.fused_lstm import lstm_fused
from deeplearning4j_tpu_torch.utils.serde import register_serializable


def _apply_mask_step(mask_t, new_val, old_val):
    """Per-timestep mask: keep old where mask == 0."""
    m = mask_t[:, None].to(new_val.dtype)
    return m * new_val + (1.0 - m) * old_val


@register_serializable
@dataclasses.dataclass(frozen=True)
class LSTM(FeedForwardLayer):
    """Standard LSTM (no peepholes). Gate order [i, f, o, g] packed in one
    4H-wide projection; ``forget_gate_bias_init`` is the reference's
    forgetGateBiasInit. ``gate_layout``: "gate_major" (default, four
    H-wide gate blocks) or "hidden_major" (column h*4+g, the layout the
    JAX package's tensor parallelism shards)."""
    activation: Activation = Activation.TANH
    gate_activation: Activation = Activation.SIGMOID
    forget_gate_bias_init: float = 1.0
    gate_layout: str = "gate_major"

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps if isinstance(input_type, RecurrentType) \
            else None
        return RecurrentType(self.n_out, t)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        h = self.n_out
        dt = self.param_dtype()
        b = torch.zeros((4 * h,), dtype=dt)
        if self.gate_layout == "hidden_major":
            b = b.reshape(h, 4)
            b[:, 1] = self.forget_gate_bias_init
            b = b.reshape(4 * h)
        else:
            b[h:2 * h] = self.forget_gate_bias_init
        return {
            "Wx": self.weight_init.init(generator, (n_in, 4 * h), n_in, h,
                                        dt),
            "Wh": self.weight_init.init(generator, (h, 4 * h), h, h, dt),
            "b": b,
        }

    def _gates(self, z):
        """(i, f, o, g) pre-activations of the packed 4H projection, per
        the configured column layout."""
        nh = self.n_out
        if self.gate_layout == "hidden_major":
            z4 = z.reshape(z.shape[0], nh, 4)
            return z4[..., 0], z4[..., 1], z4[..., 2], z4[..., 3]
        return (z[:, :nh], z[:, nh:2 * nh], z[:, 2 * nh:3 * nh],
                z[:, 3 * nh:])

    def _cell(self, params, carry, zx_t, mask_t):
        h_prev, c_prev = carry
        z = zx_t + h_prev @ params["Wh"]
        zi, zf, zo, zg = self._gates(z)
        i = self.gate_activation.apply(zi)
        f = self.gate_activation.apply(zf)
        o = self.gate_activation.apply(zo)
        g = self.activation.apply(zg)
        c = f * c_prev + i * g
        hy = o * self.activation.apply(c)
        if mask_t is not None:
            hy = _apply_mask_step(mask_t, hy, h_prev)
            c = _apply_mask_step(mask_t, c, c_prev)
        return (hy, c)

    def _fused_eligible(self) -> bool:
        """The fused recurrence implements exactly the default cell:
        gate-major [i|f|o|g] columns, sigmoid gates, tanh activation, no
        peepholes. Subclasses overriding ``_cell`` and other configs take
        the per-tick loop."""
        return (type(self)._cell is LSTM._cell
                and self.gate_layout == "gate_major"
                and self.activation == Activation.TANH
                and self.gate_activation == Activation.SIGMOID)

    def apply(self, params, state, x, ctx, initial_state=None):
        x = self.maybe_dropout(x, ctx)
        n, t, _ = x.shape
        h = self.n_out
        # the input projection for all timesteps in one matmul
        zx = torch.matmul(x, params["Wx"]) + params["b"]
        if initial_state is None:
            h0 = torch.zeros((n, h), dtype=x.dtype, device=x.device)
            c0 = torch.zeros((n, h), dtype=x.dtype, device=x.device)
        else:
            h0, c0 = initial_state
        mask = ctx.mask
        if self._fused_eligible():
            ys_t, h_t, c_t = lstm_fused(
                zx.transpose(0, 1), h0, c0, params["Wh"],
                None if mask is None else mask.transpose(0, 1))
            out = ys_t.transpose(0, 1)
        else:
            carry = (h0, c0)
            ys = []
            for s in range(t):
                carry = self._cell(params, carry, zx[:, s],
                                   None if mask is None else mask[:, s])
                ys.append(carry[0])
            h_t, c_t = carry
            out = torch.stack(ys, dim=1)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        new_state = dict(state)
        new_state["last_h"] = h_t
        new_state["last_c"] = c_t
        return out, new_state

    def step_one(self, params, x_t, carry):
        """Single-timestep streaming inference — the analog of the
        reference's ``rnnTimeStep`` (MultiLayerNetwork.java:2806)."""
        zx = x_t @ params["Wx"] + params["b"]
        return self._cell(params, carry, zx, None)


def unwrap_recurrent(layer):
    """The stateful core of a layer. The JAX package looks through its
    ``LastTimeStep`` / ``MaskZeroLayer`` wrappers here; the port has no
    wrapper layers yet, so every layer is its own core."""
    return layer
