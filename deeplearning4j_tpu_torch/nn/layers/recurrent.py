"""Recurrent layers.

The port of the JAX package's ``nn/layers/recurrent.py`` (reference:
deeplearning4j-nn/.../nn/layers/recurrent/, cell math in
LSTMHelpers.java:58): ``LSTM``, ``GravesLSTM`` (peepholes),
``GravesBidirectionalLSTM``, ``SimpleRnn`` and the wrappers
``Bidirectional``, ``LastTimeStep`` and ``MaskZeroLayer``.

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
  zero output;
- ``GravesLSTM`` and ``SimpleRnn`` run the per-tick loop (the JAX package
  runs them through ``lax.scan`` and reaches no TPU kernel);
- ``Bidirectional`` runs its inner layer twice, the second time on the
  time-reversed sequence and mask (a right-padded mask becomes leading
  masked ticks there), so a ``Bidirectional(LSTM)`` launches the forward
  kernel twice a call;
- ``initial_state`` (TBPTT segments, ``rnn_time_step``) reaches the core
  through ``LastTimeStep`` and ``MaskZeroLayer``; bidirectional layers
  refuse it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.inputs import (FeedForwardType, InputType,
                                                RecurrentType)
from deeplearning4j_tpu_torch.nn.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.ops import tensor_split
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
            # this rank's hidden units under tensor parallelism
            z4 = z.reshape(z.shape[0], z.shape[-1] // 4, 4)
            return z4[..., 0], z4[..., 1], z4[..., 2], z4[..., 3]
        return (z[:, :nh], z[:, nh:2 * nh], z[:, 2 * nh:3 * nh],
                z[:, 3 * nh:])

    def gate_update(self, z, c_prev, params=None):
        """(h, c) from the packed pre-activation ``z = zx + h_prev @ Wh``
        and the previous cell state: the cell math after its products
        (the generation tick forms ``z`` itself). ``params`` carries a
        subclass's extra weights (``GravesLSTM``'s peepholes)."""
        zi, zf, zo, zg = self._gates(z)
        i = self.gate_activation.apply(zi)
        f = self.gate_activation.apply(zf)
        o = self.gate_activation.apply(zo)
        g = self.activation.apply(zg)
        c = f * c_prev + i * g
        return o * self.activation.apply(c), c

    def _cell(self, params, carry, zx_t, mask_t):
        h_prev, c_prev = carry
        hy, c = self.gate_update(
            zx_t + tensor_split.copy_in(h_prev, "lstm") @ params["Wh"],
            c_prev, params)
        # under tensor parallelism h is gathered whole each tick, for the
        # next tick's product and the output; c stays this rank's
        hy = tensor_split.gather_out(hy, "lstm")
        if mask_t is not None:
            hy = _apply_mask_step(mask_t, hy, h_prev)
            c = _apply_mask_step(mask_t, c, c_prev)
        return (hy, c)

    def _fused_eligible(self) -> bool:
        """The fused recurrence implements exactly the default cell:
        gate-major [i|f|o|g] columns, sigmoid gates, tanh activation, no
        peepholes. Subclasses overriding the cell math (``GravesLSTM``)
        and other configs take the per-tick loop."""
        return (type(self)._cell is LSTM._cell
                and type(self).gate_update is LSTM.gate_update
                and self.gate_layout == "gate_major"
                and self.activation == Activation.TANH
                and self.gate_activation == Activation.SIGMOID)

    def apply(self, params, state, x, ctx, initial_state=None):
        x = self.maybe_dropout(x, ctx)
        n, t, _ = x.shape
        h = self.n_out
        # the input projection for all timesteps in one matmul
        zx = torch.matmul(tensor_split.copy_in(x, "lstm"), params["Wx"]) \
            + params["b"]
        if initial_state is None:
            h0 = torch.zeros((n, h), dtype=x.dtype, device=x.device)
            # this rank's hidden units under tensor parallelism
            c0 = torch.zeros((n, params["Wh"].shape[1] // 4), dtype=x.dtype,
                             device=x.device)
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


@register_serializable
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference: GravesLSTM, the Graves
    2013 formulation): ``i`` and ``f`` see ``c_prev`` through ``pI``,
    ``pF``; ``o`` sees the new ``c`` through ``pO``. Gate-major only."""

    def __post_init__(self):
        if self.gate_layout != "gate_major":
            raise ValueError(
                "GravesLSTM supports only gate_layout='gate_major'")

    def initialize(self, generator, input_type):
        params = super().initialize(generator, input_type)
        dt = self.param_dtype()
        for k in ("pI", "pF", "pO"):
            params[k] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def gate_update(self, z, c_prev, params=None):
        nh = self.n_out
        act, gate = self.activation, self.gate_activation
        i = gate.apply(z[:, :nh] + params["pI"] * c_prev)
        f = gate.apply(z[:, nh:2 * nh] + params["pF"] * c_prev)
        g = act.apply(z[:, 3 * nh:])
        c = f * c_prev + i * g
        o = gate.apply(z[:, 2 * nh:3 * nh] + params["pO"] * c)
        return o * act.apply(c), c


@register_serializable
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(FeedForwardLayer):
    """Bidirectional Graves LSTM as one layer (reference:
    GravesBidirectionalLSTM.java): ``Bidirectional(GravesLSTM)`` in concat
    mode, parameters and state under ``{"fwd", "bwd"}``."""
    activation: Activation = Activation.TANH
    gate_activation: Activation = Activation.SIGMOID
    forget_gate_bias_init: float = 1.0

    def _wrapper(self) -> "Bidirectional":
        inner = GravesLSTM(
            **{f.name: getattr(self, f.name)
               for f in dataclasses.fields(GravesLSTM)
               if hasattr(self, f.name)})
        return Bidirectional(fwd=inner, mode="concat", name=self.name)

    def output_type(self, input_type: InputType) -> InputType:
        return self._wrapper().output_type(input_type)

    def initialize(self, generator, input_type):
        return self._wrapper().initialize(generator, input_type)

    def init_state(self, input_type):
        return self._wrapper().init_state(input_type)

    def apply(self, params, state, x, ctx, initial_state=None):
        if initial_state is not None:
            raise ValueError(
                "GravesBidirectionalLSTM cannot carry state across chunks:"
                " the backward direction needs the full sequence")
        return self._wrapper().apply(params, state, x, ctx)


@register_serializable
@dataclasses.dataclass(frozen=True)
class SimpleRnn(FeedForwardLayer):
    """h_t = act(x_t @ Wx + h_{t-1} @ Wh + b) (reference: SimpleRnn); its
    carry is ``last_h`` alone."""
    activation: Activation = Activation.TANH

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps if isinstance(input_type, RecurrentType) \
            else None
        return RecurrentType(self.n_out, t)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        h = self.n_out
        dt = self.param_dtype()
        return {
            "Wx": self.weight_init.init(generator, (n_in, h), n_in, h, dt),
            "Wh": self.weight_init.init(generator, (h, h), h, h, dt),
            "b": torch.zeros((h,), dtype=dt),
        }

    def apply(self, params, state, x, ctx, initial_state=None):
        x = self.maybe_dropout(x, ctx)
        n, t, _ = x.shape
        zx = torch.matmul(x, params["Wx"]) + params["b"]
        h = (torch.zeros((n, self.n_out), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
        mask = ctx.mask
        ys = []
        for s in range(t):
            h_new = self.activation.apply(zx[:, s] + h @ params["Wh"])
            if mask is not None:
                h_new = _apply_mask_step(mask[:, s], h_new, h)
            h = h_new
            ys.append(h)
        out = torch.stack(ys, dim=1)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        new_state = dict(state)
        new_state["last_h"] = h
        return out, new_state


def _draws_dropout(layer: Layer) -> bool:
    d = layer.dropout
    return not (isinstance(d, (int, float)) and d <= 0.0)


def _split_generator(gen: torch.Generator):
    """Two generators seeded from ``gen``: one for each direction."""
    seeds = torch.randint(0, 2 ** 62, (2,), generator=gen,
                          device=gen.device).tolist()
    return tuple(torch.Generator(device=gen.device).manual_seed(s)
                 for s in seeds)


@register_serializable
@dataclasses.dataclass(frozen=True)
class Bidirectional(Layer):
    """Bidirectional wrapper (reference: nn/conf/layers/recurrent/
    Bidirectional.java, modes CONCAT/ADD/MUL/AVERAGE). The backward
    direction runs the inner layer on the time-reversed sequence and mask
    and flips its output back."""
    fwd: Optional[Layer] = None
    mode: str = "concat"  # concat|add|mul|average

    def __post_init__(self):
        if self.fwd is None:
            raise ValueError("Bidirectional requires an inner recurrent "
                             "layer")

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.fwd.output_type(input_type)
        if self.mode == "concat":
            return RecurrentType(inner.size * 2, inner.timesteps)
        return inner

    def initialize(self, generator, input_type):
        return {"fwd": self.fwd.initialize(generator, input_type),
                "bwd": self.fwd.initialize(generator, input_type)}

    def init_state(self, input_type):
        return {"fwd": self.fwd.init_state(input_type),
                "bwd": self.fwd.init_state(input_type)}

    def apply(self, params, state, x, ctx):
        ctx_f = ctx_b = ctx
        if (ctx.train and ctx.generator is not None
                and _draws_dropout(self.fwd)):
            gf, gb = _split_generator(ctx.generator)
            ctx_f = dataclasses.replace(ctx, generator=gf)
            ctx_b = dataclasses.replace(ctx, generator=gb)
        yf, sf = self.fwd.apply(params["fwd"], state.get("fwd", {}), x,
                                ctx_f)
        mask_r = None if ctx.mask is None else torch.flip(ctx.mask, (1,))
        yb, sb = self.fwd.apply(params["bwd"], state.get("bwd", {}),
                                torch.flip(x, (1,)),
                                dataclasses.replace(ctx_b, mask=mask_r))
        yb = torch.flip(yb, (1,))
        if self.mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "add":
            y = yf + yb
        elif self.mode == "mul":
            y = yf * yb
        elif self.mode == "average":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(self.mode)
        return y, {"fwd": sf, "bwd": sb}


def _apply_inner(inner, params, state, x, ctx, initial_state):
    if initial_state is not None:
        return inner.apply(params, state, x, ctx,
                           initial_state=initial_state)
    return inner.apply(params, state, x, ctx)


@register_serializable
@dataclasses.dataclass(frozen=True)
class LastTimeStep(Layer):
    """Wraps a recurrent layer and emits its last unmasked timestep
    (reference: nn/conf/layers/recurrent/LastTimeStep.java); a row with
    no unmasked step gives step 0."""
    inner: Optional[Layer] = None

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(self.inner.output_type(input_type).size)

    def initialize(self, generator, input_type):
        return self.inner.initialize(generator, input_type)

    def init_state(self, input_type):
        return self.inner.init_state(input_type)

    def apply(self, params, state, x, ctx, initial_state=None):
        y, new_state = _apply_inner(self.inner, params, state, x, ctx,
                                    initial_state)
        return last_step(y, ctx.mask), new_state


def last_step(y: torch.Tensor, mask: Optional[torch.Tensor]):
    """(N, T, F) → (N, F): each row's last unmasked step (the last step
    without a mask), clipped at 0."""
    if mask is None:
        return y[:, -1]
    idx = (mask.to(torch.int64).sum(dim=1) - 1).clamp(0, y.shape[1] - 1)
    return y[torch.arange(y.shape[0], device=y.device), idx]


@register_serializable
@dataclasses.dataclass(frozen=True)
class MaskZeroLayer(Layer):
    """Sets the mask from a sentinel input value (reference:
    nn/conf/layers/util/MaskZeroLayer.java): a step is masked where every
    feature equals ``mask_value``."""
    inner: Optional[Layer] = None
    mask_value: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        return self.inner.output_type(input_type)

    def initialize(self, generator, input_type):
        return self.inner.initialize(generator, input_type)

    def init_state(self, input_type):
        return self.inner.init_state(input_type)

    def apply(self, params, state, x, ctx, initial_state=None):
        mask = (x != self.mask_value).any(dim=-1).to(torch.float32)
        return _apply_inner(self.inner, params, state, x,
                            dataclasses.replace(ctx, mask=mask),
                            initial_state)


def unwrap_recurrent(layer):
    """The stateful core of a layer: ``LastTimeStep`` and
    ``MaskZeroLayer`` hand params, state and ``initial_state`` to their
    inner layer, so TBPTT carries and ``rnn_time_step`` look through
    them."""
    inner = getattr(layer, "inner", None)
    if isinstance(layer, (LastTimeStep, MaskZeroLayer)) \
            and inner is not None:
        return unwrap_recurrent(inner)
    return layer


def carry_core(layer):
    """(core, is_lstm) of a layer whose hidden state crosses TBPTT
    segments and ``rnn_time_step`` calls (an ``LSTM`` or ``SimpleRnn``
    core, wrapped or not), else None."""
    core = unwrap_recurrent(layer)
    if isinstance(core, (LSTM, SimpleRnn)):
        return core, isinstance(core, LSTM)
    return None


def first_bidirectional_name(named_layers):
    """Name of the first layer whose (unwrapped) core is bidirectional,
    or None; ``named_layers`` yields (name, layer) pairs. Shared by
    ``rnn_time_step``'s refusal and TBPTT's warning on both model
    types."""
    for name, layer in named_layers:
        if isinstance(unwrap_recurrent(layer),
                      (Bidirectional, GravesBidirectionalLSTM)):
            return name
    return None


def warn_tbptt_bidirectional(name: str, stacklevel: int = 4):
    """TBPTT segments a bidirectional layer with no carried state: each
    segment's backward direction is cut at the segment boundary, which
    differs from full-sequence BPTT."""
    warnings.warn(
        f"TBPTT fit with bidirectional layer '{name}': bidirectional "
        "cores carry no state across chunks, so the backward pass is "
        "truncated at each chunk boundary (differs from full-sequence "
        "BPTT). Use backprop_type='standard' for exact bidirectional "
        "gradients.", UserWarning, stacklevel=stacklevel)
