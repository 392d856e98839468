"""Fused ResNet bottleneck block layer.

One layer = the whole bottleneck residual unit
(1×1 conv → BN → ReLU → 3×3 conv → BN → ReLU → 1×1 conv → BN →
(+shortcut) → ReLU), run through the fused conv+BN kernels
(ops/fused_conv.py): each BN's normalize+ReLU rides the consumer conv's
input pass.

* Training: every conv returns its output's (Σy, Σy²) from the kernel's
  epilogue; ``stats_to_scale_shift`` turns them into the batch-statistics
  (scale, shift) of the next kernel's prologue, and the running mean/var
  are updated with ``decay`` (detached) into the returned state. The
  backward runs through the backward kernels (the fused op's
  ``autograd.Function``), differentiating through the statistics.
* Inference: the BNs use their running statistics, folded into a
  per-channel (scale, shift) in f32 from the parameters (rounded to the
  compute dtype first, as the JAX package's ``cast_params`` does) and the
  f32 running state.

The port of the JAX package's ``nn/layers/fused.py``: same fields, same
parameter and state names and layouts (W1/Wds (Cin, Cout), W2 HWIO,
``bn*_gamma``/``bn*_beta``, state ``bn*_mean``/``bn*_var``), so both
implementations load the same weights:

* ``impl="pallas"``: the convs run through the fused conv kernels;
* ``impl="xla"``: the same arithmetic by plain convolutions with the
  statistics taken beside them (``fused_conv.conv_bn_stats_xla``, its
  ``"auto"`` statistics route), no kernel.

Each is a named choice; neither falls back to the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from deeplearning4j_tpu_torch.nn.inputs import ConvolutionalType, InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.ops import batch_stats, fused_conv
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.utils.serde import register_serializable


class ConvCall(NamedTuple):
    """One fused-conv launch of a block's forward at a given batch."""
    kernel: str                    # "fused_mm" | "fused_c3"
    x_shape: Tuple[int, int, int, int]
    w_shape: Tuple[int, ...]
    stride: int
    norm_in: bool
    relu_in: bool


@register_serializable
@dataclasses.dataclass(frozen=True)
class FusedBottleneckBlock(Layer):
    """ResNet-v1 bottleneck: f→f→4f channels, stride on the first 1×1
    (and the projection shortcut when ``downsample``)."""
    filters: int = 64
    stride: int = 1
    downsample: bool = False
    eps: float = 1e-5
    decay: float = 0.9
    impl: str = "pallas"

    def __post_init__(self):
        if self.impl not in ("pallas", "xla"):
            raise ValueError(
                f"FusedBottleneckBlock impl must be 'pallas' or 'xla', "
                f"got {self.impl!r}")

    # ---- shape ----------------------------------------------------------
    def _out_hw(self, it: ConvolutionalType) -> Tuple[int, int]:
        return (-(-it.height // self.stride), -(-it.width // self.stride))

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._out_hw(input_type)
        return ConvolutionalType(h, w, self.filters * 4)

    def kernel_calls(self, input_type: ConvolutionalType,
                     batch: int) -> List[ConvCall]:
        """The convs one forward of this block makes on a ``batch``-row
        input, in order (shapes, flags): the fused-conv launches under
        ``impl="pallas"``, what a benchmark needs to hold each kernel (or
        the "xla" arm's conv) to the path's real shapes."""
        it = input_type
        cin, f, f4 = it.channels, self.filters, self.filters * 4
        ho, wo = self._out_hw(it)
        x0 = (batch, it.height, it.width, cin)
        mid = (batch, ho, wo, f)
        calls = [ConvCall("fused_mm", x0, (cin, f), self.stride, False,
                          False),
                 ConvCall("fused_c3", mid, (3, 3, f, f), 1, True, True),
                 ConvCall("fused_mm", mid, (f, f4), 1, True, True)]
        if self.downsample:
            calls.append(ConvCall("fused_mm", x0, (cin, f4), self.stride,
                                  False, False))
        return calls

    # ---- params / state -------------------------------------------------
    def _bns(self):
        names = ["bn1", "bn2", "bn3"]
        if self.downsample:
            names.append("bnds")
        return names

    def _widths(self):
        f, f4 = self.filters, self.filters * 4
        return {"bn1": f, "bn2": f, "bn3": f4, "bnds": f4}

    def initialize(self, generator, input_type):
        cin = input_type.channels
        f, f4 = self.filters, self.filters * 4
        dt = self.param_dtype()
        he = WeightInit.HE_NORMAL
        params = {
            "W1": he.init(generator, (cin, f), cin, f, dt),
            "W2": he.init(generator, (3, 3, f, f), 9 * f, 9 * f, dt),
            "W3": he.init(generator, (f, f4), f, f4, dt),
        }
        if self.downsample:
            params["Wds"] = he.init(generator, (cin, f4), cin, f4, dt)
        widths = self._widths()
        for bn in self._bns():
            params[f"{bn}_gamma"] = torch.ones((widths[bn],), dtype=dt)
            params[f"{bn}_beta"] = torch.zeros((widths[bn],), dtype=dt)
        return params

    def init_state(self, input_type):
        widths = self._widths()
        st = {}
        for bn in self._bns():
            st[f"{bn}_mean"] = torch.zeros((widths[bn],), dtype=torch.float32)
            st[f"{bn}_var"] = torch.ones((widths[bn],), dtype=torch.float32)
        return st

    # ---- forward --------------------------------------------------------
    def _bn_form(self, params, state, name):
        """(scale, shift) of BN ``name``'s running-statistics normalize in
        f32, folded into the NEXT kernel's prologue."""
        gamma = params[f"{name}_gamma"].float()
        beta = params[f"{name}_beta"].float()
        var = state[f"{name}_var"].float()
        mean = state[f"{name}_mean"].float()
        inv = gamma * torch.rsqrt(var + self.eps)
        return inv, beta - mean * inv

    def fold_inference_state(self, params, state):
        """``state`` plus what ``apply`` would otherwise compute on every
        call: each BN's (scale, shift) (``bn*_scale``/``bn*_shift``; f32
        for the kernels' prologues, the compute dtype for the tail's bn3
        and bnds) and the identity prologue of W1/Wds
        (``in_scale``/``in_shift``). ``params`` are in the compute dtype,
        as ``apply`` gets them.
        A serving engine folds once when it commits its params (as a
        deployment folds BN into its convs); ``apply`` then launches only
        the convs and the tail."""
        out = dict(state)
        for bn in self._bns():
            scale, shift = self._bn_form(params, state, bn)
            if bn in ("bn3", "bnds"):
                # only the tail reads these, in the compute dtype
                scale = scale.to(params["W3"].dtype)
                shift = shift.to(params["W3"].dtype)
            out[f"{bn}_scale"], out[f"{bn}_shift"] = scale, shift
        w1 = params["W1"]
        out["in_scale"] = torch.ones((w1.shape[0],), dtype=torch.float32,
                                     device=w1.device)
        out["in_shift"] = torch.zeros_like(out["in_scale"])
        return out

    def _batch_bn_form(self, params, state, new_state, name, stats,
                       count):
        """(scale, shift) of BN ``name``'s batch-statistics normalize from
        the conv's (Σy, Σy²); the running averages go to ``new_state``.
        Inside ``ops.batch_stats.summed`` (the parallel wrapper's global
        batch) the sums and the count are the global batch's."""
        group = batch_stats.current()
        if group is not None:
            stats, count = group.fn(stats), count * group.world
        inv, shift, mean, var = fused_conv.stats_to_scale_shift(
            stats, count, params[f"{name}_gamma"], params[f"{name}_beta"],
            self.eps)
        d = self.decay
        for key, batch in (("mean", mean), ("var", var)):
            new_state[f"{name}_{key}"] = (
                d * state[f"{name}_{key}"] + (1 - d) * batch.detach()).float()
        return inv, shift

    def apply(self, params, state, x, ctx):
        train = ctx.train
        new_state = dict(state) if train else state

        def bn_form(name, stats, count):
            if train:
                return self._batch_bn_form(params, state, new_state, name,
                                           stats, count)
            if f"{name}_scale" in state:             # folded at commit
                return state[f"{name}_scale"], state[f"{name}_shift"]
            return self._bn_form(params, state, name)

        conv = (fused_conv.conv_bn_stats_xla if self.impl == "xla"
                else fused_conv.fused_conv_bn_act)
        if "in_scale" in state and not train:
            ones, zeros = state["in_scale"], state["in_shift"]
        else:
            cin = x.shape[-1]
            ones = torch.ones((cin,), dtype=torch.float32, device=x.device)
            zeros = torch.zeros((cin,), dtype=torch.float32, device=x.device)
        rows = lambda y: y.numel() // y.shape[-1]

        # W1/Wds take the block input as it is (norm_in=False); inference
        # normalizes with running statistics, so no conv needs its stats
        y1, st1 = conv(x, params["W1"], ones, zeros, False, False,
                       self.stride, want_stats=train)
        s1, b1 = bn_form("bn1", st1, rows(y1))
        y2, st2 = conv(y1, params["W2"], s1, b1, True, True, 1,
                       want_stats=train)
        s2, b2 = bn_form("bn2", st2, rows(y2))
        y3, st3 = conv(y2, params["W3"], s2, b2, True, True, 1,
                       want_stats=train)
        s3, b3 = bn_form("bn3", st3, rows(y3))

        # tail normalize + add + ReLU in the compute dtype, on (M, C) views
        f4 = y3.shape[-1]
        out_shape = y3.shape
        dt = y3.dtype
        main = y3.reshape(-1, f4) * s3.to(dt) + b3.to(dt)
        if self.downsample:
            yds, stds = conv(x, params["Wds"], ones, zeros, False, False,
                             self.stride, want_stats=train)
            sds, bds = bn_form("bnds", stds, rows(yds))
            shortcut = yds.reshape(-1, f4) * sds.to(dt) + bds.to(dt)
        else:
            shortcut = x.reshape(-1, f4)
        out = torch.relu(main + shortcut).to(x.dtype)
        return out.reshape(out_shape), new_state
