"""Convolutional layer family (NHWC).

The layers of the JAX package's ``nn/layers/convolution.py`` that the
served ResNet50 runs: ``ConvolutionLayer`` (the stem), ``SubsamplingLayer``
(the max pool), ``ZeroPaddingLayer`` and ``SpaceToDepthLayer``.
Activations stay NHWC and kernels HWIO, as in the JAX package; the plain
torch ops here (``F.conv2d``, ``F.max_pool2d``) take NCHW/OIHW, so each
call permutes around them. ``ConvolutionMode.SAME`` pads exactly as XLA's
'SAME' does: the odd pixel goes to the bottom/right.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.inputs import (
    ConvolutionalFlatType,
    ConvolutionalType,
    InputType,
)
from deeplearning4j_tpu_torch.nn.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.utils.serde import (register_enum,
                                                  register_serializable)


@register_enum
class ConvolutionMode(enum.Enum):
    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


@register_enum
class PoolingType(enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_dim(size: int, k: int, s: int, d: int, mode: ConvolutionMode,
             pad: int) -> int:
    eff_k = (k - 1) * d + 1
    if mode is ConvolutionMode.SAME:
        return -(-size // s)  # ceil
    out = (size + 2 * pad - eff_k) // s + 1
    if mode is ConvolutionMode.STRICT and (size + 2 * pad - eff_k) % s != 0:
        raise ValueError(
            f"ConvolutionMode.STRICT: (size={size} + 2*pad={pad} - k_eff={eff_k})"
            f" not divisible by stride={s}; use TRUNCATE or SAME"
        )
    return out


def _pads(mode: ConvolutionMode, size_hw, k, s, d, p):
    """((top, bottom), (left, right)) padding of one conv/pool window."""
    if mode is not ConvolutionMode.SAME:
        return (p[0], p[0]), (p[1], p[1])
    out = []
    for ax in (0, 1):
        n_out = -(-size_hw[ax] // s[ax])
        eff_k = (k[ax] - 1) * d[ax] + 1
        total = max((n_out - 1) * s[ax] + eff_k - size_hw[ax], 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


@register_serializable
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(FeedForwardLayer):
    """2D convolution (reference: nn/conf/layers/ConvolutionLayer)."""
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    groups: int = 1

    def _resolve_in(self, input_type: InputType) -> ConvolutionalType:
        if isinstance(input_type, ConvolutionalFlatType):
            input_type = input_type.unflatten()
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(f"{type(self).__name__} needs convolutional input,"
                             f" got {input_type}")
        return input_type

    def output_type(self, input_type: InputType) -> InputType:
        it = self._resolve_in(input_type)
        k, s, d, p = map(_pair, (self.kernel_size, self.stride, self.dilation,
                                 self.padding))
        h = _out_dim(it.height, k[0], s[0], d[0], self.convolution_mode, p[0])
        w = _out_dim(it.width, k[1], s[1], d[1], self.convolution_mode, p[1])
        return ConvolutionalType(h, w, self.n_out)

    def initialize(self, generator, input_type):
        it = self._resolve_in(input_type)
        k = _pair(self.kernel_size)
        c_in = it.channels
        fan_in = (c_in // self.groups) * k[0] * k[1]
        fan_out = (self.n_out // self.groups) * k[0] * k[1]
        dt = self.param_dtype()
        params = {"W": self.weight_init.init(
            generator, (k[0], k[1], c_in // self.groups, self.n_out),
            fan_in, fan_out, dt)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def apply(self, params, state, x, ctx):
        self.check_inference(ctx)
        k, s, d, p = map(_pair, (self.kernel_size, self.stride, self.dilation,
                                 self.padding))
        (t, b), (l, r) = _pads(self.convolution_mode, x.shape[1:3], k, s, d,
                               p)
        xp = F.pad(_nchw(x), (l, r, t, b))
        w = params["W"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        y = _nhwc(F.conv2d(xp, w, stride=s, dilation=d, groups=self.groups))
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    """Spatial pooling (reference: SubsamplingLayer). MAX pads with -inf,
    as ``lax.reduce_window`` with a -inf init does."""
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    pooling_type: PoolingType = PoolingType.MAX
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, ConvolutionalFlatType):
            input_type = input_type.unflatten()
        it = input_type
        k, s, p = map(_pair, (self.kernel_size, self.stride, self.padding))
        h = _out_dim(it.height, k[0], s[0], 1, self.convolution_mode, p[0])
        w = _out_dim(it.width, k[1], s[1], 1, self.convolution_mode, p[1])
        return ConvolutionalType(h, w, it.channels)

    def apply(self, params, state, x, ctx):
        k, s, p = map(_pair, (self.kernel_size, self.stride, self.padding))
        (t, b), (l, r) = _pads(self.convolution_mode, x.shape[1:3], k,
                               s, (1, 1), p)
        xc = _nchw(x)

        def window_sum(v):
            v = F.pad(v, (l, r, t, b))
            return F.avg_pool2d(v, k, s, divisor_override=1)

        pt = self.pooling_type
        if pt is PoolingType.MAX:
            xp = F.pad(xc, (l, r, t, b), value=float("-inf"))
            return _nhwc(F.max_pool2d(xp, k, s)), state
        if pt is PoolingType.SUM:
            return _nhwc(window_sum(xc)), state
        if pt is PoolingType.AVG:
            if self.convolution_mode is ConvolutionMode.SAME:
                return _nhwc(window_sum(xc)
                             / window_sum(torch.ones_like(xc))), state
            return _nhwc(window_sum(xc) / (k[0] * k[1])), state
        if pt is PoolingType.PNORM:
            pn = float(self.pnorm)
            return _nhwc(window_sum(xc.abs() ** pn) ** (1.0 / pn)), state
        raise ValueError(pt)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(Layer):
    """Zero padding (reference: ZeroPaddingLayer). pad = (top, bottom,
    left, right)."""
    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        it = input_type
        t, b, l, r = self.pad
        return ConvolutionalType(it.height + t + b, it.width + l + r,
                                 it.channels)

    def apply(self, params, state, x, ctx):
        t, b, l, r = self.pad
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class SpaceToDepthLayer(Layer):
    """(reference: SpaceToDepthLayer). NHWC space-to-depth; the channel
    slot of pixel (a, b) of a block is ``(a * block + b) * C + c``."""
    block_size: int = 2

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        it = input_type
        b = self.block_size
        return ConvolutionalType(it.height // b, it.width // b,
                                 it.channels * b * b)

    def apply(self, params, state, x, ctx):
        n, h, w, c = x.shape
        b = self.block_size
        x = x.reshape(n, h // b, b, w // b, b, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c), state
