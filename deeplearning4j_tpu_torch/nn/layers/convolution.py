"""Convolutional layer family (NHWC).

The JAX package's ``nn/layers/convolution.py``: ``ConvolutionLayer``,
``SeparableConvolution2D``, ``Deconvolution2D``, ``SubsamplingLayer``,
``Upsampling2D``, ``ZeroPaddingLayer``, ``Cropping2D``,
``SpaceToDepthLayer``, ``SpaceToBatchLayer`` and the 1-D (N, T, F) family
``Convolution1DLayer``, ``Subsampling1DLayer``, ``Upsampling1D``,
``ZeroPadding1DLayer`` and ``Cropping1D``.
Activations stay NHWC (or NTF) and kernels HWIO (or HIO), as in the JAX
package; the plain torch ops here (``F.conv2d``, ``F.max_pool2d``) take
NCHW/OIHW, so each call permutes around them. ``ConvolutionMode.SAME``
pads exactly as XLA's 'SAME' does: the odd pixel goes to the
bottom/right. In training their gradients come from ``torch.autograd`` of
these plain ops, as the JAX package leaves them to XLA.
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
    RecurrentType,
)
from deeplearning4j_tpu_torch.nn.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.ops import tensor_split
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
        x = self.maybe_dropout(x, ctx)
        k, s, d, p = map(_pair, (self.kernel_size, self.stride, self.dilation,
                                 self.padding))
        (t, b), (l, r) = _pads(self.convolution_mode, x.shape[1:3], k, s, d,
                               p)
        # under tensor parallelism W may be an output- or input-channel
        # slice (ops/tensor_split.py); outside, these are identities
        x = tensor_split.copy_in(tensor_split.gather_in(x, "conv"), "conv")
        xp = F.pad(_nchw(x), (l, r, t, b))
        w = params["W"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        y = _nhwc(F.conv2d(xp, w, stride=s, dilation=d, groups=self.groups))
        y = tensor_split.reduce_out(y, "conv")
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise + pointwise conv (reference: SeparableConvolution2D): a
    depthwise conv of ``dW`` (kh, kw, 1, c_in·depth_multiplier) with one
    group per input channel (output channel ``g·dm + j`` from input
    channel g), then a 1×1 conv of ``pW`` (1, 1, c_in·dm, n_out)."""
    depth_multiplier: int = 1

    def initialize(self, generator, input_type):
        it = self._resolve_in(input_type)
        k = _pair(self.kernel_size)
        c_in, dm = it.channels, self.depth_multiplier
        dt = self.param_dtype()
        params = {
            "dW": self.weight_init.init(generator, (k[0], k[1], 1, c_in * dm),
                                        k[0] * k[1], dm, dt),
            "pW": self.weight_init.init(generator,
                                        (1, 1, c_in * dm, self.n_out),
                                        c_in * dm, self.n_out, dt),
        }
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def apply(self, params, state, x, ctx):
        x = self.maybe_dropout(x, ctx)
        k, s, d, p = map(_pair, (self.kernel_size, self.stride, self.dilation,
                                 self.padding))
        (t, b), (l, r) = _pads(self.convolution_mode, x.shape[1:3], k, s, d,
                               p)
        xp = F.pad(_nchw(x), (l, r, t, b))
        y = F.conv2d(xp, params["dW"].permute(3, 2, 0, 1), stride=s,
                     dilation=d, groups=x.shape[-1])
        y = _nhwc(F.conv2d(y, params["pW"].permute(3, 2, 0, 1)))
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution (reference: Deconvolution2D), as the JAX
    package computes it: a forward convolution of the stored HWIO ``W``
    (not flipped) over the input dilated by the stride (s - 1 zeros
    between pixels) and padded by k_eff - 1 - p a side (TRUNCATE/STRICT:
    out = s·(in - 1) + k_eff - 2p) or by s + k_eff - 2 split low-first
    (SAME: out = s·in). A negative pad crops."""

    def output_type(self, input_type: InputType) -> InputType:
        it = self._resolve_in(input_type)
        k, s, d, p = map(_pair, (self.kernel_size, self.stride, self.dilation,
                                 self.padding))
        if self.convolution_mode is ConvolutionMode.SAME:
            return ConvolutionalType(it.height * s[0], it.width * s[1],
                                     self.n_out)
        h, w = ((s[ax] * (size - 1) + (k[ax] - 1) * d[ax] + 1 - 2 * p[ax])
                for ax, size in enumerate((it.height, it.width)))
        return ConvolutionalType(h, w, self.n_out)

    def apply(self, params, state, x, ctx):
        x = self.maybe_dropout(x, ctx)
        k, s, d, p = map(_pair, (self.kernel_size, self.stride, self.dilation,
                                 self.padding))
        pads = []
        for ax in (0, 1):
            k_eff = (k[ax] - 1) * d[ax] + 1
            if self.convolution_mode is ConvolutionMode.SAME:
                total = s[ax] + k_eff - 2
                pads.append((total // 2, total - total // 2))
            else:
                pads.append((k_eff - 1 - p[ax], k_eff - 1 - p[ax]))
        xc = _nchw(x)
        n, c, h, w = xc.shape
        if s != (1, 1):
            xd = xc.new_zeros((n, c, (h - 1) * s[0] + 1, (w - 1) * s[1] + 1))
            xd[:, :, ::s[0], ::s[1]] = xc
            xc = xd
        (t, b), (l, r) = pads
        xc = F.pad(xc, (l, r, t, b))
        y = _nhwc(F.conv2d(xc, params["W"].permute(3, 2, 0, 1), dilation=d))
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
class Upsampling2D(Layer):
    """Nearest-neighbor upsampling (reference: Upsampling2D)."""
    size: Tuple[int, int] = (2, 2)

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        it = input_type
        s = _pair(self.size)
        return ConvolutionalType(it.height * s[0], it.width * s[1],
                                 it.channels)

    def apply(self, params, state, x, ctx):
        s = _pair(self.size)
        return x.repeat_interleave(s[0], 1).repeat_interleave(s[1], 2), state


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
class Cropping2D(Layer):
    """Spatial cropping (reference: convolutional/Cropping2D); crop =
    (top, bottom, left, right)."""
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        it = input_type
        t, b, l, r = self.crop
        return ConvolutionalType(it.height - t - b, it.width - l - r,
                                 it.channels)

    def apply(self, params, state, x, ctx):
        t, b, l, r = self.crop
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :], state


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


@register_serializable
@dataclasses.dataclass(frozen=True)
class SpaceToBatchLayer(Layer):
    """(reference: SpaceToBatchLayer). Spatial blocks into the batch axis;
    the new batch is ordered (bh, bw, n): row ``(a·bw + b)·N + n`` holds
    pixel (a, b) of every block of example n."""
    block_size: Tuple[int, int] = (2, 2)

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        it = input_type
        bh, bw = _pair(self.block_size)
        return ConvolutionalType(it.height // bh, it.width // bw, it.channels)

    def apply(self, params, state, x, ctx):
        n, h, w, c = x.shape
        bh, bw = _pair(self.block_size)
        x = x.reshape(n, h // bh, bh, w // bw, bw, c)
        x = x.permute(2, 4, 0, 1, 3, 5)
        return x.reshape(n * bh * bw, h // bh, w // bw, c), state


def _unknown(t) -> bool:
    return t is None or t == -1


@register_serializable
@dataclasses.dataclass(frozen=True)
class Convolution1DLayer(FeedForwardLayer):
    """1-D (temporal) convolution over (N, T, F) sequences (reference:
    Convolution1DLayer); W (k, n_in, n_out). SAME pads as XLA's 'SAME'
    whatever ``padding`` says; TRUNCATE/STRICT pad ``padding`` a side."""
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: ConvolutionMode = ConvolutionMode.SAME

    def output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, RecurrentType):
            raise ValueError("Convolution1DLayer needs recurrent input")
        t = input_type.timesteps
        if t is not None and t > 0:
            t = _out_dim(t, self.kernel_size, self.stride, self.dilation,
                         self.convolution_mode, self.padding)
        return RecurrentType(self.n_out, t)

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        dt = self.param_dtype()
        params = {"W": self.weight_init.init(
            generator, (self.kernel_size, n_in, self.n_out),
            n_in * self.kernel_size, self.n_out * self.kernel_size, dt)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dt)
        return params

    def apply(self, params, state, x, ctx):
        k, s, d = self.kernel_size, self.stride, self.dilation
        (lo, hi), _ = _pads(self.convolution_mode, (x.shape[1], 1), (k, 1),
                            (s, 1), (d, 1), (self.padding, 0))
        xc = F.pad(x.permute(0, 2, 1), (lo, hi))
        y = F.conv1d(xc, params["W"].permute(2, 1, 0), stride=s, dilation=d)
        y = y.permute(0, 2, 1)
        if self.has_bias:
            y = y + params["b"]
        return self.activation.apply(y), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(Layer):
    """1-D pooling over (N, T, F) sequences, VALID windows (reference:
    Subsampling1DLayer): MAX takes the window's largest value, AVG its
    mean, SUM and PNORM its sum (as the JAX package reduces them)."""
    kernel_size: int = 2
    stride: int = 2
    pooling_type: PoolingType = PoolingType.MAX

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None and t > 0:
            t = (t - self.kernel_size) // self.stride + 1
        return RecurrentType(input_type.size, t)

    def apply(self, params, state, x, ctx):
        win = x.unfold(1, self.kernel_size, self.stride)   # (N, T', F, k)
        if self.pooling_type is PoolingType.MAX:
            return win.amax(-1), state
        y = win.sum(-1)
        if self.pooling_type is PoolingType.AVG:
            y = y / self.kernel_size
        return y, state


@register_serializable
@dataclasses.dataclass(frozen=True)
class Upsampling1D(Layer):
    """Temporal repeat upsampling (reference: Upsampling1D)."""
    size: int = 2

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        return RecurrentType(input_type.size,
                             None if _unknown(t) else t * self.size)

    def apply(self, params, state, x, ctx):
        return x.repeat_interleave(self.size, 1), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class ZeroPadding1DLayer(Layer):
    """Temporal zero padding (reference: ZeroPadding1DLayer); pad =
    (before, after)."""
    pad: Tuple[int, int] = (0, 0)

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        return RecurrentType(input_type.size, None if _unknown(t)
                             else t + self.pad[0] + self.pad[1])

    def apply(self, params, state, x, ctx):
        return F.pad(x, (0, 0, self.pad[0], self.pad[1])), state


@register_serializable
@dataclasses.dataclass(frozen=True)
class Cropping1D(Layer):
    """Temporal cropping (reference: convolutional/Cropping1D); crop =
    (before, after)."""
    crop: Tuple[int, int] = (0, 0)

    @property
    def has_params(self):
        return False

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        return RecurrentType(input_type.size, None if _unknown(t)
                             else t - self.crop[0] - self.crop[1])

    def apply(self, params, state, x, ctx):
        lo, hi = self.crop
        return x[:, lo:x.shape[1] - hi, :], state
