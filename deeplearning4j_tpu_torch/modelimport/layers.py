"""Keras layer → framework layer converters.

The port of the JAX package's ``modelimport/layers.py``: the same
registry, converters, weight mappings and refusals, built on the port's
layer and vertex classes. The mappings work on numpy arrays;
``keras.py`` copies their results into the model's tensors.

Analog of the reference's per-Keras-layer converter classes
(deeplearning4j-modelimport/.../layers/{core,convolutional,pooling,
recurrent,embeddings,normalization,noise}/ and KerasLayer.java:42) plus
the custom-layer registry (KerasLayer.registerCustomLayer:150).

Each converter takes the Keras layer ``config`` dict (+ keras major
version) and returns a ``Converted`` record: our layer/vertex (or a skip
marker for shape-only layers like Flatten — shape adaptation is handled
by this framework's auto-inserted preprocessors), and a ``weights``
function mapping the layer's Keras weight dict to (params, state) trees.

Weight-layout notes (Keras TF backend → this framework, both NHWC):
  Dense kernel [in,out]           → W [in,out]        (identical)
  Conv2D kernel HWIO              → W HWIO            (identical)
  LSTM gate order  i,f,g,o        → ours i,f,o,g      (column permute)
  BatchNorm moving stats          → model_state mean/var
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer,
    ConvolutionMode,
    Convolution1DLayer,
    Cropping2D,
    Deconvolution2D,
    PoolingType,
    SeparableConvolution2D,
    SpaceToDepthLayer,
    SubsamplingLayer,
    Subsampling1DLayer,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.dropout import (
    AlphaDropout as SeluAlphaDropout,
    GaussianDropout as GaussianDropoutNoise,
    GaussianNoise as AdditiveGaussianNoise,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingSequenceLayer,
    PermuteLayer,
    ReshapeLayer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
    LayerNormalization,
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.output import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    Bidirectional,
    LastTimeStep,
    LSTM,
    SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.graph.vertices import (
    ElementWiseVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.ops.activations import Activation

WeightsFn = Callable[[Dict[str, np.ndarray]], Tuple[dict, dict]]


@dataclasses.dataclass
class Converted:
    layer: Optional[object] = None        # a Layer config
    vertex: Optional[object] = None       # a GraphVertex (merge nodes)
    skip: bool = False                    # shape-only; drop from topology
    weights: Optional[WeightsFn] = None
    # activation the Keras layer carries inline; the final-layer importer
    # uses it to pick the output loss
    activation: Optional[Activation] = None


# ---- helpers -------------------------------------------------------------

_ACTIVATIONS = {
    "linear": Activation.IDENTITY,
    "relu": Activation.RELU,
    "relu6": Activation.RELU6,
    "elu": Activation.ELU,
    "selu": Activation.SELU,
    "gelu": Activation.GELU,
    "sigmoid": Activation.SIGMOID,
    "hard_sigmoid": Activation.HARDSIGMOID,
    "tanh": Activation.TANH,
    "softmax": Activation.SOFTMAX,
    "softplus": Activation.SOFTPLUS,
    "softsign": Activation.SOFTSIGN,
    "swish": Activation.SWISH,
    "silu": Activation.SWISH,
    "mish": Activation.MISH,
    "thresholded_relu": Activation.THRESHOLDEDRELU,
}


def map_activation(name: str) -> Activation:
    if name in ("leaky_relu", "LeakyReLU"):
        # Keras 3's fused string defaults to negative_slope=0.2; the
        # fused Activation.LEAKYRELU enum is fixed at the reference's
        # 0.01 default — importing would be silently wrong on every
        # negative pre-activation. The standalone LeakyReLU LAYER
        # carries its slope and imports exactly.
        raise ValueError(
            "unsupported fused activation 'leaky_relu' (its slope is "
            "not representable in the fused activation enum); use a "
            "standalone keras.layers.LeakyReLU layer instead")
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported Keras activation {name!r}")
    return _ACTIVATIONS[name]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _conv_mode(border: str) -> Tuple[ConvolutionMode, Tuple[int, int]]:
    if border == "same":
        return ConvolutionMode.SAME, (0, 0)
    return ConvolutionMode.TRUNCATE, (0, 0)


def _dense_weights(w: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params = {}
    if "kernel" in w:
        params["W"] = w["kernel"]
    elif "W" in w:
        params["W"] = w["W"]
    if "bias" in w:
        params["b"] = w["bias"]
    elif "b" in w:
        params["b"] = w["b"]
    return params, {}


def _bn_weights(w: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params = {}
    if "gamma" in w:
        params["gamma"] = w["gamma"]
    if "beta" in w:
        params["beta"] = w["beta"]
    state = {}
    if "moving_mean" in w:
        state["mean"] = w["moving_mean"]
    if "moving_variance" in w:
        state["var"] = w["moving_variance"]
    return params, state


def _lstm_permute(k: np.ndarray) -> np.ndarray:
    """Keras packs gates [i, f, g(c), o]; ours are [i, f, o, g]."""
    h = k.shape[-1] // 4
    i, f, g, o = (k[..., :h], k[..., h:2 * h],
                  k[..., 2 * h:3 * h], k[..., 3 * h:])
    return np.concatenate([i, f, o, g], axis=-1)


def _lstm_weights(w: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params = {}
    if "kernel" in w:
        params["Wx"] = _lstm_permute(w["kernel"])
    if "recurrent_kernel" in w:
        params["Wh"] = _lstm_permute(w["recurrent_kernel"])
    if "bias" in w:
        params["b"] = _lstm_permute(w["bias"])
    if "W_i" in w:
        # genuine Keras-1 layout: one matrix per gate (lstm_1_W_i /
        # U_i / b_i, ...); Keras gate letters i,f,c,o → our order i,f,o,c
        params["Wx"] = np.concatenate(
            [w["W_i"], w["W_f"], w["W_o"], w["W_c"]], axis=-1)
        params["Wh"] = np.concatenate(
            [w["U_i"], w["U_f"], w["U_o"], w["U_c"]], axis=-1)
        if "b_i" in w:
            params["b"] = np.concatenate(
                [w["b_i"], w["b_f"], w["b_o"], w["b_c"]], axis=-1)
    return params, {}


def _sep_conv_weights(w: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params = {}
    if "depthwise_kernel" in w:
        # Keras (kh, kw, c_in, dm) → our grouped-conv HWIO (kh, kw, 1,
        # c_in*dm)
        dk = w["depthwise_kernel"]
        kh, kw, cin, dm = dk.shape
        params["dW"] = dk.reshape(kh, kw, 1, cin * dm)
    if "pointwise_kernel" in w:
        params["pW"] = w["pointwise_kernel"]
    if "bias" in w:
        params["b"] = w["bias"]
    return params, {}


# ---- converters ----------------------------------------------------------

def _conv_common(cfg: dict) -> dict:
    mode, pad = _conv_mode(cfg.get("padding", cfg.get("border_mode",
                                                      "valid")))
    return dict(
        n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
        kernel_size=_pair(cfg.get("kernel_size",
                                  (cfg.get("nb_row", 1),
                                   cfg.get("nb_col", 1)))),
        stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
        dilation=_pair(cfg.get("dilation_rate", (1, 1))),
        convolution_mode=mode, padding=pad,
        has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))),
    )


def conv2d(cfg, _v):
    act = map_activation(cfg.get("activation", "linear"))
    return Converted(
        layer=ConvolutionLayer(activation=act, **_conv_common(cfg)),
        weights=_dense_weights, activation=act)


def separable_conv2d(cfg, _v):
    act = map_activation(cfg.get("activation", "linear"))
    common = _conv_common(cfg)
    return Converted(
        layer=SeparableConvolution2D(
            activation=act, depth_multiplier=int(
                cfg.get("depth_multiplier", 1)), **common),
        weights=_sep_conv_weights, activation=act)


def _deconv_weights(w: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """Keras stores transpose-conv kernels (kh, kw, OUT, IN) in the
    FORWARD-conv orientation (Conv2DTranspose is the gradient of a
    correlation); our Deconvolution2D is a plain correlation on the
    input-dilated tensor, so the kernel maps with the io axes swapped
    AND a spatial rot180 (caught by the k3_conv e2e fixture — unit
    tests never ran real Keras bytes through this path)."""
    params, state = _dense_weights(w)
    if "W" in params and params["W"].ndim == 4:
        params["W"] = np.transpose(params["W"],
                                   (0, 1, 3, 2))[::-1, ::-1].copy()
    return params, state


def conv2d_transpose(cfg, _v):
    act = map_activation(cfg.get("activation", "linear"))
    return Converted(
        layer=Deconvolution2D(activation=act, **_conv_common(cfg)),
        weights=_deconv_weights, activation=act)


def conv1d(cfg, _v):
    """Conv1D / Convolution1D, and Keras-1 AtrousConvolution1D (which
    differs only in carrying dilation as ``atrous_rate`` — reference:
    KerasAtrousConvolution1D.java)."""
    act = map_activation(cfg.get("activation", "linear"))
    mode, _pad = _conv_mode(cfg.get("padding", cfg.get("border_mode",
                                                       "valid")))
    return Converted(
        layer=Convolution1DLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
            kernel_size=int(_first(cfg.get("kernel_size",
                                           cfg.get("filter_length", 1)))),
            stride=int(_first(cfg.get("strides",
                                      cfg.get("subsample_length", 1)))),
            dilation=int(_first(cfg.get("atrous_rate",
                                        cfg.get("dilation_rate", 1)))),
            convolution_mode=mode, activation=act,
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True)))),
        weights=_dense_weights, activation=act)


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def dense(cfg, _v):
    act = map_activation(cfg.get("activation", "linear"))
    return Converted(
        layer=DenseLayer(
            n_out=int(cfg.get("units", cfg.get("output_dim", 0))),
            activation=act,
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True)))),
        weights=_dense_weights, activation=act)


def _pool(cfg, ptype) -> SubsamplingLayer:
    mode, _ = _conv_mode(cfg.get("padding", cfg.get("border_mode",
                                                    "valid")))
    k = _pair(cfg.get("pool_size", (2, 2)))
    return SubsamplingLayer(
        kernel_size=k, stride=_pair(cfg.get("strides") or k),
        pooling_type=ptype, convolution_mode=mode)


def max_pool2d(cfg, _v):
    return Converted(layer=_pool(cfg, PoolingType.MAX))


def avg_pool2d(cfg, _v):
    return Converted(layer=_pool(cfg, PoolingType.AVG))


def max_pool1d(cfg, _v):
    k = int(_first(cfg.get("pool_size", cfg.get("pool_length", 2))))
    return Converted(layer=Subsampling1DLayer(
        kernel_size=k, stride=int(_first(cfg.get("strides") or k)),
        pooling_type=PoolingType.MAX))


def global_pool(ptype):
    def conv(cfg, _v):
        return Converted(layer=GlobalPoolingLayer(pooling_type=ptype))
    return conv


def batchnorm(cfg, _v):
    return Converted(
        layer=BatchNormalization(
            decay=float(cfg.get("momentum", 0.99)),
            eps=float(cfg.get("epsilon", 1e-3))),
        weights=_bn_weights)


def activation(cfg, _v):
    name = cfg["activation"]
    if name in ("leaky_relu", "LeakyReLU"):
        # the STANDALONE Activation layer can carry the slope exactly
        # (ActivationLayer.alpha) — only the fused-in-Dense string form
        # is unrepresentable (map_activation rejects it)
        return Converted(
            layer=ActivationLayer(activation=Activation.LEAKYRELU,
                                  alpha=float(cfg.get("negative_slope",
                                                      0.2))),
            activation=Activation.LEAKYRELU)
    act = map_activation(name)
    return Converted(layer=ActivationLayer(activation=act), activation=act)


def leaky_relu(cfg, _v):
    """Keras 1/2 carry the slope as ``alpha`` (default 0.3), Keras 3 as
    ``negative_slope`` — dropped entirely before the k3_conv fixture
    caught the 0.3-vs-0.01 divergence."""
    alpha = float(cfg.get("negative_slope", cfg.get("alpha", 0.3)))
    return Converted(layer=ActivationLayer(activation=Activation.LEAKYRELU,
                                           alpha=alpha),
                     activation=Activation.LEAKYRELU)


def dropout(cfg, _v):
    return Converted(layer=DropoutLayer(
        dropout=float(cfg.get("rate", cfg.get("p", 0.5)))))


def embedding(cfg, _v):
    return Converted(
        layer=EmbeddingSequenceLayer(
            n_in=int(cfg.get("input_dim", 0)),
            n_out=int(cfg.get("output_dim", 0))),
        weights=lambda w: ({"W": w.get("embeddings",
                                       next(iter(w.values())))}, {}))


def lstm(cfg, _v):
    act = map_activation(cfg.get("activation", "tanh"))
    gate = map_activation(cfg.get("recurrent_activation",
                                  cfg.get("inner_activation",
                                          "hard_sigmoid")))
    layer = LSTM(n_out=int(cfg.get("units", cfg.get("output_dim", 0))),
                 activation=act, gate_activation=gate)
    if not cfg.get("return_sequences", False):
        layer = LastTimeStep(inner=layer)
        return Converted(layer=layer,
                         weights=lambda w: (_lstm_weights(w)[0], {}))
    return Converted(layer=layer, weights=_lstm_weights)


def simple_rnn(cfg, _v):
    act = map_activation(cfg.get("activation", "tanh"))
    layer = SimpleRnn(n_out=int(cfg.get("units", cfg.get("output_dim", 0))),
                      activation=act)
    def wfn(w):
        params = {}
        if "kernel" in w:
            params["Wx"] = w["kernel"]
        if "recurrent_kernel" in w:
            params["Wh"] = w["recurrent_kernel"]
        if "bias" in w:
            params["b"] = w["bias"]
        return params, {}
    if not cfg.get("return_sequences", False):
        return Converted(layer=LastTimeStep(inner=layer), weights=wfn)
    return Converted(layer=layer, weights=wfn)


def flatten(cfg, _v):
    """Real flatten (ReshapeLayer to 1-D), not a skip: skipping only
    works when the next layer's n_in inference collapses the shape the
    same way, which is true after convs (Cnn→FF preprocessor) but WRONG
    after recurrent/2-D tensors — a Dense after a skipped Flatten of
    (T, F) silently became per-timestep (caught by the k3_merges
    fixture). Row-major like Keras."""
    return Converted(layer=ReshapeLayer(shape=(-1,)))


def reshape(cfg, _v):
    """Keras Reshape honoring target_shape (reference: KerasReshape.java:40
    materializes the target shape — never a silent skip)."""
    target = cfg.get("target_shape")
    if not target:
        raise ValueError("Reshape layer missing target_shape")
    return Converted(layer=ReshapeLayer(shape=tuple(int(d) for d in target)))


def permute(cfg, _v):
    """Keras Permute: real axis transpose of the non-batch dims
    (1-indexed, reference: KerasPermute.java)."""
    dims = cfg.get("dims")
    if not dims:
        raise ValueError("Permute layer missing dims")
    return Converted(layer=PermuteLayer(dims=tuple(int(d) for d in dims)))


def gaussian_noise(cfg, _v):
    """Additive gaussian noise — NOT a dropout (the two regularize
    differently at train time; reference: KerasGaussianNoise.java maps to
    conf/dropout/GaussianNoise)."""
    return Converted(layer=DropoutLayer(
        dropout=AdditiveGaussianNoise(stddev=float(cfg.get("stddev",
                                                           cfg.get("sigma",
                                                                   0.1))))))


def gaussian_dropout(cfg, _v):
    """Multiplicative N(1, rate/(1-rate)) noise (reference:
    KerasGaussianDropout.java → conf/dropout/GaussianDropout)."""
    return Converted(layer=DropoutLayer(
        dropout=GaussianDropoutNoise(rate=float(cfg.get("rate",
                                                        cfg.get("p",
                                                                0.5))))))


def alpha_dropout(cfg, _v):
    """SELU-preserving dropout (reference: KerasAlphaDropout.java →
    conf/dropout/AlphaDropout). Keras' rate is the drop probability,
    same convention as our AlphaDropout.p."""
    return Converted(layer=DropoutLayer(
        dropout=SeluAlphaDropout(p=float(cfg.get("rate", cfg.get("p",
                                                                 0.05))))))


def input_layer(cfg, _v):
    return Converted(skip=True)


def zero_padding2d(cfg, _v):
    p = cfg.get("padding", (1, 1))
    if isinstance(p, (list, tuple)) and p and isinstance(p[0],
                                                         (list, tuple)):
        (pt, pb), (pl, pr) = p
    else:
        (pt, pb) = (pl, pr) = _pair(p)
    return Converted(layer=ZeroPaddingLayer(
        pad=(int(pt), int(pb), int(pl), int(pr))))


def cropping2d(cfg, _v):
    c = cfg.get("cropping", ((0, 0), (0, 0)))
    if isinstance(c[0], (list, tuple)):
        (ct, cb), (cl, cr) = c
    else:
        (ct, cb) = (cl, cr) = _pair(c)
    return Converted(layer=Cropping2D(
        crop=(int(ct), int(cb), int(cl), int(cr))))


def upsampling2d(cfg, _v):
    return Converted(layer=Upsampling2D(size=_pair(cfg.get("size",
                                                           (2, 2)))))


def atrous_conv2d(cfg, _v):
    """Keras-1 AtrousConvolution2D: a Conv2D whose dilation comes from
    ``atrous_rate`` (reference: KerasAtrousConvolution2D.java)."""
    act = map_activation(cfg.get("activation", "linear"))
    common = _conv_common(cfg)
    common["dilation"] = _pair(cfg.get("atrous_rate", (1, 1)))
    return Converted(
        layer=ConvolutionLayer(activation=act, **common),
        weights=_dense_weights, activation=act)


def zero_padding1d(cfg, _v):
    p = cfg.get("padding", 1)
    if isinstance(p, (list, tuple)):
        lo, hi = int(p[0]), int(p[1])
    else:
        lo = hi = int(p)
    return Converted(layer=ZeroPadding1DLayer(pad=(lo, hi)))


def upsampling1d(cfg, _v):
    # Keras 2: "size"; Keras 1: "length"
    return Converted(layer=Upsampling1D(
        size=int(cfg.get("size", cfg.get("length", 2)))))


def space_to_depth(cfg, _v):
    """tf.nn.space_to_depth wrapper layer used by YOLO-family models
    (reference: KerasSpaceToDepth.java)."""
    return Converted(layer=SpaceToDepthLayer(
        block_size=int(cfg.get("block_size", 2))))


def lrn(cfg, _v):
    """Community LRN layer from GoogLeNet-era Keras models (reference:
    custom/KerasLRN.java — registered, not built-in)."""
    return Converted(layer=LocalResponseNormalization(
        k=float(cfg.get("k", 2.0)), n=int(cfg.get("n", 5)),
        alpha=float(cfg.get("alpha", 1e-4)),
        beta=float(cfg.get("beta", 0.75))))


def pool_helper(cfg, _v):
    """GoogLeNet PoolHelper: strips the first row and column to mimic
    caffe's asymmetric pooling (reference: custom/KerasPoolHelper.java →
    PoolHelperVertex)."""
    return Converted(layer=Cropping2D(crop=(1, 0, 1, 0)))


def merge_add(cfg, _v):
    return Converted(vertex=ElementWiseVertex(op="add"))


def merge_sub(cfg, _v):
    return Converted(vertex=ElementWiseVertex(op="subtract"))


def merge_mul(cfg, _v):
    return Converted(vertex=ElementWiseVertex(op="product"))


def merge_avg(cfg, _v):
    return Converted(vertex=ElementWiseVertex(op="average"))


def merge_max(cfg, _v):
    return Converted(vertex=ElementWiseVertex(op="max"))


def concatenate(cfg, _v):
    return Converted(vertex=MergeVertex())


def bidirectional(cfg, v):
    inner_cfg = cfg["layer"]
    inner = convert_layer(inner_cfg["class_name"],
                          inner_cfg["config"], v)
    mode = {"concat": "concat", "sum": "add", "ave": "average",
            "mul": "mul"}.get(cfg.get("merge_mode", "concat"), "concat")
    inner_layer = inner.layer
    if isinstance(inner_layer, LastTimeStep):
        inner_layer = inner_layer.inner   # Bidirectional wraps the RNN itself
    layer = Bidirectional(fwd=inner_layer, mode=mode)

    def wfn(w):
        # direction-qualified keys ("forward_lstm/.../kernel") are the
        # only unambiguous ones — bare leaf aliases collide between
        # directions. Select per direction, then re-leaf for the inner
        # converter (which expects plain "kernel"/"recurrent_kernel").
        def select(tag, other):
            picked = {}
            for k, a in w.items():
                if tag in k and other not in k:
                    picked.setdefault(k.split("/")[-1], a)
            return picked
        fwd = select("forward", "backward")
        bwd = select("backward", "forward")
        fp, _ = inner.weights(fwd) if inner.weights and fwd else ({}, {})
        bp, _ = inner.weights(bwd) if inner.weights and bwd else ({}, {})
        if not fp or not bp:
            raise KeyError(
                "Bidirectional weights missing forward_/backward_ "
                f"qualified entries (available: {sorted(w)})")
        return {"fwd": fp, "bwd": bp}, {}
    return Converted(layer=layer, weights=wfn)


# ---- registry ------------------------------------------------------------

def softmax_layer(cfg, _v):
    axis = cfg.get("axis", -1)
    if axis not in (-1, None):
        raise ValueError(f"unsupported Softmax config: axis={axis} "
                         "(only the feature axis -1 is supported)")
    return Converted(layer=ActivationLayer(activation=Activation.SOFTMAX),
                     activation=Activation.SOFTMAX)


def elu_layer(cfg, _v):
    alpha = float(cfg.get("alpha", 1.0))
    return Converted(layer=ActivationLayer(activation=Activation.ELU,
                                           alpha=alpha),
                     activation=Activation.ELU)


def layer_norm(cfg, _v):
    axis = cfg.get("axis", -1)
    if axis not in (-1, [-1], None):
        raise ValueError(f"unsupported LayerNormalization config: "
                         f"axis={axis} (only the feature axis -1)")
    def _w(w):
        params = {}
        if "gamma" in w:
            params["gamma"] = w["gamma"]
        if "beta" in w:
            params["beta"] = w["beta"]
        return params, {}
    return Converted(
        layer=LayerNormalization(eps=float(cfg.get("epsilon", 1e-3))),
        weights=_w)


def multi_head_attention(cfg, _v):
    """Keras MultiHeadAttention → SelfAttentionLayer. Keras stores per-head
    projections query/key/value kernels [F, H, dh] and output kernel
    [H, dh, F]; ours packs QKV into one [F, 3E] matmul (E = H*dh)."""
    n_heads = int(cfg.get("num_heads", 1))
    key_dim = int(cfg.get("key_dim", 64))
    value_dim = cfg.get("value_dim")
    if value_dim is not None and int(value_dim) != key_dim:
        raise ValueError(
            f"unsupported MultiHeadAttention config: value_dim={value_dim}"
            f" != key_dim={key_dim} (packed-QKV layout needs equal dims)")
    if cfg.get("output_shape") is not None:
        raise ValueError("unsupported MultiHeadAttention config: "
                         "output_shape is not supported")
    axes = cfg.get("attention_axes")
    if isinstance(axes, (list, tuple)):
        axes = list(axes)
    # for rank-3 (N, T, F) input the sequence axis is 1 (== -2)
    if axes not in (None, 1, -2, [1], [-2]):
        raise ValueError(
            f"unsupported MultiHeadAttention config: attention_axes="
            f"{cfg['attention_axes']} (only default sequence-axis "
            "attention)")
    n_out = n_heads * key_dim

    def _w(w):
        def req(name):
            arr = w.get(f"{name}/kernel")
            if arr is None:
                raise KeyError(
                    f"MultiHeadAttention weights missing '{name}/kernel'"
                    f" (available: {sorted(w)})")
            return arr
        q, k, v, o = req("query"), req("key"), req("value"), \
            req("attention_output")
        f = q.shape[0]
        # Keras kernels are (f, h, dh); the framework packs QKV head-major
        # ((head, which, dh) column order — see SelfAttentionLayer) so that
        # tensor parallelism shards whole heads with contiguous tiles.
        def hm(a):
            return a.reshape(f, n_heads, key_dim)
        params = {"Wqkv": np.stack([hm(q), hm(k), hm(v)],
                                   axis=2).reshape(f, -1),
                  "Wo": o.reshape(-1, o.shape[-1])}
        def b2(name):
            return w.get(f"{name}/bias")
        bq, bk, bv = b2("query"), b2("key"), b2("value")
        bo = b2("attention_output")
        if bq is not None and bk is not None and bv is not None:
            params["bqkv"] = np.stack(
                [bq.reshape(n_heads, key_dim), bk.reshape(n_heads, key_dim),
                 bv.reshape(n_heads, key_dim)], axis=1).reshape(-1)
        if bo is not None:
            params["bo"] = bo.reshape(-1)
        return params, {}

    return Converted(
        layer=SelfAttentionLayer(n_out=n_out, n_heads=n_heads,
                                 activation=Activation.IDENTITY),
        weights=_w)


CONVERTERS: Dict[str, Callable[[dict, int], Converted]] = {
    "Dense": dense,
    "Conv2D": conv2d, "Convolution2D": conv2d,
    "SeparableConv2D": separable_conv2d,
    "SeparableConvolution2D": separable_conv2d,
    "Conv2DTranspose": conv2d_transpose,
    "Deconvolution2D": conv2d_transpose,
    "Conv1D": conv1d, "Convolution1D": conv1d,
    "MaxPooling2D": max_pool2d, "AveragePooling2D": avg_pool2d,
    "MaxPooling1D": max_pool1d,
    "GlobalMaxPooling2D": global_pool(PoolingType.MAX),
    "GlobalAveragePooling2D": global_pool(PoolingType.AVG),
    "GlobalMaxPooling1D": global_pool(PoolingType.MAX),
    "GlobalAveragePooling1D": global_pool(PoolingType.AVG),
    "BatchNormalization": batchnorm,
    "LayerNormalization": layer_norm,
    "MultiHeadAttention": multi_head_attention,
    "Softmax": softmax_layer,
    "ELU": elu_layer,
    "Activation": activation,
    "LeakyReLU": leaky_relu,
    "Dropout": dropout, "SpatialDropout2D": dropout,
    "GaussianDropout": gaussian_dropout, "GaussianNoise": gaussian_noise,
    "AlphaDropout": alpha_dropout,
    "Embedding": embedding,
    "LSTM": lstm,
    "SimpleRNN": simple_rnn,
    "Bidirectional": bidirectional,
    "Flatten": flatten, "Reshape": reshape, "Permute": permute,
    "InputLayer": input_layer, "Input": input_layer,
    "ZeroPadding2D": zero_padding2d,
    "ZeroPadding1D": zero_padding1d,
    "Cropping2D": cropping2d,
    "UpSampling2D": upsampling2d,
    "UpSampling1D": upsampling1d,
    "AtrousConvolution2D": atrous_conv2d,
    "AtrousConvolution1D": conv1d,
    "SpaceToDepth": space_to_depth,
    # GoogLeNet-era community layers — the reference requires
    # registerCustomLayer for these; we ship them built-in
    "LRN": lrn, "LRN2D": lrn,
    "PoolHelper": pool_helper,
    "Add": merge_add, "add": merge_add,
    "Subtract": merge_sub, "subtract": merge_sub,
    "Multiply": merge_mul, "multiply": merge_mul,
    "Average": merge_avg, "average": merge_avg,
    "Maximum": merge_max, "maximum": merge_max,
    "Concatenate": concatenate, "concatenate": concatenate,
    "Merge": None,  # resolved by mode in keras.py (Keras 1)
}

_CUSTOM: Dict[str, Callable[[dict, int], Converted]] = {}


def register_custom_layer(class_name: str,
                          converter: Callable[[dict, int], Converted]):
    """Custom-layer hook (reference: KerasLayer.registerCustomLayer:150)."""
    _CUSTOM[class_name] = converter


def convert_layer(class_name: str, cfg: dict, keras_version: int
                  ) -> Converted:
    if class_name in _CUSTOM:
        return _CUSTOM[class_name](cfg, keras_version)
    conv = CONVERTERS.get(class_name)
    if conv is None and class_name == "Merge":
        mode = cfg.get("mode", "concat")
        conv = {"concat": concatenate, "sum": merge_add,
                "mul": merge_mul, "ave": merge_avg,
                "max": merge_max}.get(mode)
    if conv is None:
        raise ValueError(
            f"unsupported Keras layer {class_name!r}; register a converter "
            "with modelimport.register_custom_layer()")
    return conv(cfg, keras_version)
