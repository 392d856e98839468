"""Model zoo: the JAX package's ``zoo/models.py``.

Its entries (reference: deeplearning4j-zoo/.../model/) with the same
fields, defaults and configurations (layer names, layer configs,
topology, and ``MultiLayerNetwork`` or ``ComputationGraph`` as there), so
configurations and checkpoints carry across:

- ``ResNet50``: the per-layer bottleneck graph (the default,
  ``fused_blocks=False``), or each bottleneck as one
  ``FusedBottleneckBlock`` whose convs go through the conv kernels
  (``fused_impl="pallas"``) or through plain convolutions with the
  statistics beside them (``fused_impl="xla"``); either stem;
- ``TextGenerationLSTM``, the char-level 2×LSTM(256) whose recurrences go
  through the fused LSTM kernels, with ``init_pretrained`` restoring the
  committed self-trained weights;
- ``LeNet`` and ``SimpleCNN``, with ``init_pretrained(flavor="digits")``
  restoring the committed digit models;
- ``VGG16``, ``VGG19``, ``AlexNet``, ``Darknet19``, ``TinyYOLO``,
  ``YOLO2``, ``GoogLeNet``, ``InceptionResNetV1`` and
  ``FaceNetNN4Small2``, from a seed (no pretrained weights).

Outside the fused block's "pallas" arm the layers are plain torch, as
the JAX package leaves them to XLA. ``init()`` builds on the card unless
``device="cpu"`` is passed, and raises without one.
"""

from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.vertices import (ElementWiseVertex,
                                                        L2NormalizeVertex,
                                                        MergeVertex,
                                                        ScaleVertex)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer,
    ConvolutionMode,
    PoolingType,
    SpaceToDepthLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (ActivationLayer,
                                                            DenseLayer,
                                                            DropoutLayer)
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization, LocalResponseNormalization)
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.layers.output import (CenterLossOutputLayer,
                                                       GlobalPoolingLayer,
                                                       LossLayer,
                                                       OutputLayer,
                                                       RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.optimize.updaters import (Adam, Nesterovs,
                                                       Updater)
from deeplearning4j_tpu_torch.utils.device import DeviceLike

# (filters, blocks, first stride) of the four bottleneck stages
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def fold_stem_weights(w7):
    """Fold 7×7/2 stem weights (7,7,C,O) HWIO into the exactly
    equivalent 4×4/1 space-to-depth parameterization (4,4,4C,O):
    ``Wf[ku, kv, (a·2+b)·C + c, o] = W7[2ku+a, 2kv+b, c, o]`` (zero
    where 2ku+a > 6), matching ``SpaceToDepthLayer(block_size=2)``'s
    (row, col, channel) packing."""
    w7 = np.asarray(w7)
    kh, kw, c, o = w7.shape
    wf = np.zeros((4, 4, 4 * c, o), w7.dtype)
    for ku in range(4):
        for a in range(2):
            u = 2 * ku + a
            if u >= kh:
                continue
            for kv in range(4):
                for b in range(2):
                    v = 2 * kv + b
                    if v >= kw:
                        continue
                    wf[ku, kv, (a * 2 + b) * c:(a * 2 + b + 1) * c] = \
                        w7[u, v]
    return wf


def unfuse_resnet50_params(params, state):
    """A fused-block ResNet50's (params, state) as the per-layer graph's
    (``fused_blocks=False``, same stem): block ``s{i}b{j}``'s W1/W2/W3/Wds
    become the ``_a``/``_b``/``_c``/``_ds`` convs (a 1×1's (Cin, Cout) as
    HWIO (1, 1, Cin, Cout)) and its bn1/bn2/bn3/bnds the matching BNs; the
    other layers carry over by name. Both forms compute the same function,
    so a model trained in one form runs in the other."""
    parts = (("a", "W1", "bn1"), ("b", "W2", "bn2"), ("c", "W3", "bn3"),
             ("ds", "Wds", "bnds"))
    p, s = {}, {}
    for name, lp in params.items():
        if "W1" not in lp:
            p[name], s[name] = lp, state.get(name, {})
            continue
        st = state[name]
        for conv, w, bn in parts:
            if w not in lp:
                continue
            wt = lp[w]
            p[f"{name}_{conv}_conv"] = {
                "W": wt.reshape((1, 1) + tuple(wt.shape)) if wt.ndim == 2
                else wt}
            p[f"{name}_{conv}_bn"] = {"gamma": lp[f"{bn}_gamma"],
                                      "beta": lp[f"{bn}_beta"]}
            s[f"{name}_{conv}_bn"] = {"mean": st[f"{bn}_mean"],
                                      "var": st[f"{bn}_var"]}
    return p, s


class _GraphZoo:
    def init(self, device: DeviceLike = None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()


class _ListZoo:
    def init(self, device: DeviceLike = None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()


@dataclasses.dataclass
class ResNet50(_GraphZoo):
    """reference: model/ResNet50.java — bottleneck-v1 ComputationGraph:
    stem → maxpool/2 → stages [3,4,6,3] → global avg pool → softmax.
    ``fused_blocks=False`` (the default) keeps each conv, BN and ReLU a
    layer of its own; ``fused_blocks=True`` makes each bottleneck one
    ``FusedBottleneckBlock`` of implementation ``fused_impl``."""
    num_classes: int = 200
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"
    updater: Updater = dataclasses.field(
        default_factory=lambda: Nesterovs(1e-2, 0.9))
    fused_blocks: bool = False
    fused_impl: str = "pallas"       # "pallas" (the kernels) or "xla"
    # space-to-depth stem: H×W×3 → H/2×W/2×12 and a 4×4/1 conv that is
    # exactly the 7×7/2 conv (fold_stem_weights maps the weights)
    s2d_stem: bool = False

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater)
             .compute_dtype(self.compute_dtype)
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def conv_bn(name, src, n_out, k, s, act=Activation.RELU):
            g.add_layer(f"{name}_conv", ConvolutionLayer(
                n_out=n_out, kernel_size=k, stride=s,
                convolution_mode=ConvolutionMode.SAME, has_bias=False,
                weight_init=WeightInit.HE_NORMAL,
                activation=Activation.IDENTITY), src)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
            if act is None:
                return f"{name}_bn"
            g.add_layer(f"{name}_act", ActivationLayer(activation=act),
                        f"{name}_bn")
            return f"{name}_act"

        def bottleneck(name, src, filters, stride, downsample):
            if self.fused_blocks:
                g.add_layer(name, FusedBottleneckBlock(
                    filters=filters, stride=stride, downsample=downsample,
                    impl=self.fused_impl), src)
                return name
            x = conv_bn(f"{name}_a", src, filters, (1, 1), (stride, stride))
            x = conv_bn(f"{name}_b", x, filters, (3, 3), (1, 1))
            x = conv_bn(f"{name}_c", x, filters * 4, (1, 1), (1, 1),
                        act=None)
            shortcut = (conv_bn(f"{name}_ds", src, filters * 4, (1, 1),
                                (stride, stride), act=None)
                        if downsample else src)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x,
                         shortcut)
            g.add_layer(f"{name}_out",
                        ActivationLayer(activation=Activation.RELU),
                        f"{name}_add")
            return f"{name}_out"

        if self.s2d_stem:
            # 7×7/2 SAME on (H, W, 3) is 4×4/1 VALID on the s2d tensor
            # padded (1, 2)×(1, 2)
            g.add_layer("s2d", SpaceToDepthLayer(block_size=2), "in")
            g.add_layer("s2d_pad", ZeroPaddingLayer(pad=(1, 2, 1, 2)), "s2d")
            g.add_layer("conv1_conv", ConvolutionLayer(
                n_out=64, kernel_size=(4, 4), stride=(1, 1),
                convolution_mode=ConvolutionMode.TRUNCATE,
                padding=(0, 0), has_bias=False,
                weight_init=WeightInit.HE_NORMAL,
                activation=Activation.IDENTITY), "s2d_pad")
            g.add_layer("conv1_bn", BatchNormalization(), "conv1_conv")
            g.add_layer("conv1_act",
                        ActivationLayer(activation=Activation.RELU),
                        "conv1_bn")
            x = "conv1_act"
        else:
            x = conv_bn("conv1", "in", 64, (7, 7), (2, 2))
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), x)
        x = "pool1"
        for si, (filters, blocks, first_stride) in enumerate(STAGES):
            for bi in range(blocks):
                x = bottleneck(f"s{si}b{bi}", x, filters,
                               first_stride if bi == 0 else 1, bi == 0)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       loss=LossFunction.MCXENT,
                                       activation=Activation.SOFTMAX),
                    "avgpool")
        g.set_outputs("out")
        return g.build()


# the committed zoo artifacts, read as data by their paths in the repository
WEIGHTS_DIR = (Path(__file__).resolve().parents[2] / "deeplearning4j_tpu" /
               "zoo" / "weights")


def adler32(path) -> int:
    v = 1
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            v = zlib.adler32(chunk, v)
    return v


def pretrained_path(resource: str, checksum: int) -> Path:
    """The committed artifact ``resource`` under ``WEIGHTS_DIR`` after
    checking its Adler32 checksum (reference: ZooModel.initPretrained:51;
    the JAX package's resource path). Nothing is downloaded."""
    path = WEIGHTS_DIR / resource
    if not path.exists():
        raise FileNotFoundError(f"pretrained resource missing: {path}")
    v = adler32(path)
    if v != checksum:
        raise IOError(f"pretrained resource {resource}: Adler32 {v} != "
                      f"expected {checksum}")
    return path


class _DigitsZoo(_ListZoo):
    """``init`` and ``init_pretrained`` of the zoo's digit models."""
    PRETRAINED: dict = {}

    def init_pretrained(self, path: Optional[str] = None,
                        flavor: str = "digits",
                        device: DeviceLike = None) -> MultiLayerNetwork:
        """Restore the committed ``flavor`` checkpoint (Adler32-checked),
        or the zip at ``path``; the checkpoint's configuration defines
        the restored network."""
        from deeplearning4j_tpu_torch.models.serialization import \
            restore_multi_layer_network
        if path is None:
            if flavor not in self.PRETRAINED:
                raise FileNotFoundError(
                    f"{type(self).__name__}: no pretrained flavor "
                    f"{flavor!r}; pass path= to a local checkpoint zip")
            spec = self.PRETRAINED[flavor]
            path = pretrained_path(spec["resource"], spec["checksum"])
        return restore_multi_layer_network(str(path), device=device)


@dataclasses.dataclass
class LeNet(_DigitsZoo):
    """reference: deeplearning4j-zoo/.../model/LeNet.java — conv 20 and
    50 of 5×5 with 2×2 max pools, dense 500, softmax; 431,080 parameters
    at 28×28×1 and 10 classes. ``PRETRAINED["digits"]`` is the committed
    self-trained checkpoint (≥98% on the held-out UCI digits)."""
    PRETRAINED = {"digits": {"resource": "lenet_digits.zip",
                             "checksum": 2574425481}}
    num_classes: int = 10
    height: int = 28
    width: int = 28
    channels: int = 1
    updater: Updater = dataclasses.field(default_factory=lambda: Adam(1e-3))
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater)
                .compute_dtype(self.compute_dtype)
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        activation=Activation.RELU,
                                        weight_init=WeightInit.HE_NORMAL))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        activation=Activation.RELU,
                                        weight_init=WeightInit.HE_NORMAL))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation=Activation.RELU))
                .layer(OutputLayer(n_out=self.num_classes,
                                   loss=LossFunction.MCXENT,
                                   activation=Activation.SOFTMAX))
                .set_input_type(InputType.convolutional_flat(
                    self.height, self.width, self.channels))
                .build())


@dataclasses.dataclass
class SimpleCNN(_DigitsZoo):
    """reference: model/SimpleCNN.java — 4 blocks of (3×3 conv, BN, 3×3
    conv + ReLU, 2×2 max pool) of 16/32/64/128 channels, dense 256 with
    dropout 0.5, softmax. ``PRETRAINED["digits"]`` is the committed
    self-trained checkpoint (≥95% on the held-out UCI digits, NHWC
    28×28×1)."""
    PRETRAINED = {"digits": {"resource": "simplecnn_digits.zip",
                             "checksum": 4047027733}}
    num_classes: int = 10
    height: int = 48
    width: int = 48
    channels: int = 3
    seed: int = 123

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .list())
        for n_out in (16, 32, 64, 128):
            b = (b.layer(ConvolutionLayer(
                    n_out=n_out, kernel_size=(3, 3),
                    convolution_mode=ConvolutionMode.SAME,
                    activation=Activation.IDENTITY))
                 .layer(BatchNormalization())
                 .layer(ConvolutionLayer(
                     n_out=n_out, kernel_size=(3, 3),
                     convolution_mode=ConvolutionMode.SAME,
                     activation=Activation.RELU))
                 .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2))))
        return (b.layer(DenseLayer(n_out=256, activation=Activation.RELU,
                                   dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())


@dataclasses.dataclass
class TextGenerationLSTM(_ListZoo):
    """reference: model/TextGenerationLSTM.java — char-level 2×LSTM(256)
    under a per-timestep softmax, Adam(2e-3) with value clipping at 5.
    ``PRETRAINED`` is the committed self-trained char-level checkpoint
    (corpus ``tests/resources/pretrained/corpus.txt``, vocab
    ``textgen_vocab.json`` beside it: char → input index, 0 = unknown)."""
    PRETRAINED = {"resource": "textgen_lstm.zip", "checksum": 3656007127}
    vocab_size: int = 77
    timesteps: int = 60
    lstm_units: int = 256
    seed: int = 123

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(Adam(2e-3))
                .gradient_normalization("clip_value", 5.0)
                .list()
                .layer(LSTM(n_out=self.lstm_units,
                            activation=Activation.TANH))
                .layer(LSTM(n_out=self.lstm_units,
                            activation=Activation.TANH))
                .layer(RnnOutputLayer(n_out=self.vocab_size,
                                      loss=LossFunction.MCXENT,
                                      activation=Activation.SOFTMAX))
                .set_input_type(InputType.recurrent(self.vocab_size,
                                                    self.timesteps))
                .build())

    def init_pretrained(self, path: Optional[str] = None,
                        device: DeviceLike = None) -> MultiLayerNetwork:
        """Restore the committed checkpoint after checking its Adler32
        checksum (reference: ZooModel.initPretrained:51; the JAX package's
        resource path), or the zip at ``path``. Nothing is downloaded."""
        from deeplearning4j_tpu_torch.models.serialization import \
            restore_multi_layer_network
        if path is None:
            path = pretrained_path(self.PRETRAINED["resource"],
                                   self.PRETRAINED["checksum"])
        return restore_multi_layer_network(str(path), device=device)


def _vgg(seed, compute_dtype, plan, num_classes, height, width, channels):
    """VGG: 3×3 SAME ReLU convs in blocks of ``plan`` [(n_out, reps)],
    2×2 max pools between, two dense 4096 with dropout 0.5, softmax."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .updater(Nesterovs(1e-2, 0.9))
         .compute_dtype(compute_dtype)
         .list())
    for n_out, reps in plan:
        for _ in range(reps):
            b = b.layer(ConvolutionLayer(
                n_out=n_out, kernel_size=(3, 3),
                convolution_mode=ConvolutionMode.SAME,
                activation=Activation.RELU))
        b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
    return (b.layer(DenseLayer(n_out=4096, activation=Activation.RELU,
                               dropout=0.5))
            .layer(DenseLayer(n_out=4096, activation=Activation.RELU,
                              dropout=0.5))
            .layer(OutputLayer(n_out=num_classes))
            .set_input_type(InputType.convolutional(height, width, channels))
            .build())


@dataclasses.dataclass
class VGG16(_ListZoo):
    """reference: model/VGG16.java — 13 convs in [2,2,3,3,3]."""
    num_classes: int = 200
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        return _vgg(self.seed, self.compute_dtype,
                    [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
                    self.num_classes, self.height, self.width, self.channels)


@dataclasses.dataclass
class VGG19(_ListZoo):
    """reference: model/VGG19.java — VGG16 with the deeper [2,2,4,4,4]
    conv plan."""
    num_classes: int = 1000
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        return _vgg(self.seed, self.compute_dtype,
                    [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)],
                    self.num_classes, self.height, self.width, self.channels)


@dataclasses.dataclass
class AlexNet(_ListZoo):
    """reference: model/AlexNet.java (single-stream variant)."""
    num_classes: int = 1000
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123

    def conf(self):
        same = ConvolutionMode.SAME
        relu = Activation.RELU
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(Nesterovs(1e-2, 0.9))
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4), activation=relu))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        convolution_mode=same,
                                        activation=relu))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode=same,
                                        activation=relu))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode=same,
                                        activation=relu))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        convolution_mode=same,
                                        activation=relu))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation=relu, dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation=relu, dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())


def _darknet_block(b, n_out, kernel):
    """conv + BN + leaky ReLU (reference: model/helper/DarknetHelper.java
    addLayers)."""
    return (b.layer(ConvolutionLayer(
                n_out=n_out, kernel_size=kernel,
                convolution_mode=ConvolutionMode.SAME, has_bias=False,
                activation=Activation.IDENTITY))
            .layer(BatchNormalization())
            .layer(ActivationLayer(activation=Activation.LEAKYRELU)))


def _pool2(b):
    return b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))


@dataclasses.dataclass
class Darknet19(_ListZoo):
    """reference: model/Darknet19.java — the YOLO2 classification backbone
    (19 convs, 1×1 bottlenecks between 3×3s), a 1×1 class conv, global
    average pool and softmax loss."""
    num_classes: int = 1000
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-3, 0.9))
             .compute_dtype(self.compute_dtype)
             .list())
        b = _pool2(_darknet_block(b, 32, (3, 3)))
        b = _pool2(_darknet_block(b, 64, (3, 3)))
        for mid, outer in ((64, 128), (128, 256)):
            b = _darknet_block(b, outer, (3, 3))
            b = _darknet_block(b, mid, (1, 1))
            b = _pool2(_darknet_block(b, outer, (3, 3)))
        for mid, outer in ((256, 512), (512, 1024)):
            b = _darknet_block(b, outer, (3, 3))
            b = _darknet_block(b, mid, (1, 1))
            b = _darknet_block(b, outer, (3, 3))
            b = _darknet_block(b, mid, (1, 1))
            b = _darknet_block(b, outer, (3, 3))
            if outer == 512:
                b = _pool2(b)
        b = b.layer(ConvolutionLayer(n_out=self.num_classes,
                                     kernel_size=(1, 1),
                                     convolution_mode=ConvolutionMode.SAME,
                                     activation=Activation.IDENTITY))
        return (b.layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
                .layer(LossLayer(loss=LossFunction.MCXENT,
                                 activation=Activation.SOFTMAX))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())


@dataclasses.dataclass
class TinyYOLO(_ListZoo):
    """reference: model/TinyYOLO.java — tiny-YOLOv2: six darknet
    conv/pool stages, then a 1×1 head into ``Yolo2OutputLayer``; anchors
    in 13×13-grid units."""
    num_classes: int = 20
    height: int = 416
    width: int = 416
    channels: int = 3
    boxes: Tuple = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                    (9.42, 5.11), (16.62, 10.52))
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .compute_dtype(self.compute_dtype)
             .list())
        for n_out in (16, 32, 64, 128, 256):
            b = _pool2(_darknet_block(b, n_out, (3, 3)))
        b = _darknet_block(b, 512, (3, 3))
        b = b.layer(SubsamplingLayer(
            kernel_size=(2, 2), stride=(1, 1),
            convolution_mode=ConvolutionMode.SAME))
        b = _darknet_block(b, 1024, (3, 3))
        b = _darknet_block(b, 1024, (3, 3))
        b = b.layer(ConvolutionLayer(
            n_out=len(self.boxes) * (5 + self.num_classes),
            kernel_size=(1, 1), convolution_mode=ConvolutionMode.SAME,
            activation=Activation.IDENTITY))
        return (b.layer(Yolo2OutputLayer(boxes=self.boxes))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())


@dataclasses.dataclass
class YOLO2(_GraphZoo):
    """reference: model/YOLO2.java — Darknet19 backbone and the
    passthrough: the 512-channel stage-5 map goes through a
    ``SpaceToDepthLayer`` into the head's ``MergeVertex``."""
    num_classes: int = 20
    height: int = 416
    width: int = 416
    channels: int = 3
    boxes: Tuple = ((0.57273, 0.677385), (1.87446, 2.06253),
                    (3.33843, 5.47434), (7.88282, 3.52778),
                    (9.77052, 9.16828))
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .compute_dtype(self.compute_dtype)
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def block(name, src, n_out, kernel):
            g.add_layer(f"{name}_conv", ConvolutionLayer(
                n_out=n_out, kernel_size=kernel,
                convolution_mode=ConvolutionMode.SAME, has_bias=False,
                activation=Activation.IDENTITY), src)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
            g.add_layer(f"{name}_act",
                        ActivationLayer(activation=Activation.LEAKYRELU),
                        f"{name}_bn")
            return f"{name}_act"

        def pool(name, src):
            g.add_layer(name, SubsamplingLayer(kernel_size=(2, 2),
                                               stride=(2, 2)), src)
            return name

        x = pool("p1", block("c1", "in", 32, (3, 3)))
        x = pool("p2", block("c2", x, 64, (3, 3)))
        for i, (mid, outer) in enumerate(((64, 128), (128, 256))):
            x = block(f"s{i}a", x, outer, (3, 3))
            x = block(f"s{i}b", x, mid, (1, 1))
            x = pool(f"s{i}p", block(f"s{i}c", x, outer, (3, 3)))
        # stage 5 (512): its output is the passthrough source
        x = block("s2a", x, 512, (3, 3))
        x = block("s2b", x, 256, (1, 1))
        x = block("s2c", x, 512, (3, 3))
        x = block("s2d", x, 256, (1, 1))
        passthrough = block("s2e", x, 512, (3, 3))
        x = pool("s2p", passthrough)
        # stage 6 (1024)
        x = block("s3a", x, 1024, (3, 3))
        x = block("s3b", x, 512, (1, 1))
        x = block("s3c", x, 1024, (3, 3))
        x = block("s3d", x, 512, (1, 1))
        x = block("s3e", x, 1024, (3, 3))
        # head
        x = block("h1", x, 1024, (3, 3))
        x = block("h2", x, 1024, (3, 3))
        g.add_layer("reorg", SpaceToDepthLayer(block_size=2), passthrough)
        g.add_vertex("cat", MergeVertex(), "reorg", "h2_act")
        x = block("h3", "cat", 1024, (3, 3))
        g.add_layer("head", ConvolutionLayer(
            n_out=len(self.boxes) * (5 + self.num_classes),
            kernel_size=(1, 1), convolution_mode=ConvolutionMode.SAME,
            activation=Activation.IDENTITY), x)
        g.add_layer("yolo", Yolo2OutputLayer(boxes=self.boxes), "head")
        g.set_outputs("yolo")
        return g.build()


@dataclasses.dataclass
class GoogLeNet(_GraphZoo):
    """reference: model/GoogLeNet.java — Inception-v1: stem with two LRNs,
    9 inception modules (4-branch MergeVertex each), average-pool head
    with dropout 0.4."""
    num_classes: int = 1000
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-2, 0.9))
             .compute_dtype(self.compute_dtype)
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def conv(name, src, n_out, k, s=(1, 1)):
            g.add_layer(name, ConvolutionLayer(
                n_out=n_out, kernel_size=k, stride=s,
                convolution_mode=ConvolutionMode.SAME,
                activation=Activation.RELU), src)
            return name

        def pool(name, src, stride):
            g.add_layer(name, SubsamplingLayer(
                kernel_size=(3, 3), stride=stride,
                convolution_mode=ConvolutionMode.SAME), src)
            return name

        def inception(name, src, c1, c3r, c3, c5r, c5, cp):
            """1×1 / 1×1→3×3 / 1×1→5×5 / pool→1×1 branches."""
            b1 = conv(f"{name}_b1", src, c1, (1, 1))
            conv(f"{name}_b3r", src, c3r, (1, 1))
            b3 = conv(f"{name}_b3", f"{name}_b3r", c3, (3, 3))
            conv(f"{name}_b5r", src, c5r, (1, 1))
            b5 = conv(f"{name}_b5", f"{name}_b5r", c5, (5, 5))
            pool(f"{name}_pool", src, (1, 1))
            bp = conv(f"{name}_bp", f"{name}_pool", cp, (1, 1))
            g.add_vertex(name, MergeVertex(), b1, b3, b5, bp)
            return name

        x = conv("conv1", "in", 64, (7, 7), (2, 2))
        pool("pool1", x, (2, 2))
        g.add_layer("lrn1", LocalResponseNormalization(), "pool1")
        x = conv("conv2r", "lrn1", 64, (1, 1))
        x = conv("conv2", x, 192, (3, 3))
        g.add_layer("lrn2", LocalResponseNormalization(), x)
        pool("pool2", "lrn2", (2, 2))
        x = inception("i3a", "pool2", 64, 96, 128, 16, 32, 32)
        x = inception("i3b", x, 128, 128, 192, 32, 96, 64)
        x = pool("pool3", x, (2, 2))
        x = inception("i4a", x, 192, 96, 208, 16, 48, 64)
        x = inception("i4b", x, 160, 112, 224, 24, 64, 64)
        x = inception("i4c", x, 128, 128, 256, 24, 64, 64)
        x = inception("i4d", x, 112, 144, 288, 32, 64, 64)
        x = inception("i4e", x, 256, 160, 320, 32, 128, 128)
        x = pool("pool4", x, (2, 2))
        x = inception("i5a", x, 256, 160, 320, 32, 128, 128)
        x = inception("i5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("drop", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       loss=LossFunction.MCXENT,
                                       activation=Activation.SOFTMAX),
                    "drop")
        g.set_outputs("out")
        return g.build()


@dataclasses.dataclass
class InceptionResNetV1(_GraphZoo):
    """reference: model/InceptionResNetV1.java (+ helper/
    InceptionResNetHelper.java) — FaceNet-style embedding net: stem,
    5× block35, reduction-A, 10× block17, reduction-B, 5× block8, a
    128-d L2-normalized embedding and a center-loss softmax head."""
    num_classes: int = 1001
    embedding_size: int = 128
    height: int = 160
    width: int = 160
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .compute_dtype(self.compute_dtype)
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def conv(name, src, n_out, k, s=(1, 1), act=Activation.RELU):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel_size=k, stride=s,
                convolution_mode=ConvolutionMode.SAME, has_bias=False,
                activation=Activation.IDENTITY), src)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_c")
            if act is None:
                return f"{name}_bn"
            g.add_layer(f"{name}_a", ActivationLayer(activation=act),
                        f"{name}_bn")
            return f"{name}_a"

        def pool(name, src):
            g.add_layer(name, SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2),
                convolution_mode=ConvolutionMode.SAME), src)
            return name

        def residual(name, src, branches, n_channels, scale):
            """merge(branches) → linear 1×1 up-projection → scaled residual
            add → ReLU."""
            g.add_vertex(f"{name}_cat", MergeVertex(), *branches)
            up = conv(f"{name}_up", f"{name}_cat", n_channels, (1, 1),
                      act=None)
            g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), src,
                         f"{name}_scale")
            g.add_layer(f"{name}_out",
                        ActivationLayer(activation=Activation.RELU),
                        f"{name}_add")
            return f"{name}_out"

        def block35(name, src):
            b1 = conv(f"{name}_b1", src, 32, (1, 1))
            b2 = conv(f"{name}_b2b", conv(f"{name}_b2a", src, 32, (1, 1)),
                      32, (3, 3))
            b3 = conv(f"{name}_b3c",
                      conv(f"{name}_b3b",
                           conv(f"{name}_b3a", src, 32, (1, 1)), 32,
                           (3, 3)), 32, (3, 3))
            return residual(name, src, (b1, b2, b3), 256, 0.17)

        def block17(name, src):
            b1 = conv(f"{name}_b1", src, 128, (1, 1))
            b2 = conv(f"{name}_b2c",
                      conv(f"{name}_b2b",
                           conv(f"{name}_b2a", src, 128, (1, 1)), 128,
                           (1, 7)), 128, (7, 1))
            return residual(name, src, (b1, b2), 896, 0.10)

        def block8(name, src):
            b1 = conv(f"{name}_b1", src, 192, (1, 1))
            b2 = conv(f"{name}_b2c",
                      conv(f"{name}_b2b",
                           conv(f"{name}_b2a", src, 192, (1, 1)), 192,
                           (1, 3)), 192, (3, 1))
            return residual(name, src, (b1, b2), 1792, 0.20)

        x = conv("stem1", "in", 32, (3, 3), (2, 2))
        x = conv("stem2", x, 32, (3, 3))
        x = conv("stem3", x, 64, (3, 3))
        x = conv("stem4", pool("stem_pool", x), 80, (1, 1))
        x = conv("stem5", x, 192, (3, 3))
        x = conv("stem6", x, 256, (3, 3), (2, 2))
        for i in range(5):
            x = block35(f"b35_{i}", x)
        # reduction-A → 896 channels
        pool("redA_pool", x)
        ra1 = conv("redA_b1", x, 384, (3, 3), (2, 2))
        ra2 = conv("redA_b2c",
                   conv("redA_b2b", conv("redA_b2a", x, 192, (1, 1)),
                        192, (3, 3)), 256, (3, 3), (2, 2))
        g.add_vertex("redA", MergeVertex(), "redA_pool", ra1, ra2)
        x = "redA"
        for i in range(10):
            x = block17(f"b17_{i}", x)
        # reduction-B → 1792 channels
        pool("redB_pool", x)
        rb1 = conv("redB_b1b", conv("redB_b1a", x, 256, (1, 1)), 384,
                   (3, 3), (2, 2))
        rb2 = conv("redB_b2b", conv("redB_b2a", x, 256, (1, 1)), 256,
                   (3, 3), (2, 2))
        rb3 = conv("redB_b3c",
                   conv("redB_b3b", conv("redB_b3a", x, 256, (1, 1)),
                        256, (3, 3)), 256, (3, 3), (2, 2))
        g.add_vertex("redB", MergeVertex(), "redB_pool", rb1, rb2, rb3)
        x = "redB"
        for i in range(5):
            x = block8(f"b8_{i}", x)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation=Activation.IDENTITY),
            "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_out=self.num_classes, loss=LossFunction.MCXENT,
            activation=Activation.SOFTMAX), "embeddings")
        g.set_outputs("out")
        return g.build()


@dataclasses.dataclass
class FaceNetNN4Small2(_GraphZoo):
    """reference: model/FaceNetNN4Small2.java (+ helper/FaceNetHelper
    .java) — the NN4-small2 face embedding net: stem with two LRNs, mixed
    3a/3b/3c/4a/4e/5a/5b inception blocks, a 128-d L2-normalized
    embedding and a center-loss softmax head."""
    num_classes: int = 5749
    embedding_size: int = 128
    height: int = 96
    width: int = 96
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .compute_dtype(self.compute_dtype)
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def conv(name, src, n_out, k, s=(1, 1)):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel_size=k, stride=s,
                convolution_mode=ConvolutionMode.SAME,
                activation=Activation.IDENTITY), src)
            g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_c")
            g.add_layer(f"{name}_a",
                        ActivationLayer(activation=Activation.RELU),
                        f"{name}_bn")
            return f"{name}_a"

        def pool(name, src, stride):
            g.add_layer(name, SubsamplingLayer(
                kernel_size=(3, 3), stride=stride,
                convolution_mode=ConvolutionMode.SAME), src)
            return name

        def inception(name, src, c3r, c3, c5r, c5, cp, c1, strided=False):
            """FaceNetHelper-style mixed block; ``strided`` blocks (3c,
            4e) drop the 1×1 branch and downsample."""
            stride = (2, 2) if strided else (1, 1)
            branches = [conv(f"{name}_3",
                             conv(f"{name}_3r", src, c3r, (1, 1)), c3,
                             (3, 3), stride)]
            if c5:
                branches.append(conv(f"{name}_5",
                                     conv(f"{name}_5r", src, c5r, (1, 1)),
                                     c5, (5, 5), stride))
            pool(f"{name}_pool", src, stride)
            branches.append(conv(f"{name}_pp", f"{name}_pool", cp, (1, 1))
                            if cp else f"{name}_pool")
            if c1:
                branches.append(conv(f"{name}_1", src, c1, (1, 1)))
            g.add_vertex(name, MergeVertex(), *branches)
            return name

        x = conv("conv1", "in", 64, (7, 7), (2, 2))
        pool("pool1", x, (2, 2))
        g.add_layer("lrn1", LocalResponseNormalization(), "pool1")
        x = conv("conv2", "lrn1", 64, (1, 1))
        x = conv("conv3", x, 192, (3, 3))
        g.add_layer("lrn2", LocalResponseNormalization(), x)
        pool("pool2", "lrn2", (2, 2))
        x = inception("mixed3a", "pool2", 96, 128, 16, 32, 32, 64)
        x = inception("mixed3b", x, 96, 128, 32, 64, 64, 64)
        x = inception("mixed3c", x, 128, 256, 32, 64, 0, 0, strided=True)
        x = inception("mixed4a", x, 96, 192, 32, 64, 128, 256)
        x = inception("mixed4e", x, 160, 256, 64, 128, 0, 0, strided=True)
        x = inception("mixed5a", x, 96, 384, 0, 0, 96, 256)
        x = inception("mixed5b", x, 96, 384, 0, 0, 96, 256)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation=Activation.IDENTITY),
            "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_out=self.num_classes, loss=LossFunction.MCXENT,
            activation=Activation.SOFTMAX), "embeddings")
        g.set_outputs("out")
        return g.build()
