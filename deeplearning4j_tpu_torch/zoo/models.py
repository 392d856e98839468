"""Model zoo: LeNet, SimpleCNN, ResNet50 and TextGenerationLSTM.

The JAX package's ``zoo/models.py`` entries (reference:
deeplearning4j-zoo/.../model/) with the same fields and the same
configurations (layer names, layer configs, topology), so configurations
and checkpoints carry across:

- ``ResNet50`` in its fused-block form (``fused_blocks=True``,
  ``fused_impl="pallas"``): each bottleneck is one
  ``FusedBottleneckBlock`` whose convs go through the conv kernels;
- ``TextGenerationLSTM``, the char-level 2×LSTM(256) whose recurrences go
  through the fused LSTM kernels, with ``init_pretrained`` restoring the
  committed self-trained weights;
- ``LeNet`` and ``SimpleCNN``, whose convolutions are plain torch (the
  JAX package leaves them to XLA), with ``init_pretrained(flavor=
  "digits")`` restoring the committed digit models.

The per-layer (unfused) ResNet50 and the other zoo models come with later
slices.
"""

from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
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
                                                            DenseLayer)
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
from deeplearning4j_tpu_torch.nn.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu_torch.nn.layers.output import (GlobalPoolingLayer,
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


@dataclasses.dataclass
class ResNet50:
    """reference: model/ResNet50.java — bottleneck-v1 ComputationGraph:
    stem → maxpool/2 → stages [3,4,6,3] → global avg pool → softmax."""
    num_classes: int = 200
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    compute_dtype: str = "float32"
    updater: Updater = dataclasses.field(
        default_factory=lambda: Nesterovs(1e-2, 0.9))
    fused_blocks: bool = False     # only True is ported (see conf())
    fused_impl: str = "pallas"
    # space-to-depth stem: H×W×3 → H/2×W/2×12 and a 4×4/1 conv that is
    # exactly the 7×7/2 conv (fold_stem_weights maps the weights)
    s2d_stem: bool = False

    def conf(self):
        if not self.fused_blocks:
            raise NotImplementedError(
                "ResNet50(fused_blocks=False): the per-layer graph is not "
                "ported yet; use fused_blocks=True")
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater)
             .compute_dtype(self.compute_dtype)
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        if self.s2d_stem:
            g.add_layer("s2d", SpaceToDepthLayer(block_size=2), "in")
            g.add_layer("s2d_pad", ZeroPaddingLayer(pad=(1, 2, 1, 2)), "s2d")
            g.add_layer("conv1_conv", ConvolutionLayer(
                n_out=64, kernel_size=(4, 4), stride=(1, 1),
                convolution_mode=ConvolutionMode.TRUNCATE,
                padding=(0, 0), has_bias=False,
                weight_init=WeightInit.HE_NORMAL,
                activation=Activation.IDENTITY), "s2d_pad")
        else:
            g.add_layer("conv1_conv", ConvolutionLayer(
                n_out=64, kernel_size=(7, 7), stride=(2, 2),
                convolution_mode=ConvolutionMode.SAME, has_bias=False,
                weight_init=WeightInit.HE_NORMAL,
                activation=Activation.IDENTITY), "in")
        g.add_layer("conv1_bn", BatchNormalization(), "conv1_conv")
        g.add_layer("conv1_act", ActivationLayer(activation=Activation.RELU),
                    "conv1_bn")
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), "conv1_act")
        x = "pool1"
        for si, (filters, blocks, first_stride) in enumerate(STAGES):
            for bi in range(blocks):
                name = f"s{si}b{bi}"
                g.add_layer(name, FusedBottleneckBlock(
                    filters=filters, stride=first_stride if bi == 0 else 1,
                    downsample=bi == 0, impl=self.fused_impl), x)
                x = name
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       loss=LossFunction.MCXENT,
                                       activation=Activation.SOFTMAX),
                    "avgpool")
        g.set_outputs("out")
        return g.build()

    def init(self, device: DeviceLike = None) -> ComputationGraph:
        return ComputationGraph(self.conf(), device=device).init()


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


class _DigitsZoo:
    """``init`` and ``init_pretrained`` of the zoo's digit models."""
    PRETRAINED: dict = {}

    def init(self, device: DeviceLike = None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()

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
class TextGenerationLSTM:
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

    def init(self, device: DeviceLike = None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf(), device=device).init()

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
