"""KerasModelImport: Keras model file → runnable model.

The port of the JAX package's ``modelimport/keras.py`` (reference:
KerasModelImport.java:41 / KerasModel.java:57 /
KerasSequentialModel.java):

    Sequential model config → MultiLayerNetwork
    Functional (Model) config → ComputationGraph

Pipeline: an archive gives the ``model_config`` JSON, the Keras major
version, the ``training_config`` and per-layer weight dicts; each layer
goes through the converter registry (modelimport/layers.py, with the
custom-layer hook); the converted weights are copied into the
initialized model's tensors with layout transposes applied. TF/NHWC
dimension ordering maps 1:1 onto this framework's NHWC layouts.

The public functions take a path and open ``Hdf5Archive`` (h5py, on the
CPU). The conversion itself (``_import_archive``) takes any object with
``Hdf5Archive``'s ``model_config()``, ``keras_version()``,
``read_attribute_as_json("training_config")`` (``KeyError`` when absent)
and ``layer_weights(name)``, so it runs where h5py is missing, on
configurations and weight dicts read some other way. The model is built
on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.layers import (
    Converted,
    convert_layer,
)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
from deeplearning4j_tpu_torch.nn.layers.output import LossLayer, OutputLayer
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device


def _input_type_from_shape(shape) -> InputType:
    """batch_input_shape (None, ...) → InputType."""
    dims = [d for d in shape[1:]]
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(int(h), int(w), int(c))
    if len(dims) == 2:
        t, f = dims
        return InputType.recurrent(int(f), None if t is None else int(t))
    if len(dims) == 1:
        return InputType.feed_forward(int(dims[0]))
    raise ValueError(f"unsupported Keras input shape {shape}")


def _loss_for_activation(act: Optional[Activation],
                         keras_loss: Optional[str]) -> LossFunction:
    if keras_loss:
        m = {"categorical_crossentropy": LossFunction.MCXENT,
             "sparse_categorical_crossentropy": LossFunction.MCXENT,
             "binary_crossentropy": LossFunction.XENT,
             "mean_squared_error": LossFunction.MSE,
             "mse": LossFunction.MSE,
             "mean_absolute_error": LossFunction.L1,
             "mae": LossFunction.L1,
             "hinge": LossFunction.HINGE,
             "squared_hinge": LossFunction.SQUARED_HINGE,
             "kullback_leibler_divergence": LossFunction.KL_DIVERGENCE,
             "poisson": LossFunction.POISSON,
             "cosine_proximity": LossFunction.COSINE_PROXIMITY}
        if keras_loss in m:
            return m[keras_loss]
    if act == Activation.SOFTMAX:
        return LossFunction.MCXENT
    if act == Activation.SIGMOID:
        return LossFunction.XENT
    return LossFunction.MSE


def _to_output_layer(layer, act: Optional[Activation],
                     keras_loss: Optional[str]):
    """Final imported layer → trainable output layer (reference:
    KerasModel wires loss layers from training_config)."""
    loss = _loss_for_activation(act, keras_loss)
    if isinstance(layer, DenseLayer) and not isinstance(layer, OutputLayer):
        return OutputLayer(
            n_in=layer.n_in, n_out=layer.n_out, activation=layer.activation,
            has_bias=layer.has_bias, loss=loss)
    return layer


def _training_loss(archive) -> Optional[str]:
    try:
        tc = archive.read_attribute_as_json("training_config")
        loss = tc.get("loss")
        if isinstance(loss, dict):
            loss = next(iter(loss.values()), None)
        if isinstance(loss, dict):  # serialized loss object
            loss = loss.get("class_name")
        return loss if isinstance(loss, str) else None
    except KeyError:
        return None


def _set_imported(model, name: str, conv: Converted,
                  weights: Dict[str, np.ndarray]):
    """Copy one layer's mapped weights into the model's parameter and
    state dicts, shape-checked against the initialized tensors, in each
    initialized leaf's dtype on the model's device. The values are
    copied, never aliased to the reader's numpy arrays."""
    if conv.weights is None or not weights:
        return
    params, state = conv.weights(weights)

    def leaf(cur, v, path):
        v = np.asarray(v)
        if cur is not None and tuple(cur.shape) != tuple(v.shape):
            raise ValueError(
                f"imported weight {path} has shape {v.shape}, "
                f"model expects {tuple(cur.shape)}")
        dt = cur.dtype if cur is not None else torch.float32
        return torch.tensor(v, dtype=dt, device=model.device)

    def merge(cur, new, path):
        """Recursive merge: nested dicts (Bidirectional fwd/bwd) descend;
        leaves are shape-checked against the initialized values."""
        cur = dict(cur)
        for k, v in new.items():
            if isinstance(v, dict):
                cur[k] = merge(cur.get(k, {}), v, f"{path}/{k}")
            else:
                cur[k] = leaf(cur.get(k), v, f"{path}/{k}")
        return cur

    if params:
        model.params = dict(model.params)
        model.params[name] = merge(model.params.get(name, {}), params, name)
    if state:
        model.model_state = dict(model.model_state)
        model.model_state[name] = merge(model.model_state.get(name, {}),
                                        state, name)


# ---- sequential ----------------------------------------------------------

def _import_sequential(archive, device):
    mc = archive.model_config()
    if mc.get("class_name") != "Sequential":
        raise ValueError("not a Sequential model; use "
                         "import_keras_model_and_weights")
    version = archive.keras_version()
    cfg = mc["config"]
    layer_dicts = cfg if isinstance(cfg, list) else cfg["layers"]
    keras_loss = _training_loss(archive)

    input_type = None
    converted: List[Tuple[str, Converted]] = []
    for ld in layer_dicts:
        lcfg = ld["config"]
        if input_type is None:
            shape = lcfg.get("batch_input_shape", lcfg.get("batch_shape"))
            if shape is not None:
                input_type = _input_type_from_shape(shape)
        conv = convert_layer(ld["class_name"], lcfg, version)
        converted.append((lcfg.get("name", ld["class_name"]), conv))
    if input_type is None:
        raise ValueError("model config declares no input shape")

    kept = [(n, c) for n, c in converted if not c.skip]
    if not kept:
        raise ValueError("no convertible layers in model")
    # the final layer must bear a loss for fit(); the reference appends
    # loss layers from training_config
    last_name, last = kept[-1]
    out_layer = _to_output_layer(last.layer, last.activation, keras_loss)
    if out_layer is last.layer and not isinstance(
            last.layer, (OutputLayer, LossLayer)):
        kept.append(("loss", Converted(layer=LossLayer(
            loss=_loss_for_activation(last.activation, keras_loss)))))
    else:
        kept[-1] = (last_name, dataclasses.replace(last, layer=out_layer))

    lb = NeuralNetConfiguration.Builder().list()
    for name, conv in kept:
        lb.layer(dataclasses.replace(conv.layer, name=name))
    conf = lb.set_input_type(input_type).build()

    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    model = MultiLayerNetwork(conf, device=device).init()
    for name, conv in kept:
        _set_imported(model, name, conv, archive.layer_weights(name))
    return model


# ---- functional ----------------------------------------------------------

def _collect_histories(obj, out: List[str]):
    """Walk a Keras 3 inbound-node args structure, collecting the source
    layer name of every ``__keras_tensor__``."""
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            out.append(obj["config"]["keras_history"][0])
            return
        for v in obj.values():
            _collect_histories(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_histories(v, out)


def _inbound_names(ld: dict) -> List[str]:
    nodes = ld.get("inbound_nodes", [])
    if not nodes:
        return []
    first = nodes[0]
    if isinstance(first, dict):          # Keras 3: {"args": [...tensors]}
        out: List[str] = []
        _collect_histories(first.get("args", []), out)
        return out
    return [n[0] for n in first]         # Keras 1/2: [[name, 0, 0, {}]...]


def _io_layer_names(entry) -> List[str]:
    """input_layers/output_layers: [[name,0,0],...] or single [name,0,0]."""
    if not entry:
        return []
    if isinstance(entry[0], str):
        return [entry[0]]
    return [e[0] for e in entry]


def _import_functional(archive, device):
    mc = archive.model_config()
    version = archive.keras_version()
    cfg = mc["config"]
    layer_dicts = cfg["layers"]
    keras_loss = _training_loss(archive)
    input_names = _io_layer_names(cfg["input_layers"])
    output_names = _io_layer_names(cfg["output_layers"])

    gb = NeuralNetConfiguration.Builder().graph_builder()
    input_types: Dict[str, InputType] = {}
    converted: Dict[str, Converted] = {}
    renames: Dict[str, str] = {}   # skip-layer name → its input's name

    for ld in layer_dicts:
        name = ld["config"].get("name", ld.get("name"))
        cname = ld["class_name"]
        lcfg = ld["config"]
        if cname == "InputLayer" or name in input_names:
            shape = lcfg.get("batch_input_shape", lcfg.get("batch_shape"))
            input_types[name] = _input_type_from_shape(shape)
            continue
        conv = convert_layer(cname, lcfg, version)
        inbound = [renames.get(i, i) for i in _inbound_names(ld)]
        if conv.layer is not None and len(set(inbound)) == 1 \
                and len(inbound) > 1:
            # self-attention style call (mha(x, x)): one source feeds
            # every argument — a single-input layer node here
            inbound = inbound[:1]
        elif cname == "MultiHeadAttention" and len(set(inbound)) > 1:
            raise ValueError(
                f"unsupported: layer {name!r} is cross-attention "
                "(distinct query/value sources); only self-attention "
                "imports are supported")
        if conv.skip:
            if len(inbound) != 1:
                raise ValueError(f"cannot skip multi-input layer {name}")
            renames[name] = inbound[0]
            continue
        converted[name] = conv
        if conv.vertex is not None:
            gb.add_vertex(name, conv.vertex, *inbound)
        else:
            layer = conv.layer
            if name in output_names:
                layer = _to_output_layer(layer, conv.activation, keras_loss)
                converted[name] = dataclasses.replace(conv, layer=layer)
            gb.add_layer(name, layer, *inbound)

    gb.add_inputs(*input_names)
    gb.set_input_types(*[input_types[n] for n in input_names])
    gb.set_outputs(*[renames.get(n, n) for n in output_names])
    conf = gb.build()

    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    model = ComputationGraph(conf, device=device).init()
    for name, conv in converted.items():
        _set_imported(model, name, conv, archive.layer_weights(name))
    return model


def _import_archive(archive, device: DeviceLike = None,
                    sequential_only: bool = False):
    """The whole conversion from an open archive (``Hdf5Archive`` or any
    object with its four reading methods): a Sequential configuration
    becomes a MultiLayerNetwork, a functional one a ComputationGraph."""
    device = resolve_device(device)
    if sequential_only or \
            archive.model_config().get("class_name") == "Sequential":
        return _import_sequential(archive, device)
    return _import_functional(archive, device)


def import_keras_sequential_model_and_weights(
        path: str, enforce_training_config: bool = False,
        device: DeviceLike = None):
    """Sequential .h5/.keras → MultiLayerNetwork on ``device`` (reference:
    KerasModelImport.importKerasSequentialModelAndWeights)."""
    device = resolve_device(device)
    with Hdf5Archive(path) as archive:
        return _import_archive(archive, device, sequential_only=True)


def import_keras_model_and_weights(path: str,
                                   enforce_training_config: bool = False,
                                   device: DeviceLike = None):
    """Functional .h5/.keras → ComputationGraph on ``device``; a
    Sequential file goes to the sequential importer (reference:
    KerasModelImport.importKerasModelAndWeights:50-218)."""
    device = resolve_device(device)
    with Hdf5Archive(path) as archive:
        return _import_archive(archive, device)


class KerasModelImport:
    """Static-method namespace matching the reference entry point
    (KerasModelImport.java:41)."""

    importKerasModelAndWeights = staticmethod(
        import_keras_model_and_weights)
    importKerasSequentialModelAndWeights = staticmethod(
        import_keras_sequential_model_and_weights)
    import_keras_model_and_weights = staticmethod(
        import_keras_model_and_weights)
    import_keras_sequential_model_and_weights = staticmethod(
        import_keras_sequential_model_and_weights)
