"""Keras model import.

The port of the JAX package's ``modelimport`` (reference:
deeplearning4j-modelimport): read a Keras ``.h5`` file or Keras-3
``.keras`` zip (model config JSON + weights), convert each Keras layer
through a registry of converters into this framework's layer and vertex
configs, and copy the weights into the initialized model on ``device``
(``cuda`` unless the caller passes ``"cpu"``). ``h5py`` and ``keras`` are
imported only inside the functions that need them, so this package
imports without them; reading a file needs h5py.
"""

from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasModelImport,
    import_keras_model_and_weights,
    import_keras_sequential_model_and_weights,
)
from deeplearning4j_tpu_torch.modelimport.layers import register_custom_layer

__all__ = [
    "Hdf5Archive", "KerasModelImport",
    "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
    "register_custom_layer",
]
