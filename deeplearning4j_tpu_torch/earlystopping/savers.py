"""Model savers for early stopping.

The port of the JAX package's ``earlystopping/savers.py`` (reference:
deeplearning4j-nn/.../earlystopping/saver/ InMemoryModelSaver.java,
LocalFileModelSaver.java, LocalFileGraphSaver.java). One
LocalFileModelSaver serves both model classes: the checkpoint (the
port's model zip, models/serialization.py) names its class, and a
restored model comes back on the device of the model that was saved.
"""

from __future__ import annotations

import os

from deeplearning4j_tpu_torch.models import serialization


class ModelSaver:
    def save_best_model(self, model, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, model, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(ModelSaver):
    """Keeps clones in memory, on the model's device
    (saver/InMemoryModelSaver.java)."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score: float) -> None:
        self._best = model.clone()

    def save_latest_model(self, model, score: float) -> None:
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(ModelSaver):
    """Writes bestModel.bin / latestModel.bin under a directory
    (saver/LocalFileModelSaver.java — same file names), with the updater
    state."""

    def __init__(self, directory: str):
        self.directory = directory
        self._device = {}
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, model, name: str) -> None:
        serialization.save_model(model, self._path(name), save_updater=True)
        self._device[name] = model.device

    def save_best_model(self, model, score: float) -> None:
        self._save(model, "bestModel.bin")

    def save_latest_model(self, model, score: float) -> None:
        self._save(model, "latestModel.bin")

    def _restore(self, name: str):
        path = self._path(name)
        if not os.path.exists(path):
            return None
        return serialization.restore_model(
            path, device=self._device.get(name), load_updater=True)

    def get_best_model(self):
        return self._restore("bestModel.bin")

    def get_latest_model(self):
        return self._restore("latestModel.bin")


# Alias for API parity with the reference's graph-specific saver.
LocalFileGraphSaver = LocalFileModelSaver
