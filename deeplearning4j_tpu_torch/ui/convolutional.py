"""ConvolutionalListener — per-layer activation visualization.

Analog of the reference's ConvolutionalIterationListener +
ConvolutionalListenerModule (deeplearning4j-play/.../module/convolutional/
ConvolutionalListenerModule.java:1), ported from the JAX package's
``ui/convolutional.py``: every ``frequency`` iterations, forward one
pinned example through ``feed_forward`` (on the model's device), bring
each layer's activation to the host, tile its channels into a heat-map
mosaic, PNG-encode it (ui/png.py) and route it to the stats storage;
the dashboard's Activations tab (ui/server.py) shows them live.
"""

from __future__ import annotations

import base64
import time
import uuid
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.png import activation_grid, encode_png_gray
from deeplearning4j_tpu_torch.ui.storage import StatsStorageRouter


class ConvolutionalListener(TrainingListener):
    def __init__(self, router: StatsStorageRouter,
                 session_id: Optional[str] = None,
                 frequency: int = 10, max_channels: int = 64):
        self.router = router
        self.session_id = session_id or f"sess_{uuid.uuid4().hex[:10]}"
        self.frequency = max(1, frequency)
        self.max_channels = max_channels
        self._example: Optional[np.ndarray] = None

    def set_example(self, features) -> "ConvolutionalListener":
        """Pin the example to visualize (first row used); the fit loop
        does not hand listeners the batch, so one must be pinned."""
        self._example = np.asarray(features)[:1]
        return self

    def iteration_done(self, model, iteration: int, epoch: int, loss,
                       etl_ms: float, batch_size: int):
        if iteration % self.frequency != 0 or self._example is None:
            return
        if not hasattr(model, "feed_forward"):
            return
        acts = model.feed_forward(self._example, train=False)
        images = {}
        names = getattr(model, "layer_names",
                        [f"layer_{i}" for i in range(len(acts))])
        for name, act in zip(names, acts):
            a = act[0].detach().to("cpu", torch.float64).numpy()
            if a.ndim not in (1, 2, 3):
                continue
            grid = activation_grid(a, self.max_channels)
            # keep tiles readable: upscale tiny mosaics
            scale = max(1, 128 // max(grid.shape))
            if scale > 1:
                grid = np.kron(grid, np.ones((scale, scale)))
            images[name] = base64.b64encode(
                encode_png_gray(grid)).decode()
        self.router.put_update({
            "session_id": self.session_id,
            "worker_id": "w0",
            "timestamp": time.time(),
            "iteration": iteration,
            "type": "activations",
            "activations_png": images,
        })
