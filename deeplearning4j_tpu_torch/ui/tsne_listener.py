"""Auto-populating t-SNE listener.

The port of the JAX package's ``ui/tsne_listener.py``. Attach it next to
the StatsListener: every ``frequency`` iterations it embeds a held-out
example batch through the live model, runs t-SNE (manifold/tsne.py) on a
chosen activation layer in a background thread, on the model's device,
and pushes the coordinates to the UIServer's t-SNE tab. Training never
waits for it; while one embedding runs, the next due one is skipped.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class TsneListener(TrainingListener):
    def __init__(self, server, frequency: int = 50,
                 layer_index: int = -2, max_points: int = 300,
                 perplexity: float = 20.0, n_iter: int = 250):
        self.server = server
        self.frequency = max(1, frequency)
        self.layer_index = layer_index
        self.max_points = max_points
        self.perplexity = perplexity
        self.n_iter = n_iter
        self._feats: Optional[np.ndarray] = None
        self._labels = None
        self._worker: Optional[threading.Thread] = None

    def set_example(self, features, labels=None) -> "TsneListener":
        self._feats = np.asarray(features)[:self.max_points]
        if labels is not None:
            self._labels = [str(l) for l in
                            np.asarray(labels)[:self.max_points]]
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the running embedding; True when none is running."""
        if self._worker is not None:
            self._worker.join(timeout)
        return self._worker is None or not self._worker.is_alive()

    def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                       batch_size):
        if self._feats is None or iteration % self.frequency:
            return
        if self._worker is not None and self._worker.is_alive():
            return                      # previous embedding still running
        ff = getattr(model, "feed_forward", None)
        if ff is None:                  # ComputationGraph: final output
            acts = model.output(self._feats)
        else:
            acts = ff(self._feats)[self.layer_index]
        acts = acts.float().cpu().numpy()
        acts = acts.reshape(acts.shape[0], -1)
        device = model.device

        def run():
            from deeplearning4j_tpu_torch.manifold.tsne import Tsne
            coords = Tsne(n_components=2, perplexity=self.perplexity,
                          n_iter=self.n_iter,
                          device=device).fit_transform(acts)
            self.server.upload_tsne(coords, self._labels)

        self._worker = threading.Thread(target=run, daemon=True)
        self._worker.start()
