#!/usr/bin/env python3
"""Write the small retrieval index that the JAX package saves, for the
port's on-card check against its own CPU answers.

    python3 tools/retrieval_resources.py [OUT_DIR]

builds a seeded blob corpus (2048 x 32, the mixture-of-gaussians of the
JAX package's ``benchmarks/neighbors.py``) into two ShardedCorpusIndex
artifacts with the JAX package (shards of 1024 rows, 16 IVF clusters,
nprobe hint 4, seed 0), ``small-f32`` and ``small-int8``, and saves them
with the JAX package's ``save`` into an ArtifactStore at OUT_DIR
(default ``tests/resources/retrieval``). It also writes
``queries.npy``, 16 seeded probes near corpus rows. The output is
deterministic; ``tests/test_torch_retrieval.py`` rebuilds it and holds
the committed arrays to it. It needs JAX on the CPU (about 10 s).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "resources" / "retrieval"
N, DIM, BLOBS, SEED = 2048, 32, 16, 0
BUILD = dict(shard_rows=1024, ivf_clusters=16, nprobe_hint=4, seed=SEED)


def blob_corpus(n, dim, k_blobs, seed=0, spread=0.15):
    """The JAX package's ``benchmarks/neighbors.py`` corpus (a copy)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_blobs, dim)).astype(np.float32) * 3.0
    assign = rng.integers(k_blobs, size=n)
    pts = centers[assign] + \
        rng.normal(size=(n, dim)).astype(np.float32) * spread
    return pts.astype(np.float32)


def queries(corpus, n=16, seed=SEED + 1):
    rng = np.random.default_rng(seed)
    return (corpus[rng.integers(len(corpus), size=n)]
            + rng.normal(size=(n, corpus.shape[1])).astype(np.float32)
            * 0.05).astype(np.float32)


def write(out: Path = OUT) -> Path:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from deeplearning4j_tpu.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu.retrieval.index import ShardedCorpusIndex
    corpus = blob_corpus(N, DIM, BLOBS, SEED)
    store = ArtifactStore(str(out))
    for precision in ("f32", "int8"):
        ShardedCorpusIndex.build(corpus, precision=precision,
                                 **BUILD).save(store, f"small-{precision}")
    np.save(out / "queries.npy", queries(corpus))
    return out


if __name__ == "__main__":
    print(write(Path(sys.argv[1]) if len(sys.argv) > 1 else OUT))
