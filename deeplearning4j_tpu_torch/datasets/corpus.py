"""Object-store corpus shards: spool an unbounded sentence stream into
an ``ArtifactStore`` bucket and read it back as a (re-iterable,
follow-able) sentence source.

The reference's object-store iterator shape (BaseS3DataSetIterator):
training reads records from a bucket it doesn't own the lifecycle of.
Here the bucket layout is ``parallel/aot_cache.py``'s ``ArtifactStore``
(local dir today, the key/object split maps 1:1 onto GCS/S3), sharing
its concurrency discipline — shard files are written whole, then the
manifest is rewritten atomically and LAST, so a reader mid-append just
misses the newest shard and picks it up on the next manifest poll::

    <root>/objects/<key>/shard_000000.txt     one sentence per line
    <root>/objects/<key>/shard_000001.txt
    <root>/objects/<key>/manifest.json        {"kind": "corpus", ...}

This is what decouples streaming ingestion from training cadence: a
``CorpusShardWriter`` drains a broker topic at wire speed while
``Word2Vec.fit_stream`` (or plain ``fit``) re-reads sealed shards as
many times as it likes — the unbounded stream becomes a replayable
corpus.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Iterator, Optional

from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore

CORPUS_KIND = "corpus"


class CorpusShardWriter:
    """Append sentences into ``<store>/objects/<key>/`` as line-text
    shards of ``shard_sentences`` lines each. Every sealed shard
    republishes the manifest (atomic replace), so follow-mode readers
    see it immediately; ``close()`` seals the partial tail shard and
    marks the manifest ``complete`` — the reader's end-of-corpus
    signal."""

    def __init__(self, store: ArtifactStore, key: str,
                 shard_sentences: int = 10000):
        self.store = store
        self.key = key
        self.dir = store.cache_dir(key)
        self.shard_sentences = int(shard_sentences)
        self.shards: list = []
        self.sentences = 0
        self._buf: list = []
        self._closed = False

    def append(self, sentence: str) -> None:
        assert not self._closed, "writer is closed"
        s = sentence.strip()
        if not s:
            return
        self._buf.append(s)
        if len(self._buf) >= self.shard_sentences:
            self._seal_shard()

    def extend(self, sentences: Iterable[str]) -> int:
        n = 0
        for s in sentences:
            self.append(s)
            n += 1
        return n

    def _seal_shard(self) -> None:
        if not self._buf:
            return
        name = f"shard_{len(self.shards):06d}.txt"
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(self._buf) + "\n")
        os.replace(tmp, path)        # shard lands whole or not at all
        self.shards.append(name)
        self.sentences += len(self._buf)
        self._buf = []
        self._publish(complete=False)

    def _publish(self, complete: bool) -> None:
        manifest = {
            "kind": CORPUS_KIND,
            "shards": list(self.shards),
            "sentences": self.sentences,
            "complete": bool(complete),
        }
        path = os.path.join(self.dir, "manifest.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)        # manifest atomically, LAST

    def close(self) -> None:
        if self._closed:
            return
        self._seal_shard()
        self._publish(complete=True)
        self._closed = True


class CorpusDataSetIterator:
    """Sentence iterator over an ArtifactStore corpus bucket (the
    ``BaseS3DataSetIterator`` shape). Two modes:

    - snapshot (``follow=False``): iterate the shards the manifest
      lists right now; ``reset()``/re-iteration replays them — this is
      the multi-pass corpus ``Word2Vec.fit`` wants.
    - ``follow=True``: poll the manifest for new shards as a writer
      appends them, yielding sentences until the manifest goes
      ``complete`` (all shards drained), ``idle_timeout_s`` passes
      with no growth, or ``stop_event`` is set — the unbounded-stream
      face consumed by ``fit_stream``.

    A dead store is NOT a quiet writer: in follow mode, a manifest that
    VANISHES after having been seen, or a listed shard that can no
    longer be read, terminates immediately with ``termination_reason =
    "store_dead"`` (error text in ``store_error``) instead of idling
    until ``idle_timeout_s``. ``termination_reason`` after a follow
    iteration is one of ``"complete"`` | ``"stopped"`` |
    ``"idle_timeout"`` | ``"store_dead"`` (snapshot mode: ``"eos"``).
    """

    def __init__(self, store: ArtifactStore, key: str, *,
                 follow: bool = False, poll_interval_s: float = 0.1,
                 idle_timeout_s: Optional[float] = None,
                 stop_event=None):
        self.store = store
        self.key = key
        self.follow = bool(follow)
        self.poll_interval_s = float(  # host-sync-ok: config scalar
            poll_interval_s)
        self.idle_timeout_s = idle_timeout_s
        self.stop_event = stop_event
        self.consumed = 0
        self.termination_reason: Optional[str] = None
        self.store_error: Optional[str] = None

    def _manifest(self) -> Optional[dict]:
        m = self.store.manifest(self.key)
        if m is not None and m.get("kind") != CORPUS_KIND:
            raise ValueError(
                f"artifact key {self.key!r} holds a "
                f"{m.get('kind', 'unknown')!r} manifest, not a corpus")
        return m

    def _read_shard(self, name: str) -> Iterator[str]:
        path = os.path.join(self.store.cache_dir(self.key), name)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    self.consumed += 1
                    yield line

    def __iter__(self) -> Iterator[str]:
        self.termination_reason = None
        self.store_error = None
        if not self.follow:
            m = self._manifest() or {"shards": []}
            for name in m["shards"]:
                yield from self._read_shard(name)
            self.termination_reason = "eos"
            return
        done = 0
        idle = 0.0
        seen = False
        while True:
            if self.stop_event is not None and self.stop_event.is_set():
                self.termination_reason = "stopped"
                return
            m = self._manifest()
            if m is None:
                if seen:
                    # the bucket existed and is now gone — the store
                    # died under us; idling until idle_timeout would
                    # hide that from the consumer
                    self.termination_reason = "store_dead"
                    self.store_error = (
                        f"manifest for {self.key!r} vanished after "
                        f"{done} shard(s)")
                    return
                m = {"shards": [], "complete": False}
            else:
                seen = True
            shards = m["shards"]
            if done < len(shards):
                idle = 0.0
                for name in shards[done:]:
                    try:
                        yield from self._read_shard(name)
                    except OSError as e:
                        # manifest-listed shard unreadable: a sealed
                        # shard never disappears in a healthy store
                        self.termination_reason = "store_dead"
                        self.store_error = str(e)
                        return
                    done += 1
                continue
            if m.get("complete"):
                self.termination_reason = "complete"
                return
            time.sleep(self.poll_interval_s)
            idle += self.poll_interval_s
            if (self.idle_timeout_s is not None
                    and idle >= self.idle_timeout_s):
                self.termination_reason = "idle_timeout"
                return

    def reset(self):
        """Snapshot mode re-iterates from the first shard anyway; kept
        for SentenceIterator protocol compatibility."""


def spool_stream(sentences: Iterable[str], store: ArtifactStore,
                 key: str, *, shard_sentences: int = 10000,
                 writer: Optional[CorpusShardWriter] = None) -> int:
    """Drain a sentence stream (e.g. a StreamingSentenceIterator) into
    a corpus bucket; returns the sentence count. The ingest side of the
    broker -> object store -> trainer pipeline."""
    w = writer or CorpusShardWriter(store, key,
                                    shard_sentences=shard_sentences)
    n = w.extend(sentences)
    w.close()
    return n
