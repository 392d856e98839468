"""Sentence / document iterators.

Analog of the reference's text/sentenceiterator/ and text/documentiterator/
(SURVEY §2.7): streams of sentences (strings) or labelled documents feeding
vocab construction and training. Python iterables replace the reference's
hasNext/nextSentence protocol; ``reset()`` restarts the stream.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, List, Optional


class SentenceIterator:
    """reference: sentenceiterator/SentenceIterator.java"""

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    """In-memory list of sentences (reference: sentenceiterator/
    CollectionSentenceIterator.java)."""

    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)

    def __iter__(self) -> Iterator[str]:
        return iter(self._sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference: sentenceiterator/
    BasicLineIterator.java)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[str]:
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, line by line (reference:
    sentenceiterator/FileSentenceIterator.java)."""

    def __init__(self, root: str):
        self.root = root

    def __iter__(self) -> Iterator[str]:
        if os.path.isfile(self.root):
            yield from BasicLineIterator(self.root)
            return
        for dirpath, _dirs, files in os.walk(self.root):
            for name in sorted(files):
                yield from BasicLineIterator(os.path.join(dirpath, name))


@dataclasses.dataclass
class LabelledDocument:
    """reference: documentiterator/LabelledDocument.java"""
    content: str
    labels: List[str]

    @property
    def label(self) -> Optional[str]:
        return self.labels[0] if self.labels else None


class LabelAwareIterator:
    """reference: documentiterator/LabelAwareIterator.java"""

    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionLabelledDocumentIterator(LabelAwareIterator):
    def __init__(self, docs: Iterable[LabelledDocument]):
        self._docs = list(docs)

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self._docs)


class SentenceLabelledIterator(LabelAwareIterator):
    """Wrap a SentenceIterator, auto-assigning DOC_<n> labels (reference:
    ParagraphVectors falls back to synthetic labels via
    documentiterator/DocumentIterator adapters)."""

    def __init__(self, sentences: Iterable[str], prefix: str = "DOC_"):
        self._sentences = list(sentences)
        self._prefix = prefix

    def __iter__(self) -> Iterator[LabelledDocument]:
        for i, s in enumerate(self._sentences):
            yield LabelledDocument(s, [f"{self._prefix}{i}"])


#: end-of-stream marker frame for broker-fed sentence topics
SENTENCE_EOS = b""


def publish_sentences(transport, sentences: Iterable[str],
                      topic: str = "sentences", *,
                      eos: bool = True) -> int:
    """Feed a sentence stream into a broker topic, one UTF-8 frame per
    sentence; ``eos=True`` appends the empty end-of-stream frame so a
    ``StreamingSentenceIterator`` terminates instead of idling out.
    Returns the number of sentences published."""
    n = 0
    for s in sentences:
        s = s.strip()
        if not s:
            continue
        transport.publish(topic, s.encode("utf-8"))
        n += 1
    if eos:
        transport.publish(topic, SENTENCE_EOS)
    return n


class StreamingSentenceIterator(SentenceIterator):
    """Broker-backed unbounded sentence stream (streaming/broker.py):
    one UTF-8 frame per sentence, over any Transport — InProcess for
    tests, TcpTransport across processes (the DataVec-streaming shape,
    SURVEY §2.11). Iteration ends on the empty end-of-stream frame, a
    ``max_sentences`` cap, a set ``stop_event``, or ``idle_timeout_s``
    with nothing arriving.

    The stream is unbounded and consume-once: ``reset()`` is a no-op,
    so this iterator feeds windowed consumers (``Word2Vec.fit_stream``)
    or a ``CorpusShardWriter`` spool — not multi-pass ``fit``.

    A dead broker is NOT a quiet topic: a transport whose retries are
    exhausted (``ConnectionError``/``OSError`` out of ``poll``)
    terminates the stream immediately with ``termination_reason =
    "transport_dead"`` (and the error text in ``transport_error``)
    instead of idling silently until ``idle_timeout_s`` — before this,
    the two cases were indistinguishable to the consumer.
    ``termination_reason`` after iteration is one of ``"eos"`` |
    ``"max_sentences"`` | ``"stopped"`` | ``"idle_timeout"`` |
    ``"transport_dead"``."""

    def __init__(self, transport, topic: str = "sentences", *,
                 poll_timeout_s: float = 0.2,
                 idle_timeout_s: Optional[float] = None,
                 max_sentences: Optional[int] = None,
                 stop_event=None):
        self.transport = transport
        self.topic = topic
        self.poll_timeout_s = float(poll_timeout_s)
        self.idle_timeout_s = idle_timeout_s
        self.max_sentences = max_sentences
        self.stop_event = stop_event
        self.consumed = 0
        self.termination_reason: Optional[str] = None
        self.transport_error: Optional[str] = None

    def __iter__(self) -> Iterator[str]:
        import time
        self.termination_reason = None
        self.transport_error = None
        idle = 0.0
        while True:
            if self.stop_event is not None and self.stop_event.is_set():
                self.termination_reason = "stopped"
                return
            if (self.max_sentences is not None
                    and self.consumed >= self.max_sentences):
                self.termination_reason = "max_sentences"
                return
            t0 = time.monotonic()
            try:
                payload = self.transport.poll(self.topic,
                                              self.poll_timeout_s)
            except (ConnectionError, OSError) as e:
                self.termination_reason = "transport_dead"
                self.transport_error = str(e)
                return
            if payload is None:
                idle += time.monotonic() - t0
                if (self.idle_timeout_s is not None
                        and idle >= self.idle_timeout_s):
                    self.termination_reason = "idle_timeout"
                    return
                continue
            idle = 0.0
            if payload == SENTENCE_EOS:
                self.termination_reason = "eos"
                return
            s = payload.decode("utf-8", errors="replace").strip()
            if s:
                self.consumed += 1
                yield s
