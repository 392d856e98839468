"""GenerationModule: the HTTP surface for decode serving.

- ``POST /api/generate``  {"prompt": str|[ids], "max_new_tokens"?,
  "greedy"?, "temperature"?, "top_k"?, "seed"?, "stop"?, "stream"?,
  "model"?, "session"?}

  ``"session"`` names a resumable carry: the engine continues the
  session's (h, c)/PRNG state instead of replaying the prefix, and
  re-captures it when the sequence retires — including across nodes
  via the shared ArtifactStore checkpoint (see generation/session.py).
  The terminal event echoes the token back.

  With ``"stream": true`` (the default) the response is a
  ``text/event-stream``: one ``data:`` event per sampled token
  (``{"token": id, "text": ch, "i": n}``) and a terminal
  ``{"done": true, "reason": ..., "n": ..., "ttft_ms": ...}`` —
  tokens arrive as they decode, riding ui/server.py's generator-payload
  streaming. ``"stream": false`` blocks and answers one JSON object.

  Behind a FleetRouter the submit passes admission control; a shed
  answers **HTTP 503** + Retry-After exactly like the predict route,
  BEFORE any stream bytes go out. An engine-only module maps its
  queue-full refusal the same way. An ``X-Deadline-Ms`` header or
  ``"deadline_ms"`` body field arms an end-to-end deadline: expired at
  submit → **HTTP 504** ``{"error": "deadline"}`` before any stream
  bytes; expired mid-decode → the sequence retires with reason
  ``"deadline"``. A client that disconnects mid-stream cancels its
  sequence and frees the slot (``dl4j_gen_client_disconnect_total``).

- ``GET /api/generation/stats``  engine snapshot: per-token p50/p99,
  time-to-first-token, active/max slots, retirement outcomes, stream
  errors, recompiles-after-warmup (plus admission state when routed).

The ``dl4j_gen_*`` Prometheus family is scraped from the server's
existing ``/metrics``; this module only adds the JSON/SSE ingress.
"""

from __future__ import annotations

import math
from typing import List

from deeplearning4j_tpu_torch.parallel.deadline import Deadline, DeadlineExceeded
from deeplearning4j_tpu_torch.ui.modules import Route, UIModule

_RESULT_TIMEOUT_S = 300.0


class GenerationModule(UIModule):
    """Routes for one GenerationEngine, optionally behind a
    FleetRouter's admission control (pass ``router`` + the pool's
    ``model`` name)."""

    def __init__(self, engine=None, router=None, model=None):
        if (engine is None) == (router is None):
            raise ValueError("pass exactly one of engine= or router=")
        self.engine = engine
        self.router = router
        self.model = model

    def get_routes(self) -> List[Route]:
        return [
            Route("POST", "/api/generate", self._generate),
            Route("GET", "/api/generation/stats", self._stats),
        ]

    def _submit(self, body, deadline=None):
        kw = {}
        for key in ("max_new_tokens", "top_k", "seed"):
            if key in body:
                kw[key] = int(body[key])
        if "temperature" in body:
            kw["temperature"] = float(body["temperature"])
        if "greedy" in body:
            kw["greedy"] = bool(body["greedy"])
        if "stop" in body:
            kw["stop"] = body["stop"]
        if body.get("session") is not None:
            # resumable-session token: the engine restores the carry
            # (local tier or cross-node store checkpoint) and re-saves
            # it at retirement; behind a router it also picks the pool
            # already holding the carry (session affinity)
            kw["session"] = str(body["session"])
        prompt = body.get("prompt", "")
        if self.router is not None:
            return self.router.generate(
                prompt, model=body.get("model", self.model),
                deadline=deadline, **kw)
        return self.engine.submit(prompt, deadline=deadline, **kw)

    def _generate(self, ctx, query, body):
        from deeplearning4j_tpu_torch.parallel.fleet import ShedError
        if not isinstance(body, dict):
            raise ValueError('expected {"prompt": ...}')
        deadline = Deadline.from_ingress(getattr(ctx, "headers", None), body)
        try:
            stream = self._submit(body, deadline=deadline)
        except DeadlineExceeded:
            return ({"error": "deadline", "reason": "deadline"},
                    None, 504)
        except ShedError as e:
            if e.reason == "deadline":
                return ({"error": "deadline", "model": e.model,
                         "reason": "deadline"}, None, 504)
            retry_after = max(1, int(math.ceil(
                getattr(self.router, "window_s", 1.0))))
            return ({"error": "shed", "model": e.model,
                     "reason": e.reason},
                    {"Retry-After": str(retry_after)}, 503)
        except RuntimeError as e:
            if "queue full" in str(e):
                return ({"error": "shed", "reason": "queue"},
                        {"Retry-After": "1"}, 503)
            raise
        if not body.get("stream", True):
            res = stream.result(timeout=_RESULT_TIMEOUT_S)
            vocab = self._vocab()
            res["text"] = vocab.decode(res["ids"]) if vocab else None
            if res.get("reason") == "deadline":
                # budget ran out mid-decode: the partial result ships,
                # but under 504 so the caller knows it was truncated
                return (res, None, 504)
            return res
        return self._sse(stream)

    def _engine(self):
        if self.engine is not None:
            return self.engine
        try:
            return self.router.generation_pool(self.model).engine
        except Exception:
            return None

    def _vocab(self):
        eng = self._engine()
        return eng.vocab if eng is not None else None

    def _sse(self, stream):
        """Generator payload for ui/server.py's event-stream path. The
        server close()s this generator when the client disconnects
        mid-stream; the finally turns that into an engine-level cancel
        (``dl4j_gen_client_disconnect_total``) so the scheduler retires
        the slot — even one still in prefill — and frees it for the
        next sequence instead of decoding into the void."""
        def events():
            try:
                for ev in stream:
                    yield ev
            finally:
                if not stream.done:
                    eng = self._engine()
                    if eng is not None:
                        eng.cancel(stream, disconnect=True)
                    else:
                        stream.cancel()
        return events()

    def _stats(self, ctx, query, body):
        if self.router is not None:
            return self.router.generation_pool(self.model).stats()
        return self.engine.stats()
