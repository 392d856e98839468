"""UI module SPI (reference: deeplearning4j-play/.../api/UIModule.java —
modules contribute Routes and receive the attached StatsStorage; the
Play server discovers them and merges their routes into the dashboard).

A module declares ``get_routes()`` → [Route]; ``UIServer.
register_module`` merges them (built-in routes win on conflict, like
the reference's core TrainModule). Handlers are plain callables:

    handler(ctx: UIModuleContext, query: dict, body: dict | None)
        -> dict (JSON) | (bytes, content_type)

``ctx.storage`` is the attached StatsStorage — the same object pushed
to the reference modules through onAttach/StatsStorageEvent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass(frozen=True)
class Route:
    """One HTTP route contributed by a module (reference: Route.java —
    method + path + the function producing the result)."""
    method: str                    # "GET" | "POST"
    path: str                      # e.g. "/api/mymodule/data"
    handler: Callable              # handler(ctx, query, body)

    def __post_init__(self):
        if self.method not in ("GET", "POST"):
            raise ValueError(f"unsupported method {self.method!r}")
        if not self.path.startswith("/"):
            raise ValueError(f"route path must start with '/': "
                             f"{self.path!r}")


@dataclasses.dataclass
class UIModuleContext:
    """What a handler sees: the attached storage + the live server,
    plus the request headers (an ``email.message.Message``-like mapping,
    or None in direct-call tests) so handlers can read per-request
    metadata like ``X-Deadline-Ms``."""
    storage: object
    server: object
    headers: object = None


class UIModule:
    """SPI base (reference: UIModule.java). Subclass and implement
    ``get_routes``; override ``on_attach`` to observe the storage."""

    def get_routes(self) -> List[Route]:
        raise NotImplementedError

    def on_attach(self, storage) -> None:
        """Called when a StatsStorage is attached (reference:
        UIModule.onAttach)."""

    def on_update(self, record: dict) -> None:
        """Called for every remote-routed record the server receives
        (reference: UIModule.reportStorageEvents)."""
