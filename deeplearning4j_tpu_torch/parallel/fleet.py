"""FleetRouter: SLO-aware front door over per-model ServingEngine pools.

The port of the JAX package's ``parallel/fleet.py``: plain Python over
the port's engines (``parallel/serving.py``, ``generation/engine.py``).
A ServingEngine is one process serving one model version; this is the
layer that makes a fleet of them operable:

- **Admission control.** Every request passes ``admit()`` before it can
  touch an engine queue. A pool whose pending count (submitted, not yet
  answered) is at its bound sheds immediately — the caller gets a
  ``ShedError`` synchronously, never a Future that hangs behind a full
  queue.
- **SLO-aware shedding.** Each pool runs an AIMD controller over the
  *windowed* p99 from ``LatencyRing.delta_quantiles()`` (observations
  since the last tick only — the full 4096-sample ring would take
  minutes to forget a spike). p99 over the SLO → shed fraction steps up
  additively; back under → it decays multiplicatively. The fraction is
  capped below 1.0 so a recovering pool always sees enough traffic to
  measure itself.
- **Per-model pools, least-loaded dispatch.** A pool holds N engines of
  the active version; each request goes to the engine with the fewest
  in-flight requests.
- **Hot version swap + rollback.** ``swap()`` builds and *warms* the new
  version's engines first, then switches the active pointer atomically
  and keeps the previous version warm as the rollback standby.
  ``rollback()`` switches back instantly. ``promote_params`` /
  ``rollback_params`` push new weights into the warm engines instead
  (``ServingEngine.swap_params``). The zoo is a first-class model
  source: pools accept a built model, a zoo model instance/class, a zoo
  entry name ("LeNet", resolved against the port's ``zoo.models``), or a
  factory callable.
- **Generation pools.** ``add_generation_pool`` puts a GenerationEngine
  behind the same admission control, shedding on its per-token p99;
  ``generate(session=...)`` routes a resumable session to the pool
  already holding its carry.

- **Int8 pools and their accuracy gate.** A pool whose engines run
  ``precision`` int8 (a ``PrecisionPolicy``) and that has a
  ``quant_gate`` (evaluation/quant_gate.py) runs the quantized-vs-f32
  gate before a version's engines are built, at creation and at every
  ``swap``: a failing version raises ``QuantGateError``, never warms and
  never flips, and the active version keeps serving.
  ``dl4j_fleet_quant_gate_total{model, outcome=pass|fail}`` counts the
  runs.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
queue 1 item: retrieval pools (item 13), the persisted AOT cache (item
12) and tuned configs (item 16).

Environment knobs (all read at router construction):

- ``DL4J_FLEET_WINDOW_S``     controller tick period, s (default 1.0)
- ``DL4J_FLEET_SHED_STEP``    additive shed-fraction step (default 0.2)
- ``DL4J_FLEET_SHED_DECAY``   multiplicative decay under SLO (default 0.5)
- ``DL4J_FLEET_SHED_MAX``     shed-fraction cap < 1 (default 0.95)
- ``DL4J_FLEET_MAX_PENDING``  per-pool pending bound (default 256)

Prometheus series (the metrics registry, scraped at ``/metrics``):
``dl4j_fleet_admitted_total{model}``, ``dl4j_fleet_shed_total{model,
reason=queue|slo|deadline}``, ``dl4j_fleet_swap_total{model, event=swap|
rollback|param_swap|param_rollback}``, ``dl4j_fleet_pool_depth{model}``,
``dl4j_fleet_shed_fraction{model}``, ``dl4j_fleet_p99_ms{model}``,
``dl4j_fleet_pool_engines{model}``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.evaluation.quant_gate import (
    QuantGateError, enforce_quant_gate)
from deeplearning4j_tpu_torch.observe.latency import LatencyRing
from deeplearning4j_tpu_torch.observe.registry import default_registry
from deeplearning4j_tpu_torch.parallel.deadline import Deadline
from deeplearning4j_tpu_torch.parallel.serving import ServingEngine


class ShedError(RuntimeError):
    """Request refused by admission control — raised synchronously from
    ``submit``/``output`` so a shed caller fails fast instead of holding
    a Future that will never resolve. ``reason`` is ``"queue"`` (pool
    pending bound hit), ``"slo"`` (p99-over-SLO shedding), or
    ``"deadline"`` (the request's deadline already expired at the front
    door — it never touches an engine queue, let alone the device)."""

    def __init__(self, model: str, reason: str, detail: str):
        super().__init__(
            f"request shed by fleet admission control "
            f"(model={model!r}, reason={reason}): {detail}")
        self.model = model
        self.reason = reason


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"FleetRouter: {what} is not ported yet (ROADMAP.md, queue 1 "
        f"item {item})")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _materialize(model, name: str, device=None):
    """Accept a built model, a zoo model instance/class, a zoo entry
    name, or a zero-arg factory; return a built, initialized model. A
    zoo entry is initialized on ``device`` (default: the card)."""
    if isinstance(model, str):
        from deeplearning4j_tpu_torch.zoo import models as zoo_models
        cls = getattr(zoo_models, model, None)
        if cls is None:
            raise ValueError(f"pool {name!r}: no zoo model named "
                             f"{model!r}")
        model = cls
    if isinstance(model, type):
        model = model()
    if hasattr(model, "init") and not hasattr(model, "output") \
            and not hasattr(model, "build_inference_fn"):
        model = model.init(device=device)     # zoo entry
    elif callable(model) and not hasattr(model, "output") \
            and not hasattr(model, "build_inference_fn"):
        model = model()                 # factory
    return model


class ModelPool:
    """One model's replica pool: N engines of the active version plus an
    optional warm standby (the previous version, for rollback)."""

    def __init__(self, name: str, router: "FleetRouter",
                 engine_kwargs: Dict[str, Any], pool_size: int,
                 slo_ms: Optional[float], quant_gate=None):
        self.name = name
        self.router = router
        self.engine_kwargs = dict(engine_kwargs)
        self.pool_size = int(pool_size)
        self.slo_ms = slo_ms
        self.quant_gate = quant_gate
        self.gate_results: List[Any] = []   # GateResult per (re)build
        self.lock = threading.Lock()
        self.engines: List[ServingEngine] = []
        self.active_version: Optional[str] = None
        self.standby: Optional[Tuple[str, List[ServingEngine]]] = None
        # param-only standby: (version, host params, host model_state)
        # captured by promote_params before it overwrites the committed
        # params — the rollback target for the online-learning path
        self.param_standby: Optional[Tuple[Optional[str], Any, Any]] = \
            None
        self.ring = LatencyRing()
        self.pending = 0
        self.shed_fraction = 0.0
        self.windowed_p99_ms: Optional[float] = None
        self._last_tick = time.monotonic()
        self._rand = random.Random()

    # ---- admission -------------------------------------------------------
    def _tick_controller(self, now: float):
        """AIMD over the windowed p99 (caller holds ``self.lock``)."""
        r = self.router
        if now - self._last_tick < r.window_s:
            return
        self._last_tick = now
        q = self.ring.delta_quantiles((0.99,))
        if not q:
            # no traffic this window: decay toward open admission so an
            # idle (or fully-shed) pool can recover
            self.shed_fraction *= r.shed_decay
            if self.shed_fraction < 0.01:
                self.shed_fraction = 0.0
        else:
            self.windowed_p99_ms = q[0.99] * 1e3
            r._g_p99.set(self.windowed_p99_ms, model=self.name)
            if self.slo_ms is not None \
                    and self.windowed_p99_ms > self.slo_ms:
                self.shed_fraction = min(
                    r.shed_max, self.shed_fraction + r.shed_step)
            else:
                self.shed_fraction *= r.shed_decay
                if self.shed_fraction < 0.01:
                    self.shed_fraction = 0.0
        r._g_shed_fraction.set(self.shed_fraction, model=self.name)

    def admit(self, deadline: Optional[Deadline] = None):
        """Raise ``ShedError`` or return (never blocks, never queues).
        An already-expired ``deadline`` sheds here — reason
        ``"deadline"`` — before the request can consume a pending slot
        or an engine queue entry."""
        r = self.router
        if deadline is not None and deadline.expired:
            r._c_shed.inc(1.0, model=self.name, reason="deadline")
            raise ShedError(
                self.name, "deadline",
                "deadline expired before admission")
        with self.lock:
            self._tick_controller(time.monotonic())
            if self.pending >= r.max_pending:
                r._c_shed.inc(1.0, model=self.name, reason="queue")
                raise ShedError(
                    self.name, "queue",
                    f"{self.pending} pending >= bound {r.max_pending}")
            if self.shed_fraction > 0.0 \
                    and self._rand.random() < self.shed_fraction:
                r._c_shed.inc(1.0, model=self.name, reason="slo")
                raise ShedError(
                    self.name, "slo",
                    f"windowed p99 {self.windowed_p99_ms:.1f} ms over "
                    f"SLO {self.slo_ms:.1f} ms; shedding "
                    f"{self.shed_fraction:.0%} of arrivals")
            # released by submit()'s error path and its done callback
            self.pending += 1
            r._g_depth.set(self.pending, model=self.name)
        r._c_admitted.inc(1.0, model=self.name)

    # ---- dispatch --------------------------------------------------------
    @property
    def device(self):
        """The device the active version serves on."""
        with self.lock:
            return self.engines[0].device

    def least_loaded(self) -> ServingEngine:
        with self.lock:
            return min(self.engines, key=lambda e: e.inflight)

    def submit(self, features,
               deadline: Optional[Deadline] = None) -> Future:
        self.admit(deadline)
        t0 = time.perf_counter()
        try:
            f = self.least_loaded().submit(features, deadline=deadline)
        except BaseException:
            with self.lock:
                self.pending -= 1
                self.router._g_depth.set(self.pending, model=self.name)
            raise

        def done(_f):
            self.ring.record(time.perf_counter() - t0)
            with self.lock:
                self.pending -= 1
                self.router._g_depth.set(self.pending, model=self.name)
        f.add_done_callback(done)
        return f

    def stats(self) -> Dict[str, Any]:
        with self.lock:
            engines = list(self.engines)
            out = {
                "active_version": self.active_version,
                "standby_version": self.standby[0] if self.standby
                else None,
                "param_standby_version": self.param_standby[0]
                if self.param_standby else None,
                "pool_size": len(engines),
                "pending": self.pending,
                "shed_fraction": self.shed_fraction,
                "windowed_p99_ms": self.windowed_p99_ms,
                "slo_ms": self.slo_ms,
            }
        if self.gate_results:
            out["quant_gate"] = self.gate_results[-1].summary()
        out["requests"] = self.ring.count
        out["latency_ms"] = {f"p{int(k * 100)}": v * 1e3
                             for k, v in self.ring.quantiles().items()}
        out["engines"] = [{"session": e.session_id,
                           "precision": e.precision,
                           "inflight": e.inflight,
                           "recompiles_after_warmup":
                               e.recompiles_after_warmup,
                           "warmup_s": e.warmup_seconds}
                          for e in engines]
        return out


class GenerationPool:
    """Admission-controlled front for one GenerationEngine (decode
    serving — generation/engine.py). Shares ModelPool's AIMD controller
    verbatim, but the latency signal is the engine's per-TOKEN ring and
    the SLO is ``slo_token_ms``: decode sheds when the *token cadence*
    degrades, not when whole-sequence wall time (which scales with
    requested length) does. ``pending`` counts sequences from admission
    until their stream finishes — a long-lived stream holds its
    admission slot the whole way, so the queue bound caps concurrent
    sequences, not just the submit burst.

    An int8 head needs no gate here: the engine runs the decode-level
    quant gate at construction and refuses to build on a miss."""

    def __init__(self, name: str, router: "FleetRouter", engine,
                 slo_token_ms: Optional[float] = None):
        self.name = name
        self.router = router
        self.engine = engine
        self.slo_ms = slo_token_ms
        self.ring = engine.token_ring   # recorded by the engine per tick
        self.lock = threading.Lock()
        self.pending = 0
        self.shed_fraction = 0.0
        self.windowed_p99_ms: Optional[float] = None
        self._last_tick = time.monotonic()
        self._rand = random.Random()

    # same AIMD + admission body as ModelPool — the fields line up by
    # construction, and sharing the code keeps the two front doors'
    # shedding behavior from drifting apart
    _tick_controller = ModelPool._tick_controller
    admit = ModelPool.admit

    def submit(self, prompt, deadline: Optional[Deadline] = None, **kw):
        """Admit, then queue on the engine; returns the
        GenerationStream. An engine-side queue-full becomes a
        ``ShedError(reason="queue")`` like any other admission refusal.
        """
        self.admit(deadline)
        r = self.router
        try:
            stream = self.engine.submit(prompt, deadline=deadline, **kw)
        except BaseException as e:
            with self.lock:
                self.pending -= 1
                r._g_depth.set(self.pending, model=self.name)
            if isinstance(e, RuntimeError) and "queue full" in str(e):
                r._c_shed.inc(1.0, model=self.name, reason="queue")
                raise ShedError(self.name, "queue", str(e))
            raise

        def done(_s):
            with self.lock:
                self.pending -= 1
                r._g_depth.set(self.pending, model=self.name)
        stream.add_done_callback(done)
        return stream

    def stats(self) -> Dict[str, Any]:
        with self.lock:
            out = {
                "pending": self.pending,
                "shed_fraction": self.shed_fraction,
                "windowed_token_p99_ms": self.windowed_p99_ms,
                "slo_token_ms": self.slo_ms,
            }
        out["engine"] = self.engine.stats()
        return out


class FleetRouter:
    """Front door over named ModelPools. Thread-safe."""

    def __init__(self, *, slo_ms: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 window_s: Optional[float] = None,
                 aot_cache_dir: Optional[str] = None,
                 tuned_config=None,
                 registry=None, session_id: str = "fleet",
                 device=None):
        if aot_cache_dir is not None:
            raise _not_ported("the persisted AOT cache (aot_cache_dir)",
                              12)
        if tuned_config is not None:
            raise _not_ported("tuned configs (tuned_config)", 16)
        self.slo_ms = slo_ms
        self.session_id = session_id
        # where zoo-name and zoo-class pools are initialized (default:
        # the card); built models serve on their own device
        self.device = device
        self.registry = registry if registry is not None \
            else default_registry()
        self.window_s = window_s if window_s is not None \
            else _env_float("DL4J_FLEET_WINDOW_S", 1.0)
        self.shed_step = _env_float("DL4J_FLEET_SHED_STEP", 0.2)
        self.shed_decay = _env_float("DL4J_FLEET_SHED_DECAY", 0.5)
        self.shed_max = min(0.999,
                            _env_float("DL4J_FLEET_SHED_MAX", 0.95))
        self.max_pending = int(max_pending) if max_pending is not None \
            else int(_env_float("DL4J_FLEET_MAX_PENDING", 256))
        self._pools: Dict[str, ModelPool] = {}
        self._gen_pools: Dict[str, GenerationPool] = {}
        self._pools_lock = threading.Lock()
        self._shutdown = False

        reg = self.registry
        self._c_admitted = reg.counter(
            "dl4j_fleet_admitted_total",
            "requests admitted past the fleet front door, per model")
        self._c_shed = reg.counter(
            "dl4j_fleet_shed_total",
            "requests shed by admission control, per model; reason="
            "queue (pending bound) | slo (p99-over-SLO shedding) | "
            "deadline (expired before admission)")
        self._c_swap = reg.counter(
            "dl4j_fleet_swap_total",
            "model-version swaps, per model; event=swap|rollback")
        self._c_gate = reg.counter(
            "dl4j_fleet_quant_gate_total",
            "quantization accuracy-gate runs before a version is "
            "admitted, per model; outcome=pass|fail")
        self._g_depth = reg.gauge(
            "dl4j_fleet_pool_depth",
            "requests submitted to a pool and not yet answered")
        self._g_shed_fraction = reg.gauge(
            "dl4j_fleet_shed_fraction",
            "current SLO-shedding fraction of the pool's arrivals")
        self._g_p99 = reg.gauge(
            "dl4j_fleet_p99_ms",
            "windowed p99 over the last controller tick's completions")
        self._g_engines = reg.gauge(
            "dl4j_fleet_pool_engines",
            "engines in the pool's active version")

    # ---- pool management -------------------------------------------------
    def _run_quant_gate(self, name: str, model, version: str,
                        engine_kwargs: Dict[str, Any], quant_gate):
        """The hard accuracy gate on the warm-swap path: an int8 pool with
        a gate must pass its quantized-vs-f32 budget before any engine is
        built; a failing version never warms, never flips, and the active
        version is untouched. Returns the GateResult (None when not
        applicable)."""
        precision = engine_kwargs.get("precision")
        if quant_gate is None \
                or getattr(precision, "mode", precision) != "int8":
            return None
        try:
            result = enforce_quant_gate(
                model, precision, quant_gate,
                model_name=f"{name}:{version}", registry=self.registry)
        except QuantGateError:
            self._c_gate.inc(1.0, model=name, outcome="fail")
            raise
        self._c_gate.inc(1.0, model=name, outcome="pass")
        return result

    def _build_engines(self, name: str, model, version: str,
                       engine_kwargs: Dict[str, Any], pool_size: int,
                       quant_gate=None
                       ) -> Tuple[List[ServingEngine], Any]:
        model = _materialize(model, name, self.device)
        gate_result = self._run_quant_gate(name, model, version,
                                           engine_kwargs, quant_gate)
        kw = dict(engine_kwargs)
        kw.setdefault("registry", self.registry)
        engines = [ServingEngine(
            model, model_version=version,
            session_id=f"{self.session_id}-{name}-{version}-{i}", **kw)
            for i in range(pool_size)]
        return engines, gate_result

    def add_pool(self, name: str, model, *, version: str = "v1",
                 pool_size: int = 1, slo_ms: Optional[float] = None,
                 quant_gate=None, **engine_kwargs) -> ModelPool:
        """Create and warm a pool. ``model`` may be a built model, a
        zoo model instance/class, a zoo entry name, or a factory.
        ``quant_gate`` (a QuantGate) makes the int8 accuracy gate a hard
        precondition for this pool, at creation and at every ``swap``,
        when the engines run precision int8."""
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        with self._pools_lock:
            if name in self._pools:
                raise ValueError(f"pool {name!r} already exists")
        pool = ModelPool(name, self, engine_kwargs, pool_size,
                         slo_ms if slo_ms is not None else self.slo_ms,
                         quant_gate=quant_gate)
        pool.engines, gate_result = self._build_engines(
            name, model, version, engine_kwargs, pool_size,
            quant_gate=quant_gate)
        if gate_result is not None:
            pool.gate_results.append(gate_result)
        pool.active_version = version
        with self._pools_lock:
            self._pools[name] = pool
        self._g_engines.set(pool_size, model=name)
        self._g_depth.set(0.0, model=name)
        self._c_admitted.inc(0.0, model=name)
        return pool

    def pool(self, name: Optional[str] = None) -> ModelPool:
        with self._pools_lock:
            if name is None:
                if len(self._pools) != 1:
                    raise ValueError(
                        "model name required: the router serves "
                        f"{sorted(self._pools)}")
                return next(iter(self._pools.values()))
            p = self._pools.get(name)
        if p is None:
            raise ValueError(f"no pool named {name!r}; have "
                             f"{sorted(self._pools)}")
        return p

    @property
    def pools(self) -> Dict[str, ModelPool]:
        with self._pools_lock:
            return dict(self._pools)

    # ---- serving ---------------------------------------------------------
    def submit(self, features, model: Optional[str] = None,
               deadline: Optional[Deadline] = None) -> Future:
        if self._shutdown:
            raise RuntimeError("FleetRouter is shut down")
        return self.pool(model).submit(features, deadline=deadline)

    def output(self, features, model: Optional[str] = None,
               deadline: Optional[Deadline] = None):
        return self.submit(features, model=model,
                           deadline=deadline).result()

    # ---- generative serving ----------------------------------------------
    def add_generation_pool(self, name: str, engine, *,
                            slo_token_ms: Optional[float] = None
                            ) -> GenerationPool:
        """Register a GenerationEngine behind the same admission front
        door as the predict pools (shared ``dl4j_fleet_*`` series, same
        env knobs). ``slo_token_ms`` arms AIMD shedding over the
        engine's windowed per-token p99."""
        with self._pools_lock:
            if name in self._gen_pools or name in self._pools:
                raise ValueError(f"pool {name!r} already exists")
        pool = GenerationPool(name, self, engine,
                              slo_token_ms=slo_token_ms)
        with self._pools_lock:
            self._gen_pools[name] = pool
        self._g_depth.set(0.0, model=name)
        self._c_admitted.inc(0.0, model=name)
        return pool

    def generation_pool(self, name: Optional[str] = None
                        ) -> GenerationPool:
        with self._pools_lock:
            if name is None:
                if len(self._gen_pools) != 1:
                    raise ValueError(
                        "model name required: the router serves "
                        f"generation pools {sorted(self._gen_pools)}")
                return next(iter(self._gen_pools.values()))
            p = self._gen_pools.get(name)
        if p is None:
            raise ValueError(f"no generation pool named {name!r}; "
                             f"have {sorted(self._gen_pools)}")
        return p

    @property
    def generation_pools(self) -> Dict[str, GenerationPool]:
        with self._pools_lock:
            return dict(self._gen_pools)

    def generate(self, prompt, model: Optional[str] = None,
                 deadline: Optional[Deadline] = None, **kw):
        """Admission-controlled decode submit; returns the stream.

        A ``session=`` token routes with affinity when no model is
        named: the pool already holding the carry locally (device tier
        beats host tier) wins, so multi-turn sessions keep resuming
        without a store round-trip; a cold token lands on any pool
        with a session store, which resumes it from the shared
        checkpoint — the cross-node path."""
        if self._shutdown:
            raise RuntimeError("FleetRouter is shut down")
        if model is None and kw.get("session") is not None:
            pool = self._session_affinity(kw["session"])
            if pool is not None:
                return pool.submit(prompt, deadline=deadline, **kw)
        return self.generation_pool(model).submit(
            prompt, deadline=deadline, **kw)

    def _session_affinity(self, token: str
                          ) -> Optional[GenerationPool]:
        with self._pools_lock:
            pools = list(self._gen_pools.values())
        tier_rank = {"device": 3, "host": 2}
        best, best_rank = None, 0
        for p in pools:
            store = getattr(p.engine, "session_store", None)
            if store is None:
                continue
            rank = tier_rank.get(store.resident(token), 1)
            if rank > best_rank:
                best, best_rank = p, rank
        return best

    # ---- retrieval serving (not ported) ---------------------------------
    def add_retrieval_pool(self, name: str, engine, *,
                           slo_ms: Optional[float] = None):
        raise _not_ported("retrieval pools", 13)

    def retrieval_pool(self, name: Optional[str] = None):
        raise _not_ported("retrieval pools", 13)

    def neighbors(self, queries, k: int, model: Optional[str] = None,
                  mode: Optional[str] = None,
                  deadline: Optional[Deadline] = None, **kw):
        raise _not_ported("retrieval pools", 13)

    # ---- version lifecycle -----------------------------------------------
    def swap(self, name: str, model, version: str) -> ModelPool:
        """A/B weight swap: build + warm ``version``'s engines, switch
        the active pointer atomically, keep the previous version warm as
        the rollback standby, and shut down anything older. In-flight
        requests on the old version complete normally. A pool created
        with ``quant_gate`` re-runs the accuracy gate here: a failing
        quantized version raises before any engine is built and the
        active version keeps serving."""
        pool = self.pool(name)
        new_engines, gate_result = self._build_engines(
            name, model, version, pool.engine_kwargs, pool.pool_size,
            quant_gate=pool.quant_gate)
        if gate_result is not None:
            pool.gate_results.append(gate_result)
        with pool.lock:
            retired = pool.standby
            pool.standby = (pool.active_version, pool.engines)
            pool.engines = new_engines
            pool.active_version = version
            # stale latencies must not drive the new version's shedding
            pool.ring.reset()
        self._c_swap.inc(1.0, model=name, event="swap")
        self._g_engines.set(len(new_engines), model=name)
        if retired is not None:
            for e in retired[1]:
                e.shutdown()
        return pool

    def rollback(self, name: str) -> ModelPool:
        """Switch back to the standby version (the one ``swap`` retired
        to warm standby). The rolled-back-from version becomes the new
        standby, so a flapping rollout can flip repeatedly."""
        pool = self.pool(name)
        with pool.lock:
            if pool.standby is None:
                raise RuntimeError(
                    f"pool {name!r} has no standby version to roll "
                    "back to")
            (pool.active_version, pool.engines), pool.standby = \
                pool.standby, (pool.active_version, pool.engines)
            pool.ring.reset()
        self._c_swap.inc(1.0, model=name, event="rollback")
        self._g_engines.set(len(pool.engines), model=name)
        return pool

    # ---- param-only promotion (online learning) --------------------------
    def promote_params(self, name: str, params, model_state=None, *,
                       version: Optional[str] = None) -> ModelPool:
        """Param-only hot promotion: push new weights into the pool's
        warm engines via ``ServingEngine.swap_params`` — **zero
        recompiles**, no new engines, no warmup sweep. The previous
        committed params are captured host-side first and kept as
        ``pool.param_standby`` (the ``rollback_params`` target).

        Each engine's swap is individually atomic; across a multi-
        engine pool there is a brief window where engines serve
        different param versions (same structure, so every request
        still completes normally). Structural validation happens on the
        first engine before anything is overwritten — a mismatched
        candidate raises with the whole pool untouched."""
        pool = self.pool(name)
        with pool.lock:
            engines = list(pool.engines)
            old_version = pool.active_version
        if not engines:
            raise RuntimeError(f"pool {name!r} has no engines")
        standby_params, standby_mstate = engines[0].committed_host()
        for e in engines:
            e.swap_params(params, model_state, version=version)
        with pool.lock:
            pool.param_standby = (old_version, standby_params,
                                  standby_mstate)
            if version is not None:
                pool.active_version = version
            # pre-promotion latencies must not drive the new params'
            # shedding / regression verdicts
            pool.ring.reset()
        self._c_swap.inc(1.0, model=name, event="param_swap")
        return pool

    def rollback_params(self, name: str) -> ModelPool:
        """Restore the ``param_standby`` captured by the last
        ``promote_params`` — bitwise-identical host copies pushed back
        through the same warm executables. The rolled-back-from params
        become the new standby, so a flapping promotion can flip
        repeatedly."""
        pool = self.pool(name)
        with pool.lock:
            standby = pool.param_standby
            engines = list(pool.engines)
            old_version = pool.active_version
        if standby is None:
            raise RuntimeError(
                f"pool {name!r} has no param standby to roll back to")
        if not engines:
            raise RuntimeError(f"pool {name!r} has no engines")
        sv, sp, sm = standby
        current_params, current_mstate = engines[0].committed_host()
        for e in engines:
            e.swap_params(sp, sm, version=sv)
        with pool.lock:
            pool.param_standby = (old_version, current_params,
                                  current_mstate)
            if sv is not None:
                pool.active_version = sv
            pool.ring.reset()
        self._c_swap.inc(1.0, model=name, event="param_rollback")
        return pool

    # ---- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        out = {
            "session": self.session_id,
            "slo_ms": self.slo_ms,
            "max_pending": self.max_pending,
            "window_s": self.window_s,
            "pools": {name: p.stats()
                      for name, p in self.pools.items()},
        }
        gen = self.generation_pools
        if gen:
            out["generation"] = {name: p.stats()
                                 for name, p in gen.items()}
        return out

    def assert_warm(self):
        """Every engine in every pool (active + standby) holds the
        zero-live-compile contract."""
        for pool in self.pools.values():
            with pool.lock:
                engines = list(pool.engines)
                if pool.standby is not None:
                    engines += list(pool.standby[1])
            for e in engines:
                e.assert_warm()
        for gp in self.generation_pools.values():
            gp.engine.assert_warm()

    # ---- lifecycle -------------------------------------------------------
    def shutdown(self):
        self._shutdown = True
        for pool in self.pools.values():
            with pool.lock:
                engines = list(pool.engines)
                if pool.standby is not None:
                    engines += list(pool.standby[1])
                pool.standby = None
            for e in engines:
                e.shutdown()
        for gp in self.generation_pools.values():
            gp.engine.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
