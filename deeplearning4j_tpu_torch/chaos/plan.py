"""Deterministic, seedable fault injection for the serving cluster.

The cluster's failure story used to be one hand-rolled SIGKILL in the
chaos soak. This module makes every rehearsed failure *injectable and
replayable*: a :class:`FaultPlan` holds a list of :class:`FaultSpec`
clauses, each targeting one named **site** (a seam the stack already
exposes — the remote dispatcher's transport call, the registry's
record write, the artifact store's blob write, the broker's frame ops,
the ui request handler) with one fault **kind**. Whether a given site
hit injects is decided by a counter-based splitmix64 draw — the same
PRNG discipline as ``nlp/pairgen.py`` — so a plan seed fully
determines the injection sequence: same seed ⇒ bitwise-identical
draws ⇒ identical faults, which is what lets the chaos-matrix test
assert *replay* rather than eyeball flakes.

Arming::

    DL4J_CHAOS="seed=42;remote.send:delay(p=0.25,ms=40);store.save:corrupt(count=1)"

or programmatically::

    from deeplearning4j_tpu_torch import chaos
    chaos.arm("seed=7;registry.write:torn_write(count=1)")
    ...build the objects under test...   # sites bind at construction
    chaos.disarm()

Grammar: semicolon-separated clauses; ``seed=N`` sets the plan seed;
every other clause is ``site:kind`` or ``site:kind(k=v,...)`` with
params ``p`` (injection probability, default 1), ``count`` (max
injections for this spec), ``after`` (skip the first N site hits),
``ms`` (delay magnitude), ``skew_ms`` (clock-skew magnitude), ``arg``
(only inject when the caller's site argument — node id, topic, path —
equals this string).

Site vocabulary (what each instrumented seam understands):

    remote.send      delay | error | timeout          arg = node id
    remote.clock     clock_skew
    registry.write   torn_write | error               arg = node id
    store.save       torn_write | corrupt
    broker.publish   delay | error                    arg = topic
    broker.poll      delay | error                    arg = topic
    ui.request       delay | error | kill             arg = path
    serve.dispatch   delay | error
    neighbors.fanout error                            arg = node id

Every injection lands in ``plan.trace`` as ``(site, kind, hit, draw)``
and increments ``dl4j_chaos_injected_total{site,kind}``. Determinism
caveat: the per-site hit counter orders draws by *call order*, so
bitwise replay holds exactly when the driver is deterministic
(single-threaded matrix tests); under concurrent load the plan is
still seeded-random per hit, just not sequence-reproducible.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

# splitmix64 — constants and mix identical to nlp/pairgen.py, so the
# chaos stream is the same bitwise-portable PRNG the trainers use
GOLDEN = 0x9E3779B97F4A7C15
M1 = 0xBF58476D1CE4E5B9
M2 = 0x94D049BB133111EB
_MASK = (1 << 64) - 1
_U53 = 1.0 / 9007199254740992.0          # 2**-53

KINDS = ("delay", "error", "timeout", "torn_write", "corrupt",
         "clock_skew", "kill")

KILL_EXIT_CODE = 137                      # SIGKILL's conventional rc


def _mix(z: int) -> int:
    z &= _MASK
    z ^= z >> 30
    z = (z * M1) & _MASK
    z ^= z >> 27
    z = (z * M2) & _MASK
    z ^= z >> 31
    return z


def site_seed(plan_seed: int, name: str) -> int:
    """Per-site stream seed: the plan seed folded with the site name,
    byte by byte, so every site draws from an independent stream."""
    z = _mix((plan_seed & _MASK) ^ 0x4348414F53000000)      # "CHAOS"
    for b in name.encode("utf-8"):
        z = _mix(z ^ ((b * M2) & _MASK))
    return z


class ChaosError(RuntimeError):
    """The injected failure — distinguishable from organic errors in
    logs, indistinguishable to the resilience machinery under test."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One clause of a plan: inject ``kind`` at ``site`` with
    probability ``p`` per hit, at most ``count`` times, skipping the
    first ``after`` hits, optionally filtered to one caller ``arg``."""
    site: str
    kind: str
    p: float = 1.0
    count: Optional[int] = None
    after: int = 0
    ms: float = 0.0
    skew_ms: float = 0.0
    arg: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} out of [0, 1]")


class Injection:
    """One landed fault: what the caller must act out. ``kind`` says
    how — sleep ``delay_s``, raise, mangle bytes via ``corrupted()``,
    or add ``skew_s`` to the clock."""

    __slots__ = ("site", "kind", "hit", "draw", "spec")

    def __init__(self, site: str, hit: int, draw: int, spec: FaultSpec):
        self.site = site
        self.kind = spec.kind
        self.hit = hit
        self.draw = draw
        self.spec = spec

    @property
    def delay_s(self) -> float:
        return self.spec.ms / 1e3

    @property
    def skew_s(self) -> float:
        return self.spec.skew_ms / 1e3

    def error(self) -> ChaosError:
        return ChaosError(
            f"chaos: injected {self.kind} at {self.site} "
            f"(hit {self.hit})")

    def corrupted(self, data: bytes) -> bytes:
        """Deterministically mangle a byte payload: ``torn_write``
        truncates (the torn half of an interrupted write), ``corrupt``
        flips one draw-addressed byte (bit rot)."""
        if self.kind == "torn_write":
            return data[: len(data) // 2]
        if self.kind == "corrupt":
            if not data:
                return data
            i = self.draw % len(data)
            return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        return data

    def __repr__(self):
        return (f"Injection({self.site}:{self.kind} hit={self.hit} "
                f"draw={self.draw:#x})")


class _Site:
    """The handle an instrumented seam holds. ``hit()`` is the
    primitive (one counter bump + at most one draw); ``fail``,
    ``mangle`` and ``skew`` wrap the common act-out patterns so call
    sites stay one line."""

    __slots__ = ("_plan", "name", "_specs", "_seed")

    def __init__(self, plan: "FaultPlan", name: str,
                 specs: List[FaultSpec]):
        self._plan = plan
        self.name = name
        self._specs = specs
        self._seed = site_seed(plan.seed, name)

    def hit(self, arg: Optional[str] = None) -> Optional[Injection]:
        plan = self._plan
        with plan._lock:
            k = plan._counters.get(self.name, 0)
            plan._counters[self.name] = k + 1
            draw = _mix(self._seed + ((k + 1) * GOLDEN & _MASK))
            for spec in self._specs:
                if spec.arg is not None and arg != spec.arg:
                    continue
                if k < spec.after:
                    continue
                fired = plan._fired.get(id(spec), 0)
                if spec.count is not None and fired >= spec.count:
                    continue
                if (draw >> 11) * _U53 >= spec.p:
                    continue
                plan._fired[id(spec)] = fired + 1
                inj = Injection(self.name, k, draw, spec)
                plan._record(inj)
                return inj
        return None

    def fail(self, arg: Optional[str] = None,
             raise_as=None) -> Optional[Injection]:
        """Act out the imperative kinds: sleep on ``delay``, raise on
        ``error``/``timeout``, exit on ``kill``. ``raise_as`` lets the
        seam pick the exception its retry machinery treats as organic
        (e.g. ConnectionError at the broker). Data kinds (torn_write/
        corrupt/clock_skew) are returned for the caller to interpret."""
        inj = self.hit(arg)
        if inj is None:
            return None
        if inj.kind == "delay":
            time.sleep(inj.delay_s)  # host-sync-ok: armed chaos only
        elif inj.kind == "error":
            if raise_as is not None:
                raise raise_as(f"chaos: injected error at {self.name} "
                               f"(hit {inj.hit})")
            raise inj.error()
        elif inj.kind == "timeout":
            cls = raise_as if raise_as is not None else TimeoutError
            raise cls(f"chaos: injected timeout at {self.name} "
                      f"(hit {inj.hit})")
        elif inj.kind == "kill":
            os._exit(KILL_EXIT_CODE)
        return inj

    def mangle(self, data: bytes, arg: Optional[str] = None
               ) -> Tuple[bytes, Optional[Injection]]:
        """Byte-payload sites: returns (possibly mangled data,
        injection). ``delay`` sleeps here too; ``error`` raises."""
        inj = self.hit(arg)
        if inj is None:
            return data, None
        if inj.kind == "delay":
            time.sleep(inj.delay_s)  # host-sync-ok: armed chaos only
            return data, inj
        if inj.kind == "error":
            raise inj.error()
        return inj.corrupted(data), inj

    def skew(self, arg: Optional[str] = None) -> float:
        """Clock sites: seconds of skew to add (0.0 when nothing
        fires)."""
        inj = self.hit(arg)
        if inj is not None and inj.kind == "clock_skew":
            return inj.skew_s
        return 0.0


class FaultPlan:
    """A seeded set of fault specs plus the per-site hit counters that
    make injection deterministic. Thread-safe; one plan is typically
    process-global (see :func:`arm`)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0,
                 registry=None):
        self.specs = list(specs)
        self.seed = int(seed) & _MASK
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._fired: Dict[int, int] = {}
        #: every injection, in order: (site, kind, hit, draw) — the
        #: bitwise-replay evidence the matrix test compares
        self.trace: List[Tuple[str, str, int, int]] = []
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)
        if registry is None:
            from deeplearning4j_tpu_torch.observe.registry import (
                default_registry)
            registry = default_registry()
        self._c_injected = registry.counter(
            "dl4j_chaos_injected_total",
            "faults injected by the armed FaultPlan, by site and kind")

    def site(self, name: str) -> Optional[_Site]:
        specs = self._by_site.get(name)
        if not specs:
            return None
        return _Site(self, name, specs)

    def _record(self, inj: Injection) -> None:
        # called under self._lock
        self.trace.append((inj.site, inj.kind, inj.hit, inj.draw))
        self._c_injected.inc(1.0, site=inj.site, kind=inj.kind)

    def injected(self) -> Dict[Tuple[str, str], int]:
        """Injection counts by (site, kind)."""
        out: Dict[Tuple[str, str], int] = {}
        with self._lock:
            for s, k, _, _ in self.trace:
                out[(s, k)] = out.get((s, k), 0) + 1
        return out

    def replay_signature(self) -> Tuple[Tuple[str, str, int, int], ...]:
        """Hashable injection-sequence fingerprint: two runs of the
        same seed over the same deterministic driver must compare
        equal."""
        with self._lock:
            return tuple(self.trace)

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, specs={len(self.specs)}, "
                f"injected={len(self.trace)})")


def parse_plan(text: str, registry=None) -> FaultPlan:
    """Parse the ``DL4J_CHAOS`` grammar into a plan. Raises ValueError
    on malformed clauses — a misconfigured chaos run must fail loudly,
    not silently no-op."""
    seed = 0
    specs: List[FaultSpec] = []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[5:], 0)
            continue
        head, _, paren = clause.partition("(")
        site_name, sep, kind = head.partition(":")
        if not sep or not site_name or not kind:
            raise ValueError(
                f"chaos clause {clause!r} is not site:kind(...)")
        params: Dict[str, object] = {}
        if paren:
            if not paren.endswith(")"):
                raise ValueError(f"unbalanced parens in {clause!r}")
            for kv in paren[:-1].split(","):
                kv = kv.strip()
                if not kv:
                    continue
                key, sep2, val = kv.partition("=")
                if not sep2:
                    raise ValueError(
                        f"chaos param {kv!r} is not k=v in {clause!r}")
                key = key.strip()
                val = val.strip()
                if key == "arg":
                    params[key] = val
                elif key in ("count", "after"):
                    params[key] = int(val, 0)
                elif key in ("p", "ms", "skew_ms"):
                    params[key] = float(val)
                else:
                    raise ValueError(
                        f"unknown chaos param {key!r} in {clause!r}")
        specs.append(FaultSpec(site=site_name.strip(),
                               kind=kind.strip(), **params))
    return FaultPlan(specs, seed=seed, registry=registry)


# ---------------------------------------------------------------------------
# process-global arming (what chaos.hook resolves against)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None
_ENV_CONSUMED = False
_ARM_LOCK = threading.Lock()


def arm(plan=None, registry=None) -> FaultPlan:
    """Activate a plan process-wide. ``plan`` may be a FaultPlan, a
    plan string, or None (parse ``DL4J_CHAOS`` from the environment).
    Arm BEFORE constructing the objects under test — sites bind at
    construction."""
    global _ACTIVE, _ENV_CONSUMED
    if plan is None:
        text = os.environ.get("DL4J_CHAOS")
        if text is None:
            raise ValueError("arm(): no plan given and DL4J_CHAOS "
                             "is not set")
        plan = text
    if isinstance(plan, str):
        plan = parse_plan(plan, registry=registry)
    with _ARM_LOCK:
        _ACTIVE = plan
        _ENV_CONSUMED = True
    return plan


def disarm() -> None:
    """Deactivate chaos: later site resolutions return None (already
    bound handles keep their plan — rebuild the object to unhook it).
    Also blocks re-arming from a still-set DL4J_CHAOS."""
    global _ACTIVE, _ENV_CONSUMED
    with _ARM_LOCK:
        _ACTIVE = None
        _ENV_CONSUMED = True


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def site(name: str) -> Optional[_Site]:
    """Resolve a site against the active plan, auto-arming from
    ``DL4J_CHAOS`` on first touch (what ``chaos.hook`` calls)."""
    global _ACTIVE, _ENV_CONSUMED
    if _ACTIVE is None:
        with _ARM_LOCK:
            if _ACTIVE is None and not _ENV_CONSUMED:
                text = os.environ.get("DL4J_CHAOS")
                _ENV_CONSUMED = True
                if text:
                    _ACTIVE = parse_plan(text)
    if _ACTIVE is None:
        return None
    return _ACTIVE.site(name)
