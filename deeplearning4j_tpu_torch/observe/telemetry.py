"""In-step device telemetry: the metric spec and a ring buffer on the card.

The port of the JAX package's ``observe/telemetry.py``. The reference's
BaseStatsListener reads the score and parameter statistics on the host
after every iteration, and each read is a device→host sync. Here the
metrics are computed inside the train step from the loss, gradients and
parameters the step already holds, and written into a fixed-size ring on
the model's device. The host fetches the whole ring in ONE transfer
every ``flush_interval`` steps (``TelemetryCollector.fetch_count``
counts them); between flushes, telemetry makes no sync.

A row is f32: the loss, the global gradient L2 norm, the count of
non-finite gradient elements (plus one for a non-finite loss), and with
``per_layer`` one update:param mean-magnitude ratio per layer. Each row's
iteration rides in an int32 ring, exact past 2^24 steps. With
``histograms`` the step also buckets per-layer parameter, gradient and
update samples into fixed bins every ``hist_interval`` recorded steps,
and on any step whose row counts a non-finite value.

Layout on the card: every ring is a view of one f32 tensor
(``TelemetryBuffer.blob``; the int32 columns are int32 views of its
words), so the flush is one device→host copy. A step's record flattens
the gradients, the new and the previous parameters into one vector each
and takes every per-layer quantity from them through index tables built
once per tree structure, so its launches do not grow with the number of
parameter leaves. The JAX package branches
on device values with ``lax.cond``; an ``if`` on a tensor in eager torch
would be a sync per step, so the port computes both branches' values
and selects on the card:

- the non-finite count is always the exact element count (the JAX
  package counts only when the squared norm is not finite, which gives
  the same number: a finite squared norm means no non-finite element);
- the histograms are computed every step and written to the histogram
  ring's slot through ``torch.where(due, new, old)``, with ``due`` the
  host-known interval test or a non-finite count above zero, and the
  slot index a counter on the card.

Histogram bins use the JAX package's formula, ``((x - lo) / span *
bins)`` truncated to int32 and clipped, not ``torch.histc`` (whose edges
differ). The number of rows a ring holds is host-known (one per recorded
step), so ``TelemetryBuffer.count`` is a host int; the histogram ring's
count depends on the data and stays on the card.

Per-device replica rows (``ReplicaRing``, ``replicas > 1``) are written
by the parallel wrapper (parallel/wrapper.py): a parameter fingerprint
per rank under SHARED_GRADIENTS, each worker's mean loss and gradient
norm under AVERAGING and ASYNC_ELASTIC. The rows are the same in every
rank (the wrapper reduces them over the group first); they sit in the
same blob and are fetched in the same transfer. Their count is host-known
too (one per recorded round).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe.registry import (MetricsRegistry,
                                                       default_registry)
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves

log = logging.getLogger(__name__)

# metrics always present, in row order, ahead of per-layer ratios
BASE_METRICS = ("loss", "grad_norm", "nonfinite_count")

# histogram kinds, in storage order along the hist ring's third axis
HIST_KINDS = ("param", "grad", "update")

# per-leaf prefix caps: the update:param ratio and the histograms sample
# a bounded prefix of each flattened leaf (the JAX package's values)
_MEAN_ABS_SAMPLE = 65536
_HIST_SAMPLE = 16384


class HistRing(NamedTuple):
    """``counts[i % capacity]`` holds the per-layer param/grad/update
    histograms of the i-th recorded histogram step; views of the
    buffer's one tensor, fetched in the same transfer as the rows."""
    counts: Any     # f32[capacity, n_layers, len(HIST_KINDS), bins]
    ranges: Any     # f32[capacity, n_layers, len(HIST_KINDS), 2]
    iters: Any      # i32[capacity]
    count: Any      # i32[1], on the card (the data decides it)


class ReplicaRing(NamedTuple):
    """Per-device rows from the parallel wrapper (views of the buffer's
    one tensor): ``rows[i % capacity]`` is the i-th recorded row."""
    rows: Any       # f32[capacity, n_workers, n_replica_metrics]
    iters: Any      # i32[capacity]
    count: int


class TelemetryBuffer(NamedTuple):
    """``rows[i % capacity]`` is the metric row of the i-th recorded
    step; ``count`` is the number of rows ever written (host int). Every
    ring is a view of ``blob``."""
    rows: Any       # f32[capacity, n_metrics]
    iters: Any      # i32[capacity]
    count: int
    hist: Any = ()  # HistRing when histograms are enabled
    blob: Any = None
    replica: Any = ()   # ReplicaRing when replica rows are enabled


def has_buffer(telemetry) -> bool:
    """True when a TrainState.telemetry slot carries a ring buffer (the
    slot defaults to an empty tuple)."""
    return isinstance(telemetry, TelemetryBuffer)


class TelemetrySpec:
    """The metric catalog: the row layout, and how one row is appended
    from inside a train step."""

    def __init__(self, layer_names: Tuple[str, ...] = (),
                 capacity: int = 128, per_layer: bool = True,
                 histograms: bool = False, hist_bins: int = 16,
                 hist_interval: int = 10, hist_capacity: int = 8,
                 replicas: int = 0,
                 replica_metrics: Tuple[str, ...] = ("loss", "grad_norm")):
        if capacity < 1:
            raise ValueError("telemetry capacity must be >= 1")
        if hist_bins < 2 or hist_capacity < 1 or hist_interval < 1:
            raise ValueError("histogram config must be positive "
                             "(bins >= 2)")
        self.capacity = int(capacity)
        self.per_layer = per_layer
        self.layer_names = tuple(layer_names) if per_layer else ()
        self.metric_names: Tuple[str, ...] = BASE_METRICS + tuple(
            f"update_ratio/{n}" for n in self.layer_names)
        # histograms need named layers to bucket by
        self.histograms = bool(histograms) and bool(self.layer_names)
        self.hist_bins = int(hist_bins)
        self.hist_interval = int(hist_interval)
        self.hist_capacity = int(hist_capacity)
        self.replicas = int(replicas)
        self.replica_metrics = tuple(replica_metrics)
        # per-structure index tables on the card (_Plan), built at the
        # first record of each tree structure
        self._consts: Dict[Any, Any] = {}

    # ---- the one tensor's layout ----------------------------------------
    def _layout(self) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
        """{part: (word offset, shape)} of every ring inside the blob."""
        n, cap = len(self.metric_names), self.capacity
        parts = [("rows", (cap, n)), ("iters", (cap,))]
        if self.histograms:
            hc, nl, nk = (self.hist_capacity, len(self.layer_names),
                          len(HIST_KINDS))
            parts += [("h_counts", (hc, nl, nk, self.hist_bins)),
                      ("h_ranges", (hc, nl, nk, 2)),
                      ("h_iters", (hc,)), ("h_count", (1,))]
        if self.replicas > 1:
            parts += [("r_rows", (cap, self.replicas,
                                  len(self.replica_metrics))),
                      ("r_iters", (cap,))]
        out, off = {}, 0
        for name, shape in parts:
            out[name] = (off, shape)
            off += int(np.prod(shape))
        out["_total"] = (off, ())
        return out

    def _views(self, blob, count: int, replica_count: int = 0):
        """A TelemetryBuffer of views into ``blob`` (a card tensor, or
        the host copy a flush fetched, as numpy)."""
        lay = self._layout()

        def part(name, as_int=False):
            off, shape = lay[name]
            flat = blob[off:off + int(np.prod(shape))]
            if as_int:
                flat = (flat.view(torch.int32) if isinstance(flat,
                                                             torch.Tensor)
                        else flat.view(np.int32))
            return flat.reshape(shape)
        hist: Any = ()
        if self.histograms:
            hist = HistRing(part("h_counts"), part("h_ranges"),
                            part("h_iters", True), part("h_count", True))
        replica: Any = ()
        if self.replicas > 1:
            replica = ReplicaRing(part("r_rows"), part("r_iters", True),
                                  replica_count)
        return TelemetryBuffer(part("rows"), part("iters", True), count,
                               hist, blob, replica)

    def init(self, device=None) -> TelemetryBuffer:
        blob = torch.zeros((self._layout()["_total"][0],),
                           dtype=torch.float32, device=device)
        buf = self._views(blob, 0)
        buf.iters.fill_(-1)
        if self.histograms:
            buf.hist.iters.fill_(-1)
        if self.replicas > 1:
            buf.replica.iters.fill_(-1)
        return buf

    # ---- runs inside the train step ---------------------------------------
    @torch.no_grad()
    def record(self, buf: TelemetryBuffer, *, loss, grads, params,
               prev_params, iteration: int) -> TelemetryBuffer:
        """Append one metric row from the step's own loss, gradients, new
        parameters and previous parameters. Only launches work on the
        card; ``iteration`` (the step's iteration before it ran) and the
        row count are host ints.

        The update:param ratio is ``mean|new - prev| / mean|new|`` per
        layer over bounded prefix samples, from the parameter DELTA (so
        it folds in constraint projections), as the JAX package computes
        it. Each tree is flattened into one vector (a leading zero, then
        its leaves), and every per-layer quantity comes from that vector
        through index tables built once per tree structure (``_Plan``):
        a few dozen launches a step, whatever the number of leaves."""
        dev = buf.blob.device
        plan = self._plan(grads, params, prev_params, dev)
        g = _flat(tree_leaves(grads), dev)
        loss32 = loss.detach().float().reshape(())
        gnorm = torch.linalg.vector_norm(g)       # the lead zero adds 0
        # exact in every case: JAX's count runs only when the squared
        # norm is not finite, and a finite one means no such element
        nonfinite = (torch.isfinite(g).logical_not_().sum(
            dtype=torch.float32)
            + torch.isfinite(loss32).logical_not().float())
        vals = [loss32, gnorm, nonfinite]
        if self.layer_names:
            pn = _flat(plan.leaves(params), dev)
            po = (_flat(plan.leaves(prev_params), dev) if plan.prev_ok
                  else pn)
            upd = pn - po
            vals.append(self._ratios(plan, pn, upd))
        row = torch.cat([v.reshape(-1) for v in vals])
        idx = buf.count % self.capacity
        buf.rows[idx] = row
        # fill_ passes the host int as a kernel argument; item assignment
        # would copy it from a host tensor, a sync
        buf.iters[idx].fill_(int(iteration) + 1)
        if self.histograms:
            self._record_hist(plan, buf.hist, buf.count, nonfinite, pn, g,
                              upd, iteration)
        return buf._replace(count=buf.count + 1)

    @torch.no_grad()
    def record_replica(self, buf: TelemetryBuffer, *, values,
                       iteration: int) -> TelemetryBuffer:
        """Append one per-device row (``values``: [n_workers,
        n_replica_metrics], the same in every rank). A buffer without a
        replica ring is returned as it is."""
        rep = buf.replica
        if not isinstance(rep, ReplicaRing):
            return buf
        idx = rep.count % self.capacity
        rep.rows[idx] = values.to(torch.float32)
        rep.iters[idx].fill_(int(iteration) + 1)
        return buf._replace(replica=rep._replace(count=rep.count + 1))

    def _plan(self, grads, params, prev_params, dev) -> "_Plan":
        key = (_structure(grads), _structure(params),
               _structure(prev_params), str(dev))
        plan = self._consts.get(key)
        if plan is None:
            plan = _Plan(self, grads, params, prev_params, dev)
            self._consts[key] = plan
        return plan

    def _ratios(self, plan: "_Plan", pn, upd) -> torch.Tensor:
        """The per-layer update ratios as one (n_layers,) tensor: each
        leaf's prefix sample gathered into one vector (after a zero), its
        |x| sums from float64 running sums (the difference at the
        prefix's two ends), summed per layer by a constant 0/1 matrix."""
        if plan.ratio_lo is None:
            return torch.zeros((len(self.layer_names),),
                               dtype=torch.float32, device=pn.device)

        def layer_means(x):
            cs = torch.cumsum(x.index_select(0, plan.ratio_src).abs(), 0,
                              dtype=torch.float64)
            piece = cs.index_select(0, plan.ratio_hi) - cs.index_select(
                0, plan.ratio_lo)
            return (plan.ratio_member @ piece) / plan.ratio_count
        umag, pmag = layer_means(upd), layer_means(pn)
        return (umag / (pmag + 1e-12)).float()

    def _record_hist(self, plan: "_Plan", hist: HistRing, step_count: int,
                     nonfinite, pn, g, upd, iteration: int):
        """Per-layer param/grad/update histograms, written when
        ``step_count % hist_interval == 0`` and on a step whose row counts
        a non-finite value, so a dump always carries the histograms of
        the step that blew up. All layers and kinds are bucketed at once:
        the prefix samples are gathered into one vector, each sample's
        (layer, kind) segment min and max come from a padded
        (pieces x longest piece) matrix reduced along its rows (no atomic
        min/max), and the bins are counted by one ``index_add_``."""
        dev = pn.device
        bins, nk, nl = self.hist_bins, len(HIST_KINDS), len(self.layer_names)
        nseg = nl * nk
        x = torch.cat([pn.index_select(0, plan.h_src[0]),
                       g.index_select(0, plan.h_src[1]),
                       upd.index_select(0, plan.h_src[2])])
        # non-finite elements are zeroed before bucketing (the row's
        # nonfinite_count counts them; a NaN range would poison the bins)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        n_pieces, width = plan.h_pad
        ends = []
        for fill, reduce in ((float("inf"), torch.amin),
                             (float("-inf"), torch.amax)):
            pad = torch.full((n_pieces * width,), fill, device=dev)
            pad.index_copy_(0, plan.h_slot, x)
            per_piece = reduce(pad.view(n_pieces, width), dim=1)
            ends.append(torch.full((nseg,), fill, device=dev)
                        .scatter_reduce_(0, plan.h_piece_seg, per_piece,
                                         "amin" if fill > 0 else "amax"))
        lo, hi = ends
        span = torch.clamp_min(hi - lo, 1e-30)
        seg = plan.h_seg
        idx = torch.clamp(((x - lo.index_select(0, seg))
                           / span.index_select(0, seg) * bins).to(
                               torch.int32), 0, bins - 1)
        counts = torch.zeros((nseg * bins,), dtype=torch.float32,
                             device=dev).index_add_(
            0, seg * bins + idx, torch.ones_like(x))
        new_counts = counts.reshape(nl, nk, bins)
        new_ranges = torch.stack([lo, hi], dim=1).reshape(nl, nk, 2)
        due = torch.gt(nonfinite, 0)
        if step_count % self.hist_interval == 0:
            due = torch.ones_like(due)
        hidx = (hist.count.long() % self.hist_capacity)
        old_c = hist.counts.index_select(0, hidx)
        old_r = hist.ranges.index_select(0, hidx)
        old_i = hist.iters.index_select(0, hidx)
        hist.counts.index_copy_(0, hidx, torch.where(
            due, new_counts.unsqueeze(0), old_c))
        hist.ranges.index_copy_(0, hidx, torch.where(
            due, new_ranges.unsqueeze(0), old_r))
        hist.iters.index_copy_(0, hidx, torch.where(
            due, torch.full_like(old_i, int(iteration) + 1), old_i))
        hist.count.add_(due.to(torch.int32))


def _structure(tree) -> tuple:
    """(top-level key, leaf sizes) of a parameter-shaped tree."""
    if not isinstance(tree, dict):
        return ()
    return tuple((k, tuple(t.numel() for t in tree_leaves(v)
                           if isinstance(t, torch.Tensor)))
                 for k, v in tree.items())


def _flat(leaves, dev) -> torch.Tensor:
    """One float32 vector: a leading zero, then every leaf flattened."""
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    return torch.cat([zero] + [t.reshape(-1).float() for t in leaves])


class _Plan:
    """Index tables of one tree structure, on the card: where each leaf's
    prefix samples lie in the flat vectors (position 0 is the leading
    zero, the sample of a layer without parameters), which layer each
    ratio piece belongs to, and the histogram samples' segments."""

    def __init__(self, spec: TelemetrySpec, grads, params, prev_params,
                 dev):
        self.keys = tuple(params.keys()) if isinstance(params, dict) else ()
        self.prev_ok = _structure(prev_params) == _structure(params)
        p_off = self._offsets(params, self.keys)
        g_keys = tuple(grads.keys()) if isinstance(grads, dict) else ()
        g_off = self._offsets(grads, g_keys)
        names = spec.layer_names
        to = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)

        # ratio pieces: [start, start + min(n, cap)) of each leaf of a
        # layer whose previous leaves match, gathered after the lead zero
        # (``ratio_src``); running-sum indices of each piece's two ends
        src, lo, hi, member = [np.zeros((1,), np.int64)], [], [], []
        count, pos = np.zeros((len(names),)), 1
        for li, name in enumerate(names):
            leaves = p_off.get(name, [])
            if not leaves or not self.prev_ok:
                continue
            for start, n in leaves:
                m = min(n, _MEAN_ABS_SAMPLE)
                src.append(np.arange(start, start + m))
                lo.append(pos - 1)
                hi.append(pos + m - 1)
                pos += m
                member.append(li)
                count[li] += m
        self.ratio_lo = self.ratio_hi = None
        if lo:
            mat = np.zeros((len(names), len(lo)))
            mat[member, np.arange(len(lo))] = 1.0
            self.ratio_src = to(np.concatenate(src))
            self.ratio_lo, self.ratio_hi = to(lo), to(hi)
            self.ratio_member = torch.as_tensor(mat, dtype=torch.float64,
                                                device=dev)
            self.ratio_count = torch.as_tensor(np.maximum(count, 1.0),
                                               dtype=torch.float64,
                                               device=dev)

        # histogram samples, kind-major as the samples are concatenated:
        # params, grads, updates (the updates at the params' positions)
        if not spec.histograms:
            return
        src = [[], []]                      # params, grads
        pieces = []                         # (segment, length) in order
        for kind_i, off in ((0, p_off), (1, g_off)):
            for li, name in enumerate(names):
                leaves = off.get(name, [])
                if not leaves:
                    leaves = [(0, 1)]           # the lead zero
                for start, n in leaves:
                    m = min(n, _HIST_SAMPLE)
                    src[kind_i].append(np.arange(start, start + m))
                    pieces.append((li * len(HIST_KINDS) + kind_i, m))
        for li, name in enumerate(names):
            leaves = p_off.get(name, []) or [(0, 1)]
            for start, n in leaves:
                pieces.append((li * len(HIST_KINDS) + 2,
                               min(n, _HIST_SAMPLE)))
        p_src = np.concatenate(src[0])
        self.h_src = (to(p_src), to(np.concatenate(src[1])), to(p_src))
        width = max(m for _, m in pieces)
        slot, seg = [], []
        for pi, (sg, m) in enumerate(pieces):
            slot.append(pi * width + np.arange(m))
            seg.append(np.full((m,), sg))
        self.h_pad = (len(pieces), width)
        self.h_slot = to(np.concatenate(slot))
        self.h_seg = to(np.concatenate(seg))
        self.h_piece_seg = to([sg for sg, _ in pieces])

    @staticmethod
    def _offsets(tree, keys) -> Dict[str, list]:
        """{top-level key: [(start, numel) of each leaf]} in the flat
        vector of ``tree`` (after the leading zero)."""
        out, pos = {}, 1
        for k in keys:
            sub = tree[k]
            leaves = tree_leaves(sub) if isinstance(sub, dict) else [sub]
            out[k] = []
            for t in leaves:
                out[k].append((pos, t.numel()))
                pos += t.numel()
        return out

    def leaves(self, tree) -> list:
        """``tree``'s leaves in the plan's key order."""
        out = []
        for k in self.keys:
            sub = tree[k]
            out.extend(tree_leaves(sub) if isinstance(sub, dict) else [sub])
        return out


class TelemetryCollector:
    """Host side: owns the spec, decides when to flush, decodes rows, and
    publishes to the Prometheus registry.

    Attach with ``model.set_telemetry(TelemetryCollector(...))``; the
    model builds its train steps with the spec and calls ``on_step`` after
    each dispatch. Every ``flush_interval`` recorded steps the collector
    makes exactly ONE device fetch (``fetch_count``). Listener-visible
    values (``last('loss')``) therefore lag up to one flush interval.
    """

    def __init__(self, flush_interval: int = 50,
                 capacity: Optional[int] = None, per_layer: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 session_id: str = "train",
                 histograms: bool = False, hist_bins: int = 16,
                 hist_interval: int = 10, hist_capacity: int = 8):
        if flush_interval < 1:
            raise ValueError("flush_interval must be >= 1")
        self.flush_interval = int(flush_interval)
        self.capacity = int(capacity) if capacity is not None else max(
            2 * self.flush_interval, 64)
        if self.capacity < self.flush_interval:
            raise ValueError(
                f"capacity {self.capacity} < flush_interval "
                f"{self.flush_interval}: rows would be overwritten "
                "before they are ever fetched")
        self.per_layer = per_layer
        self.session_id = session_id
        self.registry = registry if registry is not None else \
            default_registry()
        self.histograms = bool(histograms)
        self.hist_bins = int(hist_bins)
        self.hist_interval = int(hist_interval)
        self.hist_capacity = int(hist_capacity)
        self.spec: Optional[TelemetrySpec] = None
        self.history: List[dict] = []
        self.hist_history: List[dict] = []
        self.replica_history: List[dict] = []
        self.fetch_count = 0
        self.dropped_rows = 0
        self._read_count = 0
        self._hist_read = 0
        self._replica_read = 0
        self._pending = 0
        self._last_flush_time: Optional[float] = None

    # ---- wiring ---------------------------------------------------------
    def spec_for(self, model) -> TelemetrySpec:
        """The spec is built once per collector, from the model's layer
        names; a model with other layers needs a fresh collector."""
        names = tuple(getattr(model, "layer_names", ()))
        if self.spec is None:
            self.spec = TelemetrySpec(
                names, capacity=self.capacity, per_layer=self.per_layer,
                histograms=self.histograms, hist_bins=self.hist_bins,
                hist_interval=self.hist_interval,
                hist_capacity=self.hist_capacity)
        elif self.per_layer and self.spec.layer_names != names:
            raise ValueError(
                "TelemetryCollector is already bound to layers "
                f"{self.spec.layer_names}; use a fresh collector for a "
                "model with different layers")
        return self.spec

    def enable_replicas(self, n_workers: int,
                        metrics: Tuple[str, ...] = ("loss", "grad_norm")
                        ) -> bool:
        """Turn on the per-device row ring (the parallel wrapper calls
        this before its first dispatch). Returns True when the spec
        changed: the caller then rebinds any existing buffer
        (``rebind_buffer``) so the new ring exists."""
        if self.spec is None:
            raise RuntimeError("spec_for(model) must run before "
                               "enable_replicas")
        n = int(n_workers)
        metrics = tuple(metrics)
        changed = (self.spec.replicas != n
                   or self.spec.replica_metrics != metrics)
        self.spec.replicas = n
        self.spec.replica_metrics = metrics
        return changed

    def rebind_buffer(self, train_state, device=None):
        """Replace the buffer after a spec change: flush what the old
        ring still holds, then a fresh ring in the new layout and reset
        read cursors."""
        if self.spec is None:
            raise RuntimeError("spec_for(model) must run before "
                               "rebind_buffer")
        if has_buffer(train_state.telemetry):
            self.flush(train_state)
            device = train_state.telemetry.blob.device
        self._read_count = 0
        self._hist_read = 0
        self._replica_read = 0
        self._pending = 0
        return self.ensure_buffer(train_state._replace(telemetry=()),
                                  device)

    def ensure_buffer(self, train_state, device=None):
        """The train state with a ring buffer on ``device`` (the
        parameters' device by default) when it carries none yet."""
        if has_buffer(train_state.telemetry):
            return train_state
        if self.spec is None:
            raise RuntimeError("spec_for(model) must run before "
                               "ensure_buffer")
        if device is None:
            leaves = tree_leaves(train_state.params or {})
            device = leaves[0].device if leaves else None
        if self._last_flush_time is None:
            self._last_flush_time = time.perf_counter()
        return train_state._replace(telemetry=self.spec.init(device))

    # ---- steady-state hook ----------------------------------------------
    def will_flush(self, steps: int = 1) -> bool:
        """Whether the next ``on_step(..., steps)`` will fetch."""
        return self._pending + int(steps) >= self.flush_interval

    def on_step(self, train_state, steps: int = 1):
        """Called after each dispatched train step (``steps`` > 1 for a
        K-step call). Flushes when a full interval has accumulated;
        otherwise free — no device interaction."""
        self._pending += int(steps)
        if self._pending >= self.flush_interval:
            self.flush(train_state)

    def flush(self, train_state) -> List[dict]:
        """ONE device fetch: copy the whole buffer to the host, decode
        every row not yet seen, publish the newest values to the
        registry. Returns the newly decoded records."""
        buf = train_state.telemetry
        if not has_buffer(buf):
            return []
        blob = buf.blob.cpu().numpy()       # the single transfer
        host = self.spec._views(
            blob, buf.count, buf.replica.count
            if isinstance(buf.replica, ReplicaRing) else 0)
        self.fetch_count += 1
        self._pending = 0
        now = time.perf_counter()
        total = int(host.count)
        new = total - self._read_count
        records: List[dict] = []
        if new > 0:
            dropped = max(0, new - self.spec.capacity)
            if dropped:
                self.dropped_rows += dropped
                self.registry.counter(
                    "dl4j_telemetry_dropped_rows_total",
                    "ring rows overwritten before flush").inc(
                    dropped, session=self.session_id)
                log.warning("telemetry ring overwrote %d rows before "
                            "flush (capacity %d); flush more often or "
                            "grow the ring", dropped, self.spec.capacity)
            for j in range(self._read_count + dropped, total):
                idx = j % self.spec.capacity
                rec: Dict[str, Any] = {"iteration": int(host.iters[idx])}
                for m, name in enumerate(self.spec.metric_names):
                    rec[name] = float(host.rows[idx, m])
                records.append(rec)
            self._read_count = total
            self.history.extend(records)
        # the replica ring advances on its own cadence (an AVERAGING
        # round records only replica rows): decode it even when no base
        # rows landed
        self._decode_hist(host)
        rep_records = self._decode_replica(host)
        if records:
            self._publish(records, new, now)
        self._publish_replica(rep_records)
        self._last_flush_time = now
        return records

    def _decode_hist(self, host) -> List[dict]:
        """New histogram-ring entries of an already-fetched buffer."""
        if not isinstance(host.hist, HistRing) or self.spec is None:
            return []
        h = host.hist
        total = int(h.count[0])
        new = total - self._hist_read
        if new <= 0:
            return []
        start = self._hist_read + max(0, new - self.spec.hist_capacity)
        out = []
        for j in range(start, total):
            idx = j % self.spec.hist_capacity
            layers: Dict[str, dict] = {}
            for li, lname in enumerate(self.spec.layer_names):
                layers[lname] = {
                    kind: {
                        "counts": h.counts[idx, li, ki].tolist(),
                        "min": float(h.ranges[idx, li, ki, 0]),
                        "max": float(h.ranges[idx, li, ki, 1]),
                    } for ki, kind in enumerate(HIST_KINDS)}
            out.append({"iteration": int(h.iters[idx]),
                        "layers": layers})
        self._hist_read = total
        self.hist_history.extend(out)
        return out

    def _decode_replica(self, host) -> List[dict]:
        """New per-device rows of an already-fetched buffer."""
        if not isinstance(host.replica, ReplicaRing) or self.spec is None:
            return []
        rep = host.replica
        total = int(rep.count)
        new = total - self._replica_read
        if new <= 0:
            return []
        start = self._replica_read + max(0, new - self.spec.capacity)
        out = []
        for j in range(start, total):
            idx = j % self.spec.capacity
            rec: Dict[str, Any] = {"iteration": int(rep.iters[idx])}
            for m, name in enumerate(self.spec.replica_metrics):
                rec[name] = [float(v) for v in rep.rows[idx, :, m]]
            out.append(rec)
        self._replica_read = total
        self.replica_history.extend(out)
        return out

    def _publish_replica(self, records: List[dict]):
        """Per-device gauges and the cross-replica divergence: the
        relative spread (max - min over workers, over the mean magnitude)
        of ``grad_norm`` when recorded, else of the last replica metric;
        about 0 on replicas in step."""
        if not records or self.spec is None:
            return
        r = self.registry
        s = self.session_id
        names = self.spec.replica_metrics
        last = records[-1]
        nonfinite = sum(1 for rec in records for name in names
                        for v in rec[name] if not math.isfinite(v))
        if nonfinite:
            r.counter("dl4j_nonfinite_values_total", "non-finite values "
                      "seen in gradients/loss").inc(nonfinite, session=s)
        for name in names:
            g = r.gauge(f"dl4j_replica_{name}",
                        f"per-device {name} from the parallel wrapper")
            for w, v in enumerate(last[name]):
                g.set(v, session=s, replica=str(w))
        div_col = "grad_norm" if "grad_norm" in names else names[-1]
        div = 0.0
        for rec in records:
            vals = [v for v in rec[div_col] if math.isfinite(v)]
            if len(vals) >= 2:
                scale = sum(abs(v) for v in vals) / len(vals)
                div = max(div,
                          (max(vals) - min(vals)) / (scale + 1e-12))
            elif len(vals) < len(rec[div_col]):
                div = float("inf")   # a non-finite replica IS divergence
        r.gauge("dl4j_replica_divergence", "relative max pairwise "
                "spread of per-replica grad norms (0 = replicas in "
                "sync)").set(div, session=s)

    def _publish(self, records: List[dict], n_steps: int, now: float):
        r = self.registry
        s = self.session_id
        last = records[-1]
        r.gauge("dl4j_loss", "training loss (flushed from the device "
                "ring)").set(last["loss"], session=s)
        r.gauge("dl4j_grad_norm", "global gradient L2 norm").set(
            last["grad_norm"], session=s)
        r.gauge("dl4j_iteration", "latest flushed iteration").set(
            last["iteration"], session=s)
        nonfinite = sum(rec["nonfinite_count"] for rec in records)
        r.counter("dl4j_nonfinite_values_total", "non-finite values seen "
                  "in gradients/loss").inc(nonfinite, session=s)
        if self._last_flush_time is not None:
            dt = now - self._last_flush_time
            if dt > 0:
                r.gauge("dl4j_steps_per_second", "optimizer steps per "
                        "second over the last flush window").set(
                    n_steps / dt, session=s)
        r.counter("dl4j_telemetry_flushes_total", "device fetches "
                  "performed by the telemetry collector").inc(session=s)
        for name in self.spec.layer_names:
            r.gauge("dl4j_update_ratio", "mean |update| / mean |param| "
                    "per layer").set(last[f"update_ratio/{name}"],
                                     session=s, layer=name)

    # ---- read side ------------------------------------------------------
    def last_record(self) -> Optional[dict]:
        return self.history[-1] if self.history else None

    def last(self, metric: str) -> Optional[float]:
        rec = self.last_record()
        return None if rec is None else rec.get(metric)

    def last_histograms(self) -> Optional[dict]:
        """Latest decoded per-layer histograms (``{"iteration": i,
        "layers": {name: {param/grad/update: {counts, min, max}}}}``), or
        None before the first flush of a histogram-enabled ring."""
        return self.hist_history[-1] if self.hist_history else None

    def last_replica_record(self) -> Optional[dict]:
        return self.replica_history[-1] if self.replica_history else None
