"""Distributed checkpoints: sharded save, restore onto any world size,
elastic restart.

The port of the JAX package's ``parallel/checkpoint.py``, in its format:
a checkpoint written by either package restores in the other.

- :func:`save_sharded` writes format 2: one ``{group}.proc{K}.npz`` and
  its ``.idx.json`` sidecar per process and group (params, model_state,
  opt_state), then, after a barrier, rank 0 publishes ``manifest.json``
  and the ``COMMITTED`` marker by one rename. A data-parallel leaf is
  whole in every rank, so rank 0 writes it (the JAX package's
  ``replica_id == 0`` piece) and the other ranks write empty files.
  With ``mesh`` and ``specs`` (partition specs of the split leaves, as
  ``parallel/tensor_parallel.py`` and ``PipelinedTransformerLM`` give
  them), a split leaf is written as this rank's piece at its offset in
  the whole leaf, by the rank at index 0 of every axis the leaf is not
  split over, and the manifest records the whole shape.
  ``emergency=True`` is the peer-loss path: no barrier (a dead peer would
  never join it); this rank alone writes a complete committed checkpoint
  into ``step_XXXX.em{rank}``.
- :func:`restore_sharded` reads format 2 (or the legacy single-npz
  format 1) into an initialized model, whatever the world size and the
  layout that wrote it; with ``mesh`` and ``param_shardings`` every rank
  reads its own region of each split leaf (the target layout may differ
  from the saved one: a 2×2×2 checkpoint restores onto 1×2×4). A missing
  leaf or a shape mismatch raises, entries the model has no leaf for are
  warned about.
- :class:`ElasticTrainer` wraps ``fit`` with periodic checkpoints, an
  emergency save when the fit raises, and ``resume()``.

Leaf names are the JAX package's tree paths (``layer/W``; an optax
state's tuple position and field as ``0/trace/...``); the port's trees
spell those ``#0/.trace/...`` (``models.serialization.flatten_paths``),
so each component's ``#``/``.`` marker is dropped on the way in and out.
bf16 leaves are stored as their raw uint16 bits, marked in the
manifest's ``dtypes``.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.optimize.solver import TrainState
from deeplearning4j_tpu_torch.parallel.mesh import barrier, rank, world_size
from deeplearning4j_tpu_torch.parallel.sharding import \
    infer_param_shardings
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (mirror_specs,
                                                              spec_leaves)

_GROUPS = ("params", "model_state", "opt_state")


def _ckpt_key(path: str) -> str:
    """A port tree path as the JAX package's checkpoint key."""
    return "/".join(p[1:] if p[:1] in ("#", ".") else p
                    for p in path.split("/"))


def _flatten(tree) -> Dict[str, Any]:
    return {_ckpt_key(k): v for k, v in flatten_paths(tree).items()}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _region(shape, spec, mesh) -> tuple:
    """This rank's (start offsets, piece shape) of a whole leaf of
    ``shape`` split by ``spec`` over ``mesh``."""
    start, piece = [], []
    for dim, w in enumerate(shape):
        name = spec[dim] if dim < len(spec) else None
        a = mesh.axis(name) if name is not None else None
        if a is None or a.size == 1:
            start.append(0)
            piece.append(w)
        else:
            start.append(a.index * (w // a.size))
            piece.append(w // a.size)
    return start, piece


def _writes(spec, mesh) -> bool:
    """Whether this rank writes its piece of a leaf split by ``spec``:
    the replica at index 0 of every axis the leaf is not split over."""
    used = {a for a in spec if a is not None}
    return all(mesh.index(a) == 0 for a in mesh.axis_names
               if a not in used)


def save_sharded(train_state: TrainState, directory: str,
                 step: Optional[int] = None,
                 emergency: bool = False, mesh=None,
                 specs: Optional[Dict[str, Any]] = None) -> str:
    """Write params, model_state, opt_state and the iteration under
    ``directory`` (one subdirectory a step); returns its path. Every rank
    calls it, except with ``emergency=True``. ``specs`` maps a group
    ("params", "model_state", "opt_state") to the spec tree of its split
    leaves over ``mesh`` (the others are whole)."""
    it = int(train_state.iteration) if step is None else int(step)
    pidx = rank()
    name = f"step_{it:010d}" + (f".em{pidx}" if emergency else "")
    path = os.path.join(directory, name)
    if os.path.exists(os.path.join(path, "COMMITTED")):
        # already durably saved: rewriting would open a window in which
        # the only committed copy is gone
        return path
    tmp = path + ".tmp"
    writer = pidx == 0 or emergency
    if specs and (mesh is None or emergency):
        raise ValueError("split leaves need the mesh, and an emergency "
                         "save is whole leaves only")
    if writer:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    if not emergency:
        barrier()
    manifest = {"format": 2, "iteration": it,
                "process_count": world_size(),
                "groups": {}, "dtypes": {}, "shapes": {}}
    for group in _GROUPS:
        leaves = _flatten(getattr(train_state, group))
        split = spec_leaves((specs or {}).get(group, {}))
        arrays: Dict[str, np.ndarray] = {}
        index: Dict[str, Dict[str, Any]] = {}
        names = []
        for k, v in leaves.items():
            if not isinstance(v, torch.Tensor):
                continue
            names.append(k)
            if v.dtype == torch.bfloat16:
                manifest["dtypes"][f"{group}/{k}"] = "bfloat16"
            spec = split.get(k, ())
            if any(a is not None and mesh.axis(a).size > 1 for a in spec):
                whole = [w * (mesh.axis(spec[d]).size if d < len(spec)
                              and spec[d] is not None else 1)
                         for d, w in enumerate(v.shape)]
                start, _ = _region(whole, spec, mesh)
                mine = _writes(spec, mesh)
            else:
                whole, start, mine = list(v.shape), [0] * v.dim(), writer
            manifest["shapes"][f"{group}/{k}"] = whole
            if mine:
                a = _to_host(v)
                arrays[f"{k}::0"] = a
                index[f"{k}::0"] = {"leaf": k, "dtype": str(a.dtype),
                                    "start": start}
        np.savez(os.path.join(tmp, f"{group}.proc{pidx:04d}.npz"), **arrays)
        with open(os.path.join(tmp, f"{group}.proc{pidx:04d}.idx.json"),
                  "w") as f:
            json.dump(index, f)
        manifest["groups"][group] = sorted(set(names))
    if not emergency:
        barrier()
    if writer:
        if emergency:
            manifest["process_count"] = 1
            manifest["emergency"] = {"process_index": pidx}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # the marker is inside the staged directory: the rename publishes
        # both at once, so a torn write never looks committed
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.isdir(path):     # an uncommitted partial of a crash
            shutil.rmtree(path)
        os.rename(tmp, path)
    if not emergency:
        barrier()
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = [d for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp") and
             os.path.exists(os.path.join(directory, d, "COMMITTED"))]
    if not steps:
        return None
    return os.path.join(directory, sorted(steps)[-1])


class _GroupReader:
    """Region reads over a checkpoint group: a leaf is assembled from the
    pieces that overlap the region (format 2); the legacy format 1 reads
    whole leaves from ``{group}.npz``."""

    def __init__(self, path: str, group: str, manifest: dict):
        self.group = group
        self.shapes = {k.split("/", 1)[1]: tuple(v)
                       for k, v in manifest.get("shapes", {}).items()
                       if k.startswith(group + "/")}
        self._pieces: Dict[str, list] = {}
        self._dtypes: Dict[str, np.dtype] = {}
        self._legacy = None
        if manifest.get("format", 1) < 2:
            self._legacy = np.load(os.path.join(path, f"{group}.npz"))
            for k in self._legacy.files:
                self._pieces[k] = []
                self.shapes.setdefault(k, tuple(self._legacy[k].shape))
            return
        for pf in sorted(f for f in os.listdir(path)
                         if f.startswith(f"{group}.proc")
                         and f.endswith(".npz")):
            with open(os.path.join(
                    path, pf[:-len(".npz")] + ".idx.json")) as fh:
                index = json.load(fh)
            npz = np.load(os.path.join(path, pf))
            for ent, meta in index.items():
                self._pieces.setdefault(meta["leaf"], []).append(
                    (tuple(meta["start"]), npz, ent))
                if "dtype" in meta:
                    self._dtypes[meta["leaf"]] = np.dtype(meta["dtype"])

    def keys(self):
        return set(self._pieces)

    def read(self, key: str, region=None) -> np.ndarray:
        """The leaf (or ``region``, slices into its global shape)."""
        if self._legacy is not None:
            a = self._legacy[key]
            return a if region is None else np.ascontiguousarray(a[region])
        shape = self.shapes[key]
        pieces = self._pieces[key]
        if region is None:
            region = tuple(slice(0, d) for d in shape)
        lo = [0 if r.start is None else int(r.start) for r in region]
        hi = [shape[i] if r.stop is None else int(r.stop)
              for i, r in enumerate(region)]
        dtype = self._dtypes.get(key)
        if dtype is None:
            dtype = pieces[0][1][pieces[0][2]].dtype if pieces \
                else np.float32
        out = np.zeros([b - a for a, b in zip(lo, hi)], dtype)
        for pstart, npz, ent in pieces:
            piece = npz[ent]
            src, dst, skip = [], [], False
            for d in range(len(shape)):
                a = max(lo[d], pstart[d])
                b = min(hi[d], pstart[d] + piece.shape[d])
                if a >= b:
                    skip = True
                    break
                src.append(slice(a - pstart[d], b - pstart[d]))
                dst.append(slice(a - lo[d], b - lo[d]))
            if not skip:
                out[tuple(dst)] = piece[tuple(src)]
        return out


def mirror_opt_shardings(opt_state, params, param_shardings, replicated):
    """Placement tree of an optimizer state: a leaf whose path ends with a
    parameter's path, at that parameter's shape, gets its placement;
    everything else (step counts, scalars) gets ``replicated``."""
    pflat = flatten_paths(params)
    sflat = flatten_paths(param_shardings)
    by_path = {tuple(_ckpt_key(k).split("/")):
               (tuple(getattr(leaf, "shape", ())), sflat[k])
               for k, leaf in pflat.items()}

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        okey = tuple(_ckpt_key("/".join(prefix)).split("/"))
        shape = tuple(getattr(node, "shape", ()))
        if shape:
            for pkey, (pshape, psh) in by_path.items():
                if (pshape == shape and len(okey) >= len(pkey)
                        and okey[-len(pkey):] == pkey):
                    return psh
        return replicated
    return walk(opt_state, ())


def _unconsumed_msg(group: str, unconsumed) -> str:
    shown = sorted(unconsumed)[:5]
    more = len(unconsumed) - len(shown)
    msg = (f"checkpoint {group} entries not used by this model: "
           f"{shown}")
    if more > 0:
        msg += f" (+{more} more)"
    return msg


def _from_host(a: np.ndarray, bf16: bool, like: torch.Tensor
               ) -> torch.Tensor:
    if bf16:
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype=like.dtype, device=like.device)


def restore_sharded(model, path: str, mesh=None,
                    param_shardings=None) -> TrainState:
    """Restore a checkpoint (either package's, format 1 or 2, any world
    size) into ``model``, which must be initialized (its trees give the
    names, shapes, dtypes and device: this rank's slices for split
    leaves). With ``mesh`` and ``param_shardings`` (a spec tree matching
    the params) each rank reads its region of every split parameter and
    of the updater leaves that mirror one; without, every leaf lands
    whole in this rank."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    ts = model.train_state
    split: Dict[str, Dict[str, tuple]] = {}
    if param_shardings is not None:
        if set(spec_leaves(param_shardings)) != set(_flatten(ts.params)):
            raise ValueError(
                "param_shardings tree structure does not match the "
                "model's params: a silent zip misalignment would restore "
                "arrays with the wrong layouts")
        if mesh is not None:
            split["params"] = spec_leaves(param_shardings)
            split["opt_state"] = spec_leaves(mirror_specs(
                ts.opt_state, ts.params, param_shardings))
    elif mesh is not None:
        infer_param_shardings(ts.params, mesh)

    def rebuild(group, template):
        reader = _GroupReader(path, group, manifest)
        stored = reader.keys()
        consumed = set()

        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in node.items()}
            key = _ckpt_key(prefix)
            if key in stored:
                consumed.add(key)
                shape = reader.shapes.get(key)
                region, want = None, shape
                spec = split.get(group, {}).get(key, ())
                if shape is not None and any(a is not None for a in spec):
                    start, want = _region(shape, spec, mesh)
                    region = tuple(slice(a, a + w)
                                   for a, w in zip(start, want))
                if isinstance(node, torch.Tensor) and want is not None \
                        and tuple(node.shape) != tuple(want):
                    raise ValueError(
                        f"checkpoint leaf {key} has shape {tuple(shape)} "
                        f"(this rank's region {tuple(want)}), model "
                        f"expects {tuple(node.shape)}")
                return _from_host(reader.read(key, region),
                                  dtypes.get(f"{group}/{key}") == "bfloat16",
                                  node)
            if isinstance(node, torch.Tensor) and node.numel() > 0:
                # resuming would silently mix restored and random weights
                raise KeyError(
                    f"checkpoint is missing {group} leaf {key!r} "
                    "(layer added/renamed since the save?)")
            return node
        out = walk(template, "")
        unconsumed = stored - consumed
        if unconsumed:
            warnings.warn(_unconsumed_msg(group, unconsumed), stacklevel=3)
        return out

    params = rebuild("params", ts.params)
    mstate = rebuild("model_state", ts.model_state)
    opt = rebuild("opt_state", ts.opt_state)
    new_ts = TrainState(params, mstate, opt, int(manifest["iteration"]))
    model.train_state = new_ts
    from deeplearning4j_tpu_torch.observe.registry import default_registry
    r = default_registry()
    r.counter("dl4j_elastic_restore_total",
              "sharded-checkpoint restore events (elastic "
              "resume/reshape)").inc()
    r.gauge("dl4j_elastic_restored_step",
            "iteration of the most recent restored checkpoint"
            ).set(manifest["iteration"])
    return new_ts


class ElasticTrainer:
    """Periodic sharded checkpoints and a resumable fit."""

    def __init__(self, model, directory: str,
                 checkpoint_every: int = 100,
                 mesh=None,
                 keep_last: Optional[int] = 5):
        if keep_last is not None and keep_last < 1:
            raise ValueError(
                "keep_last must be >= 1 (or None to disable pruning)")
        self.model = model
        self.directory = directory
        self.checkpoint_every = checkpoint_every
        self.mesh = mesh
        self.keep_last = keep_last

    def _prune(self):
        """Drop the oldest committed checkpoints beyond ``keep_last``:
        rank 0 only, after the save's commit barrier returned (ranks
        racing one ``rmtree`` could see a half-deleted checkpoint as the
        latest)."""
        if rank() != 0:
            return
        if self.keep_last is None or not os.path.isdir(self.directory):
            return
        steps = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, d,
                                            "COMMITTED")))
        for d in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, d))

    def resume(self) -> bool:
        """Restore the newest committed checkpoint; True when one was
        found."""
        from deeplearning4j_tpu_torch.observe.tracer import get_tracer
        path = latest_checkpoint(self.directory)
        if path is None:
            return False
        with get_tracer(self.model).span("checkpoint", cat="io",
                                         op="restore"):
            restore_sharded(self.model, path, mesh=self.mesh)
        return True

    def fit(self, iterator, epochs: int = 1):
        """The model's own fit loop; the periodic saves ride a listener."""
        from deeplearning4j_tpu_torch.observe.tracer import get_tracer
        from deeplearning4j_tpu_torch.optimize.listeners import \
            TrainingListener

        trainer = self

        class _Saver(TrainingListener):
            def __init__(self):
                self.last_saved = None

            def iteration_done(self, model, iteration, epoch, loss,
                               etl_ms, examples):
                if self.last_saved is None:
                    self.last_saved = int(iteration) - 1
                if iteration - self.last_saved >= trainer.checkpoint_every:
                    with get_tracer(model).span("checkpoint", cat="io",
                                                op="save"):
                        save_sharded(model.train_state, trainer.directory)
                        trainer._prune()
                    self.last_saved = int(iteration)

        m = self.model
        saver = _Saver()
        m.add_listeners(saver)
        try:
            m.fit(iterator, epochs=epochs)
        except BaseException:
            # best-effort emergency save (barrier-free with several
            # ranks); never masks the original failure
            try:
                if m.params is not None:
                    save_sharded(m.train_state, self.directory,
                                 emergency=world_size() > 1)
                    self._prune()
            except BaseException as save_err:
                warnings.warn(
                    "elastic trainer: emergency checkpoint failed "
                    f"({type(save_err).__name__}: {save_err}); "
                    "original exception propagates", stacklevel=2)
            raise
        finally:
            m.listeners.remove(saver)
        if saver.last_saved != int(m.iteration):
            with get_tracer(m).span("checkpoint", cat="io", op="save"):
                save_sharded(m.train_state, self.directory)
                self._prune()
        return m

