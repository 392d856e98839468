"""The ranks of the port's model-parallel tests (test_torch_tensor_parallel,
test_torch_sequence_parallel, test_torch_pipeline_parallel,
test_torch_expert_parallel, test_torch_3d_parallel): one spawned gloo group
a module runs every scenario of a spec, each rank (or rank 0, for whole
trees gathered over the group) writing what it ends with.

A scenario names a kind (a function below), its mesh and the files it
reads: model zips, arrays (``.npz``, tree paths joined by "/"). This
module imports no JAX: a spawned rank imports it by name.
"""

import json
import os

import numpy as np
import torch


# ---- trees as flat npz files ---------------------------------------------------

def flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    out[prefix] = (tree.detach().float().cpu().numpy()
                   if isinstance(tree, torch.Tensor) else np.asarray(tree))
    return out


def unflat(arrays, dtype=torch.float32):
    tree = {}
    for path, a in arrays.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(a)).to(
            dtype if np.asarray(a).dtype.kind == "f" else None)
    return tree


def load_tree(path):
    return unflat(dict(np.load(path)))


def save_tree(path, tree):
    np.savez(path, **flat(tree))


# ---- scenarios --------------------------------------------------------------------

def _mesh(axes):
    from deeplearning4j_tpu_torch.parallel.mesh import create_mesh
    return create_mesh(dict(axes))


def tp_fit(rank, sc, out_dir):
    """A model zip fitted through ParallelWrapper(tensor_parallel) on
    ``sc["axes"]``; rank 0 writes the whole trees after the fit (and the
    per-step census of the first batch, before it)."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        gather_train_state
    from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                           TrainingMode)
    m = restore_model(sc["zip"], device="cpu", load_updater=True)
    data = np.load(sc["data"])
    n = len([k for k in data.files if k.startswith("x")])
    batches = [DataSet(data[f"x{i}"], data[f"y{i}"]) for i in range(n)]
    w = (ParallelWrapper.builder(m).mesh(_mesh(sc["axes"]))
         .training_mode(TrainingMode.SHARED_GRADIENTS)
         .tensor_parallel().build())
    info = {"plan_parts": {k: sorted(v) for k, v in
                           m._tp_plan.parts.items()},
            "fallback": m._tp_plan.fallback,
            "local_shapes": {k: list(v.shape) for k, v in
                             flat(m.params).items()}}
    if sc.get("census"):
        info["census"] = w.collective_census(batches[0])
    losses = []
    for _ in range(sc.get("epochs", 1)):
        w.fit(ListDataSetIterator(batches))
        losses.append(float(m._last_loss))
    info["losses"] = losses
    if sc.get("int8"):
        # the int8 walk of the split model: calibrated and quantized on
        # this rank's slices, against the split f32 forward
        from deeplearning4j_tpu_torch.parallel.quant import (PrecisionPolicy,
                                                             quantize_model)
        x = np.concatenate([b.features for b in batches])
        qm = quantize_model(m, PrecisionPolicy.int8(samples=x))
        xt = torch.from_numpy(x)
        y_q = qm.build_inference_fn()(qm.params, m.model_state, xt)
        y_f = m.output(xt)
        info["int8"] = {"quantized": qm.quantized_layers,
                        "rel_l2": float(torch.linalg.vector_norm(y_q - y_f)
                                        / torch.linalg.vector_norm(y_f)),
                        "argmax_agree": float((y_q.argmax(-1) == y_f.argmax(
                            -1)).float().mean())}
    ts = gather_train_state(m)
    if rank == 0:
        save_tree(os.path.join(out_dir, f"{sc['name']}.npz"),
                  {"params": ts.params, "model_state": ts.model_state})
        with open(os.path.join(out_dir, f"{sc['name']}.json"), "w") as f:
            json.dump(info, f)


def tp_output(rank, sc, out_dir):
    """The graph of a zip split by ``plan_tp`` on ``sc["axes"]``: its
    output on the inputs of ``sc["data"]`` (written by rank 0)."""
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        plan_tp, shard_train_state)
    m = restore_model(sc["zip"], device="cpu")
    data = np.load(sc["data"])
    inputs = [torch.from_numpy(data[k]) for k in sorted(data.files)]
    plan = plan_tp(m, _mesh(sc["axes"]))
    shard_train_state(m, plan)
    y = m.output(*inputs)
    if rank == 0:
        np.save(os.path.join(out_dir, f"{sc['name']}.npy"), y.numpy())
        with open(os.path.join(out_dir, f"{sc['name']}.json"), "w") as f:
            json.dump({"parts": {k: sorted(v) for k, v in
                                 plan.parts.items()}}, f)


def _gather_time(t, ax):
    from deeplearning4j_tpu_torch.parallel.mesh import all_gather
    return all_gather(t.detach().contiguous(), 1, ax.group)


def seq_attention(rank, sc, out_dir):
    """Ring or Ulysses attention over the ``sp`` axis on this rank's
    slice of q, k, v (and the mask); rank 0 writes the whole output and
    the whole gradients of sum(out ** 2)."""
    from deeplearning4j_tpu_torch.parallel import ring_attention as RA
    mesh = _mesh(sc["axes"])
    ax = mesh.axis(RA.SEQ_AXIS)
    data = np.load(sc["data"])
    tl = data["q"].shape[1] // ax.size
    rows = slice(ax.index * tl, (ax.index + 1) * tl)
    q, k, v = (torch.from_numpy(data[n][:, rows]).requires_grad_()
               for n in "qkv")
    mask = (torch.from_numpy(data["mask"][:, rows])
            if "mask" in data.files else None)
    fn = getattr(RA, sc["fn"])
    try:
        out = fn(q, k, v, mesh, mask=mask, causal=sc.get("causal", False))
    except ValueError as e:
        if rank == 0:
            with open(os.path.join(out_dir, f"{sc['name']}.json"),
                      "w") as f:
                json.dump({"error": str(e)}, f)
        return
    (out ** 2).sum().backward()
    res = {"out": _gather_time(out, ax)}
    for n, t in zip("qkv", (q, k, v)):
        res["d" + n] = _gather_time(t.grad, ax)
    if rank == 0:
        save_tree(os.path.join(out_dir, f"{sc['name']}.npz"), res)


def _tanh_stage(p, h, c=None):
    y = torch.tanh(h @ p["w"] + p["b"])
    return y if c is None else y * c


def pipe_apply(rank, sc, out_dir):
    """pipeline_apply of the tanh stages on ``sc["axes"]``: the output and
    the gradients of sum(out ** 2) for this rank's stages, gathered whole
    over the pipe axis (device-major order) by rank 0."""
    from deeplearning4j_tpu_torch.parallel.mesh import all_gather
    from deeplearning4j_tpu_torch.parallel.pipeline import (PIPE_AXIS,
                                                            local_stages,
                                                            pipeline_apply)
    mesh = _mesh(sc["axes"])
    ax = mesh.axis(PIPE_AXIS)
    data = np.load(sc["data"])
    stacked = local_stages({"w": torch.from_numpy(data["w"]),
                            "b": torch.from_numpy(data["b"])}, mesh)
    for t in stacked.values():
        t.requires_grad_()
    x = torch.from_numpy(data["x"]).requires_grad_()
    consts = (torch.from_numpy(data["consts"])
              if "consts" in data.files else None)
    info = {}
    try:
        out = pipeline_apply(_tanh_stage, stacked, x, mesh,
                             num_microbatches=sc.get("m"), consts=consts,
                             repeats=sc.get("repeats", 1),
                             remat=sc.get("remat", False))
    except ValueError as e:
        info["error"] = str(e)
        out = None
    if out is not None:
        from deeplearning4j_tpu_torch.parallel.mesh import count_calls
        with count_calls() as bwd:
            (out ** 2).sum().backward()
        info["backward_calls"] = bwd
        res = {"out": out.detach(), "dx": x.grad,
               "dw": all_gather(stacked["w"].grad, 0, ax.group),
               "db": all_gather(stacked["b"].grad, 0, ax.group)}
        if rank == 0:
            save_tree(os.path.join(out_dir, f"{sc['name']}.npz"), res)
    if rank == 0:
        with open(os.path.join(out_dir, f"{sc['name']}.json"), "w") as f:
            json.dump(info, f)


def _lm(sc, mesh):
    from deeplearning4j_tpu_torch.parallel.pipeline import \
        PipelinedTransformerLM
    g = sc["lm"]
    return PipelinedTransformerLM(vocab=g["vocab"], width=g["width"],
                                  n_heads=g["heads"],
                                  n_layers=g["layers"],
                                  max_len=g["max_len"], mesh=mesh,
                                  remat=g.get("remat", True))


def _requires_grad(tree):
    for t in flat_leaves(tree):
        t.requires_grad_()
    return tree


def flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat_leaves(v)]
    return [tree]


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad


def lm_loss(rank, sc, out_dir):
    """PipelinedTransformerLM from the whole parameters of ``sc["data"]``
    on ``sc["axes"]`` (dp × tp × pp when it has all three): the loss (the
    mean over the data axis) and the whole gradients, gathered over the
    model and pipe axes and averaged over the data axis, by rank 0; then
    ``sc["steps"]`` SGD steps and their losses."""
    from deeplearning4j_tpu_torch.parallel.mesh import all_reduce_
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        gather_tree)
    mesh = _mesh(sc["axes"])
    lm = _lm(sc, mesh)
    data = np.load(sc["data"])
    whole = unflat({k[len("params/"):]: data[k] for k in data.files
                    if k.startswith("params/")})
    specs = lm.param_shardings(whole)
    params = _requires_grad(lm.shard_params(whole))
    dx = mesh.axis("data")
    rows = slice(dx.index * (data["toks"].shape[0] // dx.size),
                 (dx.index + 1) * (data["toks"].shape[0] // dx.size))
    toks = torch.from_numpy(data["toks"][rows]).long()
    tgts = torch.from_numpy(data["tgts"][rows]).long()
    loss = lm.loss(params, toks, tgts)
    loss.backward()
    grads = _grads(params)

    def data_mean(t):
        return all_reduce_(t.detach().clone(), group=dx.group) / dx.size
    whole_grads = gather_tree(
        {k: v for k, v in _tree_map(data_mean, grads).items()}, specs, mesh)
    info = {"loss": float(data_mean(loss.reshape(1)))}
    lr = sc.get("lr", 0.1)
    with torch.no_grad():
        p = _tree_map(lambda a, g: (a - lr * data_mean(g)),
                      params, grads)
    losses = []
    for _ in range(sc.get("steps", 0)):
        p = _requires_grad(_tree_map(lambda a: a.detach().clone(), p))
        loss = lm.loss(p, toks, tgts)
        loss.backward()
        losses.append(float(data_mean(loss.detach().reshape(1))))
        with torch.no_grad():
            p = _tree_map(lambda a, g: a - lr * data_mean(g), p, _grads(p))
    info["step_losses"] = losses
    if sc.get("ckpt"):
        from deeplearning4j_tpu_torch.optimize.solver import TrainState
        from deeplearning4j_tpu_torch.parallel.checkpoint import save_sharded
        plain = _tree_map(lambda a: a.detach(), params)
        info["ckpt"] = save_sharded(TrainState(plain, {}, {}, 0),
                                    sc["ckpt"], mesh=mesh,
                                    specs={"params": specs})
    if rank == 0:
        save_tree(os.path.join(out_dir, f"{sc['name']}.npz"), whole_grads)
        with open(os.path.join(out_dir, f"{sc['name']}.json"), "w") as f:
            json.dump(info, f)


def lm_restore(rank, sc, out_dir):
    """A checkpoint of the LM written on another layout restored onto
    ``sc["axes"]`` (each rank its region), its stages restacked from
    ``sc["from_pipe"]`` to this pipe size: the loss, by rank 0."""
    from types import SimpleNamespace

    from deeplearning4j_tpu_torch.optimize.solver import TrainState
    from deeplearning4j_tpu_torch.parallel.checkpoint import restore_sharded
    from deeplearning4j_tpu_torch.parallel.mesh import all_reduce_
    from deeplearning4j_tpu_torch.parallel.pipeline import restack_stages
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        gather_tree, shard_tree)
    mesh = _mesh(sc["axes"])
    lm = _lm(sc, mesh)
    data = np.load(sc["data"])
    whole_tmpl = unflat({k[len("params/"):]: np.zeros_like(data[k])
                         for k in data.files if k.startswith("params/")})
    specs = lm.param_shardings(whole_tmpl)
    tmpl = shard_tree(whole_tmpl, specs, mesh)
    shim = SimpleNamespace(train_state=TrainState(tmpl, {}, {}, 0))
    restored = restore_sharded(shim, sc["ckpt"], mesh=mesh,
                               param_shardings=specs)
    params = dict(restored.params)
    # restack on the whole stage dim: gather over the pipe axis, permute,
    # take this rank's block again
    blocks = gather_tree(params["blocks"], specs["blocks"], mesh)
    blocks = restack_stages(blocks, from_devices=sc["from_pipe"],
                            to_devices=int(mesh.shape["pipe"]))
    params["blocks"] = shard_tree(blocks, specs["blocks"], mesh)
    dx = mesh.axis("data")
    rows = slice(dx.index * (data["toks"].shape[0] // dx.size),
                 (dx.index + 1) * (data["toks"].shape[0] // dx.size))
    with torch.no_grad():
        loss = lm.loss(params, torch.from_numpy(data["toks"][rows]).long(),
                       torch.from_numpy(data["tgts"][rows]).long())
    loss = all_reduce_(loss.reshape(1).clone(), group=dx.group) / dx.size
    if rank == 0:
        with open(os.path.join(out_dir, f"{sc['name']}.json"), "w") as f:
            json.dump({"loss": float(loss)}, f)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def experts(rank, sc, out_dir):
    """moe_ffn with the experts split over the ``expert`` axis: each rank
    its tokens and its experts; rank 0 writes the whole output, the
    dispatch counts and the aux and z losses."""
    from deeplearning4j_tpu_torch.parallel import moe as TM
    from deeplearning4j_tpu_torch.parallel.mesh import (all_gather,
                                                        all_reduce_)
    mesh = _mesh(sc["axes"])
    ax = mesh.axis(TM.EXPERT_AXIS)
    data = np.load(sc["data"])
    t = data["x"].shape[0] // ax.size
    e = data["w_in"].shape[0] // ax.size
    mine = lambda a, n: torch.from_numpy(a[ax.index * n:(ax.index + 1) * n])
    TM.set_default_mesh(mesh)
    try:
        out = TM.moe_ffn(mine(data["x"], t), torch.from_numpy(data["gate_w"]),
                         mine(data["w_in"], e), mine(data["b_in"], e),
                         mine(data["w_out"], e), mine(data["b_out"], e),
                         top_k=sc.get("top_k", 2))
    finally:
        TM.set_default_mesh(None)
    y = all_gather(out.y.contiguous(), 0, ax.group)
    dispatched = all_reduce_(out.dispatched.reshape(1).clone(),
                             group=ax.group)
    if rank == 0:
        np.save(os.path.join(out_dir, f"{sc['name']}.npy"), y.numpy())
        with open(os.path.join(out_dir, f"{sc['name']}.json"), "w") as f:
            json.dump({"aux": float(out.aux_loss),
                       "z": float(out.router_z_loss),
                       "dispatched": float(dispatched.item())}, f)


KINDS = {f.__name__: f for f in (tp_fit, tp_output, seq_attention,
                                 pipe_apply, lm_loss, lm_restore, experts)}


def run_scenarios(rank, world, spec_path, out_dir):
    """Every scenario of the spec (a list, run in order), in this rank."""
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    for sc in spec:
        KINDS[sc["kind"]](rank, sc, out_dir)


class SpawnedGroup:
    """``spec`` written under ``root`` and run in ``world`` spawned gloo
    ranks on a thread, so the test process builds its references
    meanwhile; ``out()`` waits for the ranks, checks their exit codes and
    returns the output directory."""

    def __init__(self, root, spec, world, name, timeout_s=240.0):
        import threading

        from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
        spec_path = os.path.join(root, f"{name}.spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        self._out = os.path.join(root, f"{name}.out")
        os.makedirs(self._out, exist_ok=True)
        self.world = world
        self.codes = []
        self._thread = threading.Thread(target=lambda: self.codes.extend(
            spawn_ranks(run_scenarios, world, (spec_path, self._out),
                        run_dir=root, timeout_s=timeout_s,
                        group_timeout_s=120.0, name=name)))
        self._thread.start()

    def join(self):
        self._thread.join()

    def out(self):
        self.join()
        assert self.codes == [0] * self.world, self.codes
        return self._out
