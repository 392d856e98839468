"""Pipeline parallelism of the port against the JAX package.

The JAX side runs ``pipeline_apply`` and ``PipelinedTransformerLM`` on a
pipe mesh over the first S of the eight virtual CPU devices
(tests/conftest.py), its gradients by ``jax.grad`` (the VJP of
``ppermute``); the port's side is four gloo ranks spawned once for the
module (tests/torch_model_parallel_workers.py), whose backward is the
reverse schedule the port runs itself. Both take the same inputs and
stage weights, made with numpy from a seed.

- GPipe (S 4, M 8), its gradients (S 4, M 4), the circular schedule (S 4,
  R 2, M 4) with its ``ValueError`` at M 8, per-microbatch consts, the
  default microbatch count and the batch that does not split (S 2 on a
  {data 2, pipe 2} mesh);
- the LM (S 4, R 2, remat) against the JAX package's pipelined loss and
  gradients, and five SGD steps that lower the loss;
- the census of one GPipe forward and backward: M + S - 1 hops each way.

Bounds: outputs within 1e-5 of their largest entry, gradients within rel
1e-4 of each leaf's largest magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_parallel_workers as W
from deeplearning4j_tpu.parallel.mesh import create_mesh
from deeplearning4j_tpu.parallel.pipeline import (PIPE_AXIS,
                                                  PipelinedTransformerLM,
                                                  pipeline_apply,
                                                  stack_stage_params)

torch.set_num_threads(1)

RANKS = 4
FWD = 1e-5
GRAD = 1e-4


def _stages(seed, d, n):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
             "b": (rng.normal(size=(d,)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jstage_c(p, x, c):
    return jnp.tanh(x @ p["w"] + p["b"]) * c


# name: (S, R, M, d, batch, seed, consts, axes)
CASES = {
    "gpipe_fwd": (4, 1, 8, 16, 32, 0, False, {"pipe": 4}),
    "gpipe_grad": (4, 1, None, 8, 16, 1, False, {"pipe": 4}),
    "circular": (4, 2, 4, 8, 16, 4, False, {"pipe": 4}),
    "circular_bad_m": (4, 2, 8, 8, 16, 4, False, {"pipe": 4}),
    "consts": (4, 1, None, 4, 8, 5, True, {"pipe": 4}),
    "default_m": (2, 1, None, 4, 6, 2, False, {"data": 2, "pipe": 2}),
    "indivisible": (2, 1, 4, 4, 7, 2, False, {"data": 2, "pipe": 2}),
}
LM = dict(vocab=16, width=8, heads=2, layers=8, max_len=12)


def _jax_lm(S):
    mesh = create_mesh({PIPE_AXIS: S}, jax.devices()[:S])
    return PipelinedTransformerLM(vocab=LM["vocab"], width=LM["width"],
                                  n_heads=LM["heads"], n_layers=LM["layers"],
                                  max_len=LM["max_len"], mesh=mesh,
                                  remat=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline_parallel"))
    spec, ref = [], {}
    for name, (S, R, M, d, batch, seed, consts, axes) in CASES.items():
        per = _stages(seed, d, S * R)
        stacked = stack_stage_params(per, num_devices=S)
        rng = np.random.default_rng(seed + 100)
        x = rng.normal(size=(batch, d)).astype(np.float32)
        arrays = {"w": np.asarray(stacked["w"]), "b": np.asarray(stacked["b"]),
                  "x": x}
        if consts:
            arrays["consts"] = np.arange(1.0, batch + 1.0,
                                         dtype=np.float32)[:, None]
        path = f"{root}/{name}.npz"
        np.savez(path, **arrays)
        spec.append({"kind": "pipe_apply", "name": name, "data": path,
                     "axes": axes, "m": M, "repeats": R})
        ref[name] = (S, R, M, stacked, x, arrays.get("consts"))
    lm = _jax_lm(4)
    params = lm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, LM["vocab"], (8, 10))
    tgts = (toks + 1) % LM["vocab"]
    path = f"{root}/lm.npz"
    np.savez(path, toks=toks, tgts=tgts, **{
        f"params/{k}": v for k, v in W.flat(jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), params)).items()})
    spec.append({"kind": "lm_loss", "name": "lm", "data": path,
                 "axes": {"data": 1, "model": 1, "pipe": 4}, "lm": LM,
                 "steps": 5, "lr": 0.5})
    # the ranks run while the tests build their JAX references
    group = W.SpawnedGroup(root, spec, RANKS, "pipe")
    yield {"group": group, "ref": ref, "lm": (lm, params, toks, tgts)}
    group.join()


def _jax_run(S, R, M, stacked, x, consts):
    mesh = create_mesh({PIPE_AXIS: S}, jax.devices()[:S])
    fn = _jstage if consts is None else _jstage_c
    kw = dict(num_microbatches=M, repeats=R)
    if consts is not None:
        kw["consts"] = jnp.asarray(consts)

    def loss(p, xx):
        out = pipeline_apply(fn, p, xx, mesh, **kw)
        return jnp.sum(out ** 2), out
    (_, out), (g, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(x))
    return np.asarray(out), g, np.asarray(gx)


def _close(got, want, rel, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _port(world, name):
    out = world["group"].out()
    with open(f"{out}/{name}.json") as f:
        info = json.load(f)
    return W.unflat(dict(np.load(f"{out}/{name}.npz"))), info


@pytest.mark.parametrize("name", ["gpipe_fwd", "gpipe_grad", "circular",
                                  "consts", "default_m"])
def test_pipeline_matches_jax(world, name):
    """Output, dx and the stacked stage gradients (device-major order)."""
    got, info = _port(world, name)
    out, g, gx = _jax_run(*world["ref"][name])
    _close(got["out"], out, FWD, "out")
    _close(got["dx"], gx, GRAD, "dx")
    _close(got["dw"], g["w"], GRAD, "dw")
    _close(got["db"], g["b"], GRAD, "db")


@pytest.mark.parametrize("name,match", [
    ("circular_bad_m", "num_microbatches == num_stages"),
    ("indivisible", "not divisible into 4 microbatches")])
def test_pipeline_value_errors(world, name, match):
    S, R, M, stacked, x, consts = world["ref"][name]
    mesh = create_mesh({PIPE_AXIS: S}, jax.devices()[:S])
    with pytest.raises(ValueError, match=match):
        pipeline_apply(_jstage, stacked, jnp.asarray(x), mesh,
                       num_microbatches=M, repeats=R)
    with open(f"{world['group'].out()}/{name}.json") as f:
        assert match in json.load(f)["error"]


def test_pipeline_backward_census(world):
    """One GPipe backward (S 4, M 4): the reverse of its 7 forward hops,
    and the input's all-reduce (its cotangent summed over the axis)."""
    _, info = _port(world, "gpipe_grad")
    assert info["backward_calls"] == {"ppermute": 7, "all_reduce": 1}


def test_pipelined_lm_matches_jax(world):
    """PipelinedTransformerLM, S 4 × R 2 circular with remat: the loss and
    every gradient against the JAX package's pipelined LM."""
    lm, params, toks, tgts = world["lm"]
    loss, g = jax.jit(jax.value_and_grad(lambda p: lm.loss(
        p, jnp.asarray(toks), jnp.asarray(tgts))))(params)
    got, info = _port(world, "lm")
    assert abs(info["loss"] - float(loss)) <= FWD * abs(float(loss))
    want = W.flat(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), g))
    got = W.flat(got)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], GRAD, k)


def test_pipelined_lm_trains(world):
    """Five SGD steps (lr 0.5) on next-token targets lower the loss."""
    _, info = _port(world, "lm")
    losses = [info["loss"]] + info["step_losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_lm_init_is_seeded_and_device_major():
    """The port's LM draws its whole parameters from a seed, on the card
    unless the caller asks for the CPU, its blocks in the device-major
    stack of ``stack_stage_params``: at pipe 4, position p holds global
    stage [0, 4, 1, 5, 2, 6, 3, 7][p] of the same draw at pipe 1."""
    from deeplearning4j_tpu_torch.parallel.mesh import create_mesh as tmesh
    from deeplearning4j_tpu_torch.parallel.pipeline import \
        PipelinedTransformerLM as TLM

    def lm(pipe):
        return TLM(vocab=LM["vocab"], width=LM["width"], n_heads=LM["heads"],
                   n_layers=LM["layers"], max_len=LM["max_len"],
                   mesh=tmesh({"pipe": pipe}, range(pipe)))
    lm4 = lm(4)
    a, b = lm4.init(5, device="cpu"), lm4.init(5, device="cpu")
    assert all(np.array_equal(x, y) for x, y in zip(
        W.flat(a).values(), W.flat(b).values()))
    straight = lm(1).init(5, device="cpu")
    order = [0, 4, 1, 5, 2, 6, 3, 7]
    assert torch.equal(a["blocks"]["W1"],
                       straight["blocks"]["W1"][torch.tensor(order)])
    assert torch.equal(a["head"], straight["head"])
    assert lm4.repeats == 2 and lm4.num_microbatches == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm4.init(5)
