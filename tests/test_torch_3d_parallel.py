"""3D dp×tp×pp composition of the port against the JAX package.

tests/test_3d_parallel.py's model: ``PipelinedTransformerLM`` (vocab 16,
width 8, 2 heads, 4 layers) on a {data 2, model 2, pipe 2} mesh: the
batch split over the data axis, Megatron tensor parallelism inside each
stage (1 of the 2 heads and half the FFN a rank), the circular schedule
over the pipe axis (2 stages × 2 repeats), the head split by vocabulary
column. The port's side is eight gloo ranks spawned once for the module
(tests/torch_model_parallel_workers.py); the JAX side is the same
model's loss on the same weights and tokens (made from a seed), whose
own tests hold its pipelined 3D loss to this one.

- the loss and every gradient (gathered whole over the model and pipe
  axes, averaged over the data axis) against ``jax.grad`` of the JAX
  model's loss; two SGD steps lower it;
- a sharded checkpoint written on 2×2×2 (each rank its pieces, with
  their offsets in the whole leaves) restored onto {data 1, model 2,
  pipe 4} (each rank reads its own region), its stages restacked from 2
  to 4 devices: the same loss.

Bounds: the loss within 1e-5 relative, gradients within rel 1e-4 of each
leaf's largest magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_model_parallel_workers as W
from deeplearning4j_tpu.parallel.pipeline import (PIPE_AXIS,
                                                  PipelinedTransformerLM)

torch.set_num_threads(1)

RANKS = 8
VOCAB, WIDTH, T = 16, 8, 6
LM = dict(vocab=VOCAB, width=WIDTH, heads=2, layers=4, max_len=T)
REL = 1e-4


def _jax_lm(dp, tp, pp):
    devs = np.asarray(jax.devices()[: dp * tp * pp]).reshape(dp, tp, pp)
    mesh = Mesh(devs, ("data", "model", PIPE_AXIS))
    return PipelinedTransformerLM(vocab=VOCAB, width=WIDTH, n_heads=2,
                                  n_layers=4, max_len=T, mesh=mesh,
                                  remat=True)


def _data(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (batch, T)),
            rng.integers(0, VOCAB, (batch, T)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_3d"))
    lm = _jax_lm(2, 2, 2)
    params = lm.init(jax.random.PRNGKey(3))
    toks, tgts = _data(8, 0)
    whole = W.flat(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), params))
    np.savez(f"{root}/lm.npz", toks=toks, tgts=tgts,
             **{f"params/{k}": v for k, v in whole.items()})
    ckpt = f"{root}/ckpt"
    spec = [{"kind": "lm_loss", "name": "lm3d", "data": f"{root}/lm.npz",
             "axes": {"data": 2, "model": 2, "pipe": 2}, "lm": LM,
             "steps": 2, "lr": 0.1, "ckpt": ckpt},
            {"kind": "lm_restore", "name": "restored",
             "data": f"{root}/lm.npz", "ckpt": f"{ckpt}/step_0000000000",
             "axes": {"data": 1, "model": 2, "pipe": 4}, "lm": LM,
             "from_pipe": 2}]
    group = W.SpawnedGroup(root, spec, RANKS, "p3d", timeout_s=300.0)
    yield {"group": group, "lm": lm, "params": params, "toks": toks,
           "tgts": tgts}
    group.join()


def _jax_loss_grad(world):
    lm = world["lm"]
    return jax.jit(jax.value_and_grad(lambda p: lm.loss(
        p, jnp.asarray(world["toks"]), jnp.asarray(world["tgts"]),
        pipelined=False)))(world["params"])


def _ranks(world, name):
    out = world["group"].out()
    with open(f"{out}/{name}.json") as f:
        return json.load(f), out


def test_pipelined_tp_matches_jax(world):
    loss, grads = _jax_loss_grad(world)
    info, out = _ranks(world, "lm3d")
    assert info["loss"] == pytest.approx(float(loss), rel=1e-5)
    got = W.flat(W.load_tree(f"{out}/lm3d.npz"))
    want = W.flat(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), grads))
    assert set(got) == set(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= REL * max(np.abs(want[k]).max(), 1e-30), (k, err)


def test_3d_train_step_moves_params(world):
    info, _ = _ranks(world, "lm3d")
    losses = [info["loss"]] + info["step_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_cross_layout_restore(world):
    """Saved on 2dp×2tp×2pp (circular, 2 stages × 2 repeats), restored
    onto 1dp×2tp×4pp (4 straight stages): the same function."""
    loss, _ = _jax_loss_grad(world)
    info, _ = _ranks(world, "restored")
    assert info["loss"] == pytest.approx(float(loss), rel=1e-5)
