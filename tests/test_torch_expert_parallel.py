"""Expert parallelism of the port against the JAX package.

The JAX side is ``moe_ffn`` unsplit and under an expert mesh over the
eight virtual CPU devices (tests/conftest.py); the port's side is four
gloo ranks spawned once for the module (tests/torch_model_parallel_workers.py),
each holding 2 of the 8 experts and a quarter of the tokens, with the
capacity buffers dispatched and combined by all-to-all. Both take the
same tokens and weights, made with numpy from a seed. The capacity is
tight enough that tokens are dropped: the same ones on both sides, since
every rank routes every token in the global order. The slots the split
layer's own dispatch fills, summed over the ranks, equal the unsplit JAX
router's.

Bounds: the output within 1e-5 of its largest entry, the aux and z
losses within 1e-5 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_parallel_workers as W
from deeplearning4j_tpu.parallel.mesh import create_mesh
from deeplearning4j_tpu.parallel.moe import (EXPERT_AXIS, MoEOutput,
                                             moe_ffn, route_top_k,
                                             set_default_mesh)

torch.set_num_threads(1)

RANKS = 4
FWD = 1e-5
# name: (tokens, width, hidden, experts, top_k, seed)
CASES = {"top2": (32, 8, 16, 8, 2, 1), "top1_tight": (64, 8, 16, 8, 1, 3)}


def _arrays(t, d, f, e, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=0.3: (rng.normal(size=s) * sc).astype(np.float32)
    return {"x": n(t, d, sc=1.0), "gate_w": n(d, e, sc=1.0),
            "w_in": n(e, d, f), "b_in": n(e, f, sc=0.1),
            "w_out": n(e, f, d), "b_out": n(e, d, sc=0.1)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("expert_parallel"))
    spec, ref = [], {}
    for name, (t, d, f, e, k, seed) in CASES.items():
        arrays = _arrays(t, d, f, e, seed)
        np.savez(f"{root}/{name}.npz", **arrays)
        spec.append({"kind": "experts", "name": name,
                     "data": f"{root}/{name}.npz",
                     "axes": {EXPERT_AXIS: RANKS}, "top_k": k})
        ref[name] = arrays
    group = W.SpawnedGroup(root, spec, RANKS, "experts")
    yield {"group": group, "ref": ref}
    group.join()


def _jax(arrays, k, mesh=None):
    a = {n: jnp.asarray(v) for n, v in arrays.items()}
    set_default_mesh(mesh)
    try:
        out = jax.jit(lambda a: dataclasses.astuple(moe_ffn(
            a["x"], a["gate_w"], a["w_in"], a["b_in"], a["w_out"],
            a["b_out"], top_k=k)))(a)
    finally:
        set_default_mesh(None)
    return MoEOutput(*out)


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_matches_jax(world, name):
    """The port's four-rank split layer against the JAX package's layer,
    unsplit and split over 8 expert devices; the router drops tokens."""
    t, d, f, e, k, _ = CASES[name]
    arrays = world["ref"][name]
    want = _jax(arrays, k)
    split = _jax(arrays, k, create_mesh({EXPERT_AXIS: 8}))
    cap = max(1, int(1.25 * k * t / e))
    dispatch, _, _, _ = route_top_k(jnp.asarray(arrays["x"] @ arrays[
        "gate_w"]), k, cap)
    assert float(dispatch.sum()) < k * t          # some tokens dropped
    out = world["group"].out()
    got = np.load(f"{out}/{name}.npy")
    with open(f"{out}/{name}.json") as fh:
        info = json.load(fh)
    scale = np.abs(np.asarray(want.y)).max()
    for ref in (want.y, split.y):
        assert np.abs(got - np.asarray(ref)).max() <= FWD * scale
    assert abs(info["aux"] - float(want.aux_loss)) <= FWD * abs(
        float(want.aux_loss))
    assert abs(info["z"] - float(want.router_z_loss)) <= FWD * abs(
        float(want.router_z_loss))
    assert info["dispatched"] == float(dispatch.sum())
