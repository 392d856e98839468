"""Sequence parallelism of the port against the JAX package.

The JAX side runs ``ring_self_attention`` over the eight virtual CPU
devices and ``ulysses_self_attention`` over four (tests/conftest.py), and
``scaled_dot_product_attention`` on the whole sequence; the port's side
is four gloo ranks spawned once for the module
(tests/torch_model_parallel_workers.py), each holding a quarter of the
sequence. Ulysses attends through ``ops.flash_attention``, whose CPU path
is the kernels' plain version. Both take the same q, k, v and masks,
made with numpy from a seed (tests/test_attention.py's shapes).

Bounds: outputs within 1e-5 of their largest entry, the gradients of
sum(out ** 2) within rel 1e-4 of each one's largest magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_model_parallel_workers as W
from deeplearning4j_tpu.nn.layers.attention import \
    scaled_dot_product_attention
from deeplearning4j_tpu.parallel.ring_attention import (
    ring_self_attention, ulysses_self_attention)

torch.set_num_threads(1)

RANKS = 4
FWD = 1e-5
GRAD = 1e-4


def _qkv(n=2, t=16, h=4, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, t, h, dh)).astype(np.float32)
            for _ in range(3)]


def _mask(seed, n=2, t=16):
    return (np.random.default_rng(seed).random((n, t)) > 0.3).astype(
        np.float32)


# name: (fn, causal, qkv kwargs, mask)
CASES = {
    "ring": ("ring_self_attention", False, {}, None),
    "ring_causal": ("ring_self_attention", True, {}, None),
    "ring_masked": ("ring_self_attention", False, {"seed": 1}, _mask(2)),
    "ring_dead_rows": ("ring_self_attention", False, {"t": 8, "seed": 9},
                       np.stack([np.ones(8), np.zeros(8)]).astype(
                           np.float32)),
    "ulysses": ("ulysses_self_attention", False, {}, None),
    "ulysses_causal": ("ulysses_self_attention", True, {"t": 8, "seed": 5},
                       None),
    "ulysses_masked": ("ulysses_self_attention", False, {"seed": 3},
                       _mask(4)),
    "ulysses_bad_heads": ("ulysses_self_attention", False, {"h": 3}, None),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sequence_parallel"))
    spec = []
    for name, (fn, causal, kw, mask) in CASES.items():
        q, k, v = _qkv(**kw)
        arrays = {"q": q, "k": k, "v": v}
        if mask is not None:
            arrays["mask"] = mask
        np.savez(f"{root}/{name}.npz", **arrays)
        spec.append({"kind": "seq_attention", "name": name, "fn": fn,
                     "causal": causal, "data": f"{root}/{name}.npz",
                     "axes": {"sp": RANKS}})
    group = W.SpawnedGroup(root, spec, RANKS, "seq")
    yield group
    group.join()


def _jax_fn(fn, mask, causal):
    devices = 8 if fn == "ring_self_attention" else 4
    mesh = Mesh(np.array(jax.devices()[:devices]), ("sp",))
    f = ring_self_attention if devices == 8 else ulysses_self_attention
    m = None if mask is None else jnp.asarray(mask)
    return (lambda q, k, v: f(q, k, v, mesh, mask=m, causal=causal),
            lambda q, k, v: scaled_dot_product_attention(q, k, v, mask=m,
                                                         causal=causal))


def _close(got, want, rel, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("name", [n for n in CASES if "bad" not in n])
def test_sequence_parallel_matches_jax(world, name):
    """Output and q/k/v gradients: the port's four ranks against the JAX
    package's sequence-parallel function and its single-chip attention."""
    fn, causal, kw, mask = CASES[name]
    q, k, v = (jnp.asarray(a) for a in _qkv(**kw))
    sp, single = _jax_fn(fn, mask, causal)
    got = W.load_tree(f"{world.out()}/{name}.npz")
    for f in (sp, single):
        loss = lambda q, k, v: jnp.sum(f(q, k, v) ** 2)
        out = jax.jit(f)(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        _close(got["out"].numpy(), out, FWD, "out")
        for n, g in zip("qkv", grads):
            assert np.isfinite(got["d" + n].numpy()).all()
            _close(got["d" + n].numpy(), g, GRAD, "d" + n)


def test_ulysses_heads_divisibility_enforced(world):
    with open(f"{world.out()}/ulysses_bad_heads.json") as f:
        err = json.load(f)["error"]
    assert "divisible" in err
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_self_attention(*(jnp.asarray(a) for a in _qkv(h=3)), mesh)
