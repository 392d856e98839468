"""The whole slice: the port's fused-block ResNet50 against the JAX
package's, at 32×32 input and batch 2, weights carried across by
``params_from_jax`` and checkpoints carried across in both directions.

The BN running statistics and affine params are made with numpy so the
random-weight network keeps O(1) activations (the residual branches'
last BN gets a small gamma). Tolerances: float32 pooled features and
probabilities atol 1e-5 (the same f32 math summed in other orders through
~50 layers); bfloat16 pooled features atol 5e-2 (bf16 roundings at other
places in the two frameworks, 2^-8 relative each) and probabilities atol
5e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JGraph
from deeplearning4j_tpu.models.serialization import \
    restore_computation_graph as jax_restore
from deeplearning4j_tpu.models.serialization import save_model as jax_save
from deeplearning4j_tpu.zoo.models import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.models.serialization import (params_from_jax,
                                                           restore_model,
                                                           save_model)
from deeplearning4j_tpu_torch.zoo.models import ResNet50, fold_stem_weights

# one intra-op thread a test process: the suite runs its workers side
# by side on the machine's cores, and a torch thread pool per worker
# oversubscribes them (small ops then wait on spinning threads)
torch.set_num_threads(1)

CFG = dict(num_classes=10, height=32, width=32, channels=3,
           fused_blocks=True, s2d_stem=True)


def _nontrivial(params, state, rng):
    for st in state.values():
        for k, v in st.items():
            if k.endswith("mean"):
                st[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k.endswith("var"):
                st[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    for lp in params.values():
        for k, v in lp.items():
            if k in ("bn3_gamma", "bnds_gamma"):
                lp[k] = rng.uniform(0.2, 0.4, v.shape).astype(np.float32)
            elif k.endswith("gamma"):
                lp[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k.endswith("beta"):
                lp[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    jm = JResNet50(**CFG).init()
    rng = np.random.default_rng(0)
    p = jax.tree_util.tree_map(np.asarray, jm.train_state.params)
    s = jax.tree_util.tree_map(np.asarray, jm.train_state.model_state)
    _nontrivial(p, s, rng)
    jm.train_state = jm.train_state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, p),
        model_state=jax.tree_util.tree_map(jnp.asarray, s))
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    return jm, p, s, x


@pytest.fixture(scope="module")
def jax_f32_acts(jax_model):
    """The JAX model's f32 activations on the fixture input, computed once
    (its Pallas kernels run in interpret mode, tens of seconds a walk) for
    the slice check and the checkpoint check that both compare with it."""
    jm, _, _, x = jax_model
    return _jax_acts(jm, x)


def _jax_acts(jm, x):
    acts, _ = jm._walk(jm.train_state.params, jm.train_state.model_state,
                       {"in": jnp.asarray(x)}, {"__default__": None}, False,
                       None, False)
    return {k: np.asarray(acts[k].astype(jnp.float32))
            for k in ("avgpool", "out")}


def _torch_acts(tm, x):
    with torch.inference_mode():
        acts, _ = tm._walk(tm.params, tm.model_state,
                           {"in": torch.from_numpy(x)})
    return {k: acts[k].float().numpy() for k in ("avgpool", "out")}


@pytest.mark.parametrize("dtype,feat_tol,prob_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 5e-2, 5e-3)])
def test_resnet50_slice_matches_jax(jax_model, jax_f32_acts, dtype, feat_tol,
                                    prob_tol):
    jm, p, s, x = jax_model
    cfg = dict(CFG, compute_dtype=dtype)
    if dtype == "float32":          # CFG's own dtype: the fixture's model
        want = jax_f32_acts
    else:
        jg = JGraph(JResNet50(**cfg).conf())
        jg.train_state = jm.train_state
        want = _jax_acts(jg, x)
    tm = ResNet50(**cfg).init(device="cpu")
    params_from_jax(p, s, "cpu", model=tm)
    got = _torch_acts(tm, x)
    assert np.abs(want["avgpool"]).max() < 10       # O(1) activations
    np.testing.assert_allclose(got["avgpool"], want["avgpool"], atol=feat_tol,
                               rtol=0)
    np.testing.assert_allclose(got["out"], want["out"], atol=prob_tol, rtol=0)
    out = tm.output(x)
    assert out.shape == (2, 10) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().sum(1).numpy(), 1.0, atol=1e-2)


def test_configuration_json_matches_jax():
    for dt in ("float32", "bfloat16"):
        cfg = dict(CFG, compute_dtype=dt)
        assert json.loads(ResNet50(**cfg).conf().to_json()) == \
            json.loads(JResNet50(**cfg).conf().to_json())


def test_params_and_state_names_match_jax(jax_model):
    jm, p, s, _ = jax_model
    tm = ResNet50(**CFG).init(device="cpu")
    shapes = lambda tree: {(ln, k): tuple(np.shape(v))
                           for ln, lp in tree.items() for k, v in lp.items()}
    assert shapes(tm.params) == shapes(p)
    assert shapes(tm.model_state) == shapes(s)


def test_params_from_jax_rejects_name_mismatches(jax_model):
    _, p, s, _ = jax_model
    tm = ResNet50(**CFG).init(device="cpu")
    bad = {k: dict(v) for k, v in p.items()}
    bad["s0b0"]["W9"] = bad["s0b0"].pop("W1")
    with pytest.raises(KeyError):
        params_from_jax(bad, s, "cpu", model=tm)
    bad = {k: dict(v) for k, v in p.items()}
    bad["extra"] = {}
    with pytest.raises(KeyError):
        params_from_jax(bad, s, "cpu", model=tm)
    bad = {k: dict(v) for k, v in p.items()}
    bad["s0b0"]["W3"] = bad["s0b0"]["W3"].T
    with pytest.raises(ValueError):
        params_from_jax(bad, s, "cpu", model=tm)


def test_jax_checkpoint_restores_in_the_port(jax_model, jax_f32_acts,
                                            tmp_path):
    jm, _, _, x = jax_model
    path = str(tmp_path / "jax.zip")
    jax_save(jm, path)
    tm = restore_model(path, device="cpu")
    want = jax_f32_acts
    got = _torch_acts(tm, x)
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5, rtol=0)


def test_port_checkpoint_restores_in_jax(jax_model, tmp_path):
    jm, p, s, x = jax_model
    tm = ResNet50(**CFG).init(device="cpu")
    params_from_jax(p, s, "cpu", model=tm)
    path = str(tmp_path / "port.zip")
    save_model(tm, path)
    back = jax_restore(path)
    want = _torch_acts(tm, x)
    got = _jax_acts(back, x)
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5, rtol=0)
    # and round-trips through the port unchanged
    again = restore_model(path, device="cpu")
    for ln, lp in tm.params.items():
        for k, v in lp.items():
            assert torch.equal(again.params[ln][k], v)


def test_fold_stem_weights_matches_jax():
    from deeplearning4j_tpu.zoo.models import \
        fold_stem_weights as jax_fold
    w7 = np.random.default_rng(0).normal(size=(7, 7, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(fold_stem_weights(w7), jax_fold(w7))
