"""The imported BERT encoder in the port, on the CPU: the small BERT
geometry of tests/test_keras_import.py against Keras and against the JAX
package's import of the same file; the graft-and-freeze fine-tune of
tests/test_bert_finetune.py; the bf16 ``shadow_cast`` K-step call
bitwise equal to the same call without it; N Adam steps of the grafted
fine-tune against the JAX package's. Bounds: the output within rtol 1e-4,
atol 1e-5 of Keras (that file's bound) and 1e-5 of JAX's largest
magnitude; after the steps each parameter within 1e-4 of its array's
largest magnitude and the losses within 1e-5. The packed ``bqkv``'s key
bias is left out of the step comparison: its gradient is exactly zero
(softmax is invariant to a shift of every key's score), and Adam turns
that zero's rounding noise into a full learning-rate step in either
package.
"""

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet  # noqa
from deeplearning4j_tpu_torch.modelimport.bert import (  # noqa: E402
    build_keras_bert, example_inputs, import_bert_base)
from deeplearning4j_tpu_torch.modelimport.keras import (  # noqa: E402
    import_keras_model_and_weights)
from deeplearning4j_tpu_torch.models.base import cast_params  # noqa: E402
from deeplearning4j_tpu_torch.models.serialization import (  # noqa: E402
    flatten_paths, params_from_jax)
from deeplearning4j_tpu_torch.nn.layers.output import (  # noqa: E402
    GlobalPoolingLayer, OutputLayer, PoolingType)
from deeplearning4j_tpu_torch.nn.transferlearning import (  # noqa: E402
    FineTuneConfiguration, TransferLearning)
from deeplearning4j_tpu_torch.optimize.updaters import Adam  # noqa: E402

SMALL = dict(vocab=50, width=32, n_layers=2, n_heads=4, ffn=64, max_len=16)
SEQ = 12
PARAM_REL, LOSS_REL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def small_h5(tmp_path_factory):
    keras.utils.set_random_seed(0)
    km = build_keras_bert(seq_len=SEQ, **SMALL)
    p = str(tmp_path_factory.mktemp("bert") / "bert_small.h5")
    km.save(p)
    return p, km


def _graft(model, pkg_tl, pkg_out, lr=1e-3, frozen=False, dtype=None):
    ftc = pkg_tl.FineTuneConfiguration.Builder().updater(lr)
    if dtype:
        ftc = ftc.compute_dtype(dtype)
    enc = model.conf.network_outputs[0]
    gb = pkg_tl.TransferLearning.GraphBuilder(model).fine_tune_configuration(
        ftc.build())
    if frozen:
        gb = gb.set_feature_extractor(enc)
    return (gb.add_layer("pool", pkg_out.GlobalPoolingLayer(
        pooling_type=pkg_out.PoolingType.AVG), enc)
        .add_layer("cls", pkg_out.OutputLayer(n_out=2), "pool")
        .set_outputs("cls").build())


def _port_graft(model, lr=1e-3, **kw):
    import deeplearning4j_tpu_torch.nn.layers.output as out
    import deeplearning4j_tpu_torch.nn.transferlearning as tl
    return _graft(model, tl, out, Adam(lr), **kw)


def test_small_bert_against_keras_and_jax(small_h5):
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_model_and_weights as jax_import
    path, km = small_h5
    model = import_keras_model_and_weights(path, device="cpu")
    ids, pos = example_inputs(2, SEQ, SMALL["vocab"])
    ours = model.output(ids, pos).numpy()
    np.testing.assert_allclose(ours, np.asarray(km.predict([ids, pos],
                                                           verbose=0)),
                               rtol=1e-4, atol=1e-5)
    ref = np.asarray(jax_import(path).output(ids, pos))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    # integer ids give the same answer (an id is cast once, by the gather)
    same = model.output(torch.from_numpy(ids).long(),
                        torch.from_numpy(pos).long()).numpy()
    np.testing.assert_array_equal(same, ours)


def test_import_bert_base_builds_and_imports_small():
    keras.utils.set_random_seed(0)
    model, km = import_bert_base(seq_len=SEQ, device="cpu", **SMALL)
    ids, pos = example_inputs(2, SEQ, SMALL["vocab"])
    np.testing.assert_allclose(model.output(ids, pos).numpy(),
                               np.asarray(km.predict([ids, pos], verbose=0)),
                               rtol=1e-4, atol=1e-5)
    assert model.num_params() == km.count_params()


def test_imported_bert_freeze_and_finetune(small_h5):
    """tests/test_bert_finetune.py's flow in the port: the encoder frozen
    by set_feature_extractor, AVG pooling and a 2-class head grafted,
    Adam(1e-2); the loss falls, the frozen leaves stay bitwise, the head
    moves."""
    model = import_keras_model_and_weights(small_h5[0], device="cpu")
    ft = _port_graft(model, lr=1e-2, frozen=True)
    frozen = [n for n in ft.layer_names if n not in ("pool", "cls")]
    before = {n: {k: v.clone() for k, v in flatten_paths(ft.params[n])
                  .items()} for n in frozen if ft.params.get(n)}
    head = ft.params["cls"]["W"].clone()
    ids, pos = example_inputs(64, SEQ, SMALL["vocab"], seed=1)
    y = np.eye(2, dtype=np.float32)[(ids.mean(1) < SMALL["vocab"] / 2)
                                    .astype(int)]
    ds = MultiDataSet((ids, pos), (y,))
    losses = []
    for _ in range(100):
        ft.fit(ds)
        losses.append(ft.score())
    assert losses[-1] < losses[0] * 0.9, losses
    for n, tree in before.items():
        now = flatten_paths(ft.params[n])
        for k, v in tree.items():
            assert torch.equal(v, now[k]), f"{n}/{k} moved"
    assert not torch.equal(head, ft.params["cls"]["W"])


def test_shadow_cast_steps_are_bitwise_the_plain_steps(small_h5):
    """make_scan_train_step(..., shadow_cast=...) on the bf16 graft: K
    steps give bitwise the losses and parameters of the same K steps
    without the shadow."""
    model = import_keras_model_and_weights(small_h5[0], device="cpu")
    ft = _port_graft(model, dtype="bfloat16")
    twin = ft.clone()
    k, n = 3, 8
    ids, pos = example_inputs(n, SEQ, SMALL["vocab"], seed=2)
    y = np.eye(2, dtype=np.float32)[np.arange(n) % 2]
    st = lambda a: torch.from_numpy(a).unsqueeze(0).expand(k, *a.shape)
    feats, labels = (st(ids.astype(np.int64)), st(pos.astype(np.int64))), \
        (st(y),)
    ts_a, la = ft._build_scan_train_step(
        shadow_cast=lambda p: cast_params(p, "bfloat16"))(
        ft.train_state, feats, labels)
    ts_b, lb = twin._build_scan_train_step()(twin.train_state, feats,
                                             labels)
    assert torch.equal(la, lb)
    assert ts_a.iteration == ts_b.iteration == k
    fa, fb = flatten_paths(ts_a.params), flatten_paths(ts_b.params)
    assert fa.keys() == fb.keys()
    for key in fa:
        assert fa[key].dtype == torch.float32
        assert torch.equal(fa[key], fb[key]), key
    assert not torch.equal(ts_a.params["cls"]["W"], ft.params["cls"]["W"])


def _key_bias_mask(bqkv, heads):
    """True except at the packed bqkv's key-bias entries ((head, which,
    dh) columns, which = 1)."""
    m = np.ones(bqkv.shape, bool).reshape(heads, 3, -1)
    m[:, 1] = False
    return m.reshape(-1)


def test_adam_steps_against_jax(small_h5):
    import jax

    import deeplearning4j_tpu.datasets.dataset as jds
    import deeplearning4j_tpu.nn.layers.output as jout
    import deeplearning4j_tpu.nn.transferlearning as jtl
    from deeplearning4j_tpu.modelimport.keras import \
        import_keras_model_and_weights as jax_import
    from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
    path = small_h5[0]
    jft = _graft(jax_import(path), jtl, jout, JAdam(1e-3))
    ft = _port_graft(import_keras_model_and_weights(path, device="cpu"))
    p_np = jax.tree_util.tree_map(np.asarray, jft.train_state.params)
    s_np = jax.tree_util.tree_map(np.asarray, jft.train_state.model_state)
    ft.set_params(*params_from_jax(p_np, s_np, model=ft))
    ids, pos = example_inputs(8, SEQ, SMALL["vocab"], seed=3)
    y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    jl, pl = [], []
    for _ in range(3):
        jft.fit(jds.MultiDataSet((ids, pos), (y,)))
        jl.append(float(jft._last_loss))
        ft.fit(MultiDataSet((ids, pos), (y,)))
        pl.append(ft.score())
    np.testing.assert_allclose(pl, jl, rtol=LOSS_REL)
    jp = flatten_paths(jax.tree_util.tree_map(np.asarray,
                                              jft.train_state.params))
    for key, got in flatten_paths(ft.params).items():
        want = np.asarray(jp[key])
        got = got.numpy()
        if key.endswith("bqkv"):
            keep = _key_bias_mask(want, SMALL["n_heads"])
            got, want = got[keep], want[keep]
        assert np.abs(got - want).max() <= PARAM_REL * np.abs(want).max(), \
            key


@pytest.mark.slow
def test_bert_base_full_import_fidelity():
    """12 layers, width 768, 12 heads, FFN 3072, vocab 30522: the port's
    import within 1e-5 of Keras on the final hidden states at seq 64."""
    from deeplearning4j_tpu_torch.modelimport.bert import BERT_BASE
    model, km = import_bert_base(seq_len=64, device="cpu")
    assert model.num_params() > 100_000_000
    ids, pos = example_inputs(2, 64, BERT_BASE["vocab"])
    ours = model.output(ids, pos).numpy()
    theirs = np.asarray(km.predict([ids, pos], verbose=0))
    assert np.abs(ours - theirs).max() <= 1e-5
