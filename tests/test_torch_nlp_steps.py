"""The port's embedding device steps (``nlp/skipgram.py``, GloVe's step)
against the JAX package's on the same numpy inputs, one call each.

Bound: each table within 1e-6 of its largest entry (float32 sums taken
in another order; the clipped scatter's segment sums are running-sum
differences in both packages). The token step's update is fed the JAX
package's own draws; the port's draws (a ``torch.Generator``) are
checked by their ranges and frequencies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import skipgram as jsk
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import skipgram as tsk

TOL = 1e-6
V, D, B, K = 50, 16, 64, 5


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _tables(seed=0, v1=V):
    rng = np.random.default_rng(seed)
    syn0 = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    syn1 = (rng.normal(size=(v1, D)) * 0.3).astype(np.float32)
    return syn0, syn1


def _both(f_jax, f_port, syn0, syn1, *args):
    """Run a table step in each package from copies of the same tables;
    return ((jax syn0, syn1), (port syn0, syn1))."""
    j = f_jax(jnp.array(syn0), jnp.array(syn1),
              *[jnp.asarray(a) for a in args])
    t0, t1 = torch.tensor(syn0), torch.tensor(syn1)
    f_port(t0, t1, *[torch.from_numpy(np.array(a)) for a in args])
    return j, (t0, t1)


def _pairs(rng, b=B, k=K, v1=V):
    centers = rng.integers(0, V, b).astype(np.int32)
    targets = rng.integers(0, v1, (b, k)).astype(np.int32)
    labels = np.zeros((b, k), np.float32)
    labels[:, 0] = 1.0
    mask = np.ones((b, k), np.float32)
    mask[b - 7:] = 0.0
    return centers, targets, labels, mask


def _hs(rng, v1):
    pts = rng.integers(0, v1, (V, K)).astype(np.int32)
    labs = rng.integers(0, 2, (V, K)).astype(np.float32)
    hmask = (np.arange(K)[None, :] < rng.integers(1, K + 1, V)[:, None]
             ).astype(np.float32)
    return pts, labs, hmask


@pytest.mark.parametrize("lr", [0.025, 2.0])
def test_skipgram_step(lr):
    rng = np.random.default_rng(1)
    syn0, syn1 = _tables()
    c, t, l, m = _pairs(rng)
    (j0, j1), (p0, p1) = _both(jsk.skipgram_step, tsk.skipgram_step,
                               syn0, syn1, c, t, l, m, np.float32(lr))
    _close(p0, j0)
    _close(p1, j1)


def test_skipgram_hs_step():
    rng = np.random.default_rng(2)
    syn0, syn1 = _tables(v1=V - 1)
    pts, labs, hmask = _hs(rng, V - 1)
    c = rng.integers(0, V, B).astype(np.int32)
    x = rng.integers(0, V, B).astype(np.int32)
    rv = (np.arange(B) < B - 5).astype(np.float32)
    (j0, j1), (p0, p1) = _both(jsk.skipgram_hs_step, tsk.skipgram_hs_step,
                               syn0, syn1, c, x, pts, labs, hmask, rv,
                               np.float32(0.05))
    _close(p0, j0)
    _close(p1, j1)


def _context(rng, b=B, w=6):
    ctx = rng.integers(0, V, (b, w)).astype(np.int32)
    cm = (rng.random((b, w)) < 0.7).astype(np.float32)
    cm[3] = 0.0                                  # a row with no context
    return ctx, cm


def test_cbow_step():
    rng = np.random.default_rng(3)
    syn0, syn1 = _tables()
    ctx, cm = _context(rng)
    _c, t, l, m = _pairs(rng)
    (j0, j1), (p0, p1) = _both(jsk.cbow_step, tsk.cbow_step, syn0, syn1,
                               ctx, cm, t, l, m, np.float32(0.05))
    _close(p0, j0)
    _close(p1, j1)


def test_cbow_hs_step():
    rng = np.random.default_rng(4)
    syn0, syn1 = _tables(v1=V - 1)
    pts, labs, hmask = _hs(rng, V - 1)
    ctx, cm = _context(rng)
    cen = rng.integers(0, V, B).astype(np.int32)
    rv = (np.arange(B) < B - 9).astype(np.float32)
    (j0, j1), (p0, p1) = _both(jsk.cbow_hs_step, tsk.cbow_hs_step, syn0,
                               syn1, ctx, cm, cen, pts, labs, hmask, rv,
                               np.float32(0.05))
    _close(p0, j0)
    _close(p1, j1)


# ---- the scanned steps: three chunks, the last two partly or wholly inert

NV = np.array([B, 40, 0], np.int32)
LRS = np.array([0.05, 0.03, 0.01], np.float32)


def test_skipgram_scan_step():
    rng = np.random.default_rng(5)
    syn0, syn1 = _tables()
    cen = rng.integers(0, V, (3, B)).astype(np.int32)
    tgt = rng.integers(0, V, (3, B, K)).astype(np.int32)
    (j0, j1), (p0, p1) = _both(jsk.skipgram_scan_step,
                               tsk.skipgram_scan_step, syn0, syn1, cen, tgt,
                               NV, LRS)
    _close(p0, j0)
    _close(p1, j1)


def test_skipgram_hs_scan_step():
    rng = np.random.default_rng(6)
    syn0, syn1 = _tables(v1=V - 1)
    pts, labs, hmask = _hs(rng, V - 1)
    cen = rng.integers(0, V, (3, B)).astype(np.int32)
    ctx = rng.integers(0, V, (3, B)).astype(np.int32)
    (j0, j1), (p0, p1) = _both(jsk.skipgram_hs_scan_step,
                               tsk.skipgram_hs_scan_step, syn0, syn1, cen,
                               ctx, pts, labs, hmask, NV, LRS)
    _close(p0, j0)
    _close(p1, j1)


def test_cbow_scan_step():
    rng = np.random.default_rng(7)
    syn0, syn1 = _tables()
    ctx = rng.integers(0, V, (3, B, 6)).astype(np.int32)
    cm = (rng.random((3, B, 6)) < 0.7).astype(np.float32)
    tgt = rng.integers(0, V, (3, B, K)).astype(np.int32)
    (j0, j1), (p0, p1) = _both(jsk.cbow_scan_step, tsk.cbow_scan_step, syn0,
                               syn1, ctx, cm, tgt, NV, LRS)
    _close(p0, j0)
    _close(p1, j1)


def test_cbow_hs_scan_step():
    rng = np.random.default_rng(8)
    syn0, syn1 = _tables(v1=V - 1)
    pts, labs, hmask = _hs(rng, V - 1)
    ctx = rng.integers(0, V, (3, B, 6)).astype(np.int32)
    cm = (rng.random((3, B, 6)) < 0.7).astype(np.float32)
    cen = rng.integers(0, V, (3, B)).astype(np.int32)
    (j0, j1), (p0, p1) = _both(jsk.cbow_hs_scan_step, tsk.cbow_hs_scan_step,
                               syn0, syn1, ctx, cm, cen, pts, labs, hmask,
                               NV, LRS)
    _close(p0, j0)
    _close(p1, j1)


def test_shared_negative_scan_step():
    rng = np.random.default_rng(9)
    syn0, syn1 = _tables()
    cen = rng.integers(0, V, (3, B)).astype(np.int32)
    ctx = rng.integers(0, V, (3, B)).astype(np.int32)
    negs = rng.integers(0, V, (3, 4, K)).astype(np.int32)
    (j0, j1), (p0, p1) = _both(jsk.skipgram_scan_step_shared,
                               tsk.skipgram_scan_step_shared, syn0, syn1,
                               cen, ctx, negs, NV, LRS)
    _close(p0, j0)
    _close(p1, j1)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clipped_scatter_with_duplicate_rows(max_norm):
    """Rows hit many times, each total above (1e-3) or below (1e3) the
    clip, plus rows hit once: the same table as the JAX package's."""
    rng = np.random.default_rng(10)
    table = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    idx = np.concatenate([np.full(20, 7), np.full(9, 3),
                          rng.integers(0, V, 35)]).astype(np.int32)
    idx = idx[rng.permutation(len(idx))]
    upd = (rng.normal(size=(len(idx), D)) * 0.05).astype(np.float32)
    ref = jsk._clipped_scatter(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(upd), jnp.float32(max_norm))
    got = torch.tensor(table)
    tsk._clipped_scatter(got, torch.from_numpy(idx), torch.from_numpy(upd),
                         max_norm)
    _close(got, ref)
    # untouched rows are bitwise unchanged
    untouched = np.setdiff1d(np.arange(V), idx)
    assert np.array_equal(got.numpy()[untouched], table[untouched])
    if max_norm < 1:
        row7 = got.numpy()[7] - table[7]
        assert abs(np.linalg.norm(row7) - max_norm) <= 1e-6


def test_clipped_scatter_repeats_bitwise():
    rng = np.random.default_rng(11)
    table = torch.tensor((rng.normal(size=(V, D))).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, 200).astype(np.int32))
    upd = torch.from_numpy(rng.normal(size=(200, D)).astype(np.float32))
    a, b = table.clone(), table.clone()
    tsk._clipped_scatter(a, idx, upd, 0.5)
    tsk._clipped_scatter(b, idx, upd, 0.5)
    assert torch.equal(a, b)


def test_infer_step():
    rng = np.random.default_rng(12)
    _s0, syn1 = _tables()
    vec = (rng.normal(size=D) * 0.1).astype(np.float32)
    tg = rng.integers(0, V, (8, K)).astype(np.int32)
    lb = np.zeros((8, K), np.float32)
    lb[:, 0] = 1.0
    m = np.ones((8, K), np.float32)
    m[5:] = 0.0
    for lr in (0.025, 1.0):            # below and above the clip
        ref = jsk.infer_step(jnp.array(vec), jnp.asarray(syn1),
                             jnp.asarray(tg), jnp.asarray(lb),
                             jnp.asarray(m), jnp.float32(lr))
        got = torch.tensor(vec)
        tsk.infer_step(got, torch.tensor(syn1), torch.from_numpy(tg),
                       torch.from_numpy(lb), torch.from_numpy(m), lr)
        _close(got, ref)


def test_glove_step():
    """Rows and columns repeat within the batch, so the AdaGrad
    accumulators sum duplicates before the updates read them."""
    rng = np.random.default_rng(13)
    n = 20
    w, wc = [(rng.random((n, D)) - 0.5).astype(np.float32) / D
             for _ in range(2)]
    b, bc = [(rng.normal(size=n) * 0.1).astype(np.float32)
             for _ in range(2)]
    gw, gwc = [np.full((n, D), 1e-8, np.float32) for _ in range(2)]
    gb, gbc = [np.full(n, 1e-8, np.float32) for _ in range(2)]
    rows = rng.integers(0, n, 64).astype(np.int32)
    cols = rng.integers(0, n, 64).astype(np.int32)
    logx = np.log(rng.random(64) * 5 + 1).astype(np.float32)
    weight = np.minimum((rng.random(64) * 150 / 100) ** 0.75, 1.0
                        ).astype(np.float32)
    weight[-3:] = 0.0                                   # padded rows
    state = [w, wc, b, bc, gw, gwc, gb, gbc]
    ref = jglove._glove_step(*[jnp.array(a) for a in state],
                             jnp.asarray(rows), jnp.asarray(cols),
                             jnp.asarray(logx), jnp.asarray(weight),
                             jnp.float32(0.05))
    got = [torch.tensor(a) for a in state]
    loss = tglove._glove_step(*got, torch.from_numpy(rows),
                              torch.from_numpy(cols),
                              torch.from_numpy(logx),
                              torch.from_numpy(weight), 0.05)
    for g, r in zip(got, ref[:8]):
        _close(g, r)
    assert abs(float(loss) - float(ref[8])) <= TOL * abs(float(ref[8]))


# ---- pair generation on the device --------------------------------------

def _sentences(rng, s=6, l=12):
    tokens = rng.integers(0, V, (s, l)).astype(np.int32)
    lengths = rng.integers(0, l + 1, s).astype(np.int32)
    lengths[0] = l
    return tokens, lengths


def test_token_update_on_jax_draws():
    """The JAX package's own draws, re-made from its key, fed to the
    port's update: the tables agree with ``skipgram_token_step``'s."""
    rng = np.random.default_rng(14)
    syn0, syn1 = _tables()
    tokens, lengths = _sentences(rng)
    table = rng.integers(0, V, 1000).astype(np.int32)
    window, n_neg = 3, 4
    key = jax.random.PRNGKey(7)
    j0, j1 = jsk.skipgram_token_step(
        jnp.array(syn0), jnp.array(syn1), jnp.asarray(tokens),
        jnp.asarray(lengths), jnp.asarray(table), key, jnp.float32(0.05),
        window=window, n_neg=n_neg)
    s, l = tokens.shape
    kb, kn = jax.random.split(key)
    b = np.asarray(jax.random.randint(kb, (s, l), 1, window + 1))
    negs = table[np.asarray(jax.random.randint(
        kn, (s * l * 2 * window, n_neg), 0, table.shape[0]))]
    p0, p1 = torch.tensor(syn0), torch.tensor(syn1)
    tsk.skipgram_token_update(p0, p1, torch.from_numpy(tokens),
                              torch.from_numpy(lengths),
                              torch.from_numpy(b), torch.from_numpy(negs),
                              0.05, window=window, n_neg=n_neg)
    _close(p0, j0)
    _close(p1, j1)


def test_token_draws_ranges_and_frequencies():
    """b is uniform on [1, window]; the negatives follow the table's
    frequencies; one seed repeats."""
    table = torch.from_numpy(
        np.repeat(np.arange(4), [10, 20, 30, 40]).astype(np.int32))
    window = 5
    g = torch.Generator().manual_seed(3)
    b, negs = tsk.token_draws((40, 50), table, window=window, n_neg=5,
                              generator=g)
    assert b.shape == (40, 50) and negs.shape == (40 * 50 * 2 * window, 5)
    assert int(b.min()) == 1 and int(b.max()) == window
    counts = np.bincount(b.numpy().ravel(), minlength=window + 1)[1:]
    assert np.all(np.abs(counts / counts.sum() - 1 / window) < 0.02)
    freq = np.bincount(negs.numpy().ravel(), minlength=4) / negs.numel()
    assert np.allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.01)
    g2 = torch.Generator().manual_seed(3)
    b2, negs2 = tsk.token_draws((40, 50), table, window=window, n_neg=5,
                                generator=g2)
    assert torch.equal(b, b2) and torch.equal(negs, negs2)
