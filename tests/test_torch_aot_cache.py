"""The port's persisted kernel cache (parallel/aot_cache.py,
ops/cuda_build.py's ``install`` and ``record_sources``) and its wiring
into the serving engine, the fleet, the node and ``serve
--aot-cache-dir``, on the CPU.

There is no ``nvcc`` here, so the libraries are stand-ins: bytes written
where ``cuda_build.library_path`` names them under a temporary
``BUILD_DIR``; ``nvcc`` itself is replaced by a function that fails, so
a test that passes ran none. On the CPU the engine's forward reaches no
library (the wrappers run their plain versions): its entries are saved
and matched with no blobs, and the tests that need reached libraries
have the warmup's recording report them.

- A saved entry restores every library byte for byte through
  ``cuda_build.install`` and ``build`` then runs no ``nvcc``.
- The manifest is written last: blobs without a manifest are a cold
  cache.
- A blob failing its checksum is quarantined, its source built live,
  and the next save republishes it.
- Each fingerprint field that differs is named (feature shape, dtype,
  ladder, precision, weights, model version, the kernels digest, the
  torch version, the device); a cache dir in the JAX package's format
  reads as a ``format_version`` mismatch.
- ``weights_digest`` is the JAX package's digest of the same values.
"""

import contextlib
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.parallel import aot_cache as ac
from deeplearning4j_tpu_torch.parallel.aot_cache import (AOTExecutableCache,
                                                         ArtifactStore)
from deeplearning4j_tpu_torch.parallel.serving import ServingEngine

N_IN = 5
REPO = Path(__file__).resolve().parents[1]
MLP = str(REPO / "tests" / "resources" / "regression" / "mlp_v1.zip")
LIBS = {"fused_mm": b"\x7fELF mm library " * 64,
        "fused_c3": b"\x7fELF c3 library " * 80}


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """An empty BUILD_DIR and an nvcc that must not run."""
    d = tmp_path / "kernels"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", d)

    def no_nvcc():
        raise AssertionError("nvcc ran")
    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build, "build_log", {})
    return d


def _built(build_dir, sources=LIBS):
    build_dir.mkdir(parents=True, exist_ok=True)
    for s in sources:
        cuda_build.library_path(s).write_bytes(LIBS[s])


def _fp(**serving):
    p = {"layer": {"W": torch.arange(6.0).reshape(2, 3)}}
    s = {"bn": {"mean": torch.zeros(3)}}
    kw = dict(feature_shape=(N_IN,), dtype=np.float32, ladder=[1, 2, 4],
              precision="f32", device="cpu")
    kw.update(serving)
    return ac.fingerprint(p, s, **kw)


def _tiny(seed=1):
    from test_torch_online import _tiny_model
    return _tiny_model(seed)


@contextlib.contextmanager
def _reaching(sources):
    """The warmup's recording reports ``sources`` (what the card's
    forward would reach)."""
    real = cuda_build.record_sources

    @contextlib.contextmanager
    def fake():
        with real() as seen:
            yield seen
            seen.update(sources)
    cuda_build.record_sources = fake
    try:
        yield
    finally:
        cuda_build.record_sources = real


def _engine(cache_dir, model=None, **kw):
    kw.setdefault("batch_limit", 4)
    kw.setdefault("feature_shape", (N_IN,))
    return ServingEngine(model if model is not None else _tiny(),
                         aot_cache_dir=str(cache_dir),
                         registry=kw.pop("registry", MetricsRegistry()),
                         **kw)


# ---- the cache itself ----------------------------------------------------------

def test_save_then_restore_every_library_without_nvcc(build_dir, tmp_path):
    _built(build_dir)
    cache = AOTExecutableCache(str(tmp_path / "cache"))
    assert cache.try_load(_fp()) == [] and cache.state == "cold"
    assert cache.save(_fp(), set(LIBS)) == 2
    names = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert names == sorted([ac.MANIFEST] + [
        cuda_build.library_path(s).name for s in LIBS])
    for s in LIBS:
        cuda_build.library_path(s).unlink()
    warm = AOTExecutableCache(str(tmp_path / "cache"))
    assert sorted(warm.try_load(_fp())) == sorted(LIBS)
    assert (warm.state, warm.hits, warm.misses) == ("warm", 2, 0)
    for s, data in LIBS.items():
        assert cuda_build.library_path(s).read_bytes() == data
    assert cuda_build.build(list(LIBS)) == {
        s: cuda_build.library_path(s) for s in LIBS}
    assert cuda_build.build_log == {}
    m = json.loads((tmp_path / "cache" / ac.MANIFEST).read_text())
    assert m["format_version"] == ac.FORMAT_VERSION
    assert sorted(m["entries"]["f32"]["libraries"]) == sorted(LIBS)


def test_install_keeps_an_existing_library(build_dir):
    _built(build_dir, ["fused_mm"])
    out = cuda_build.install("fused_mm", b"other bytes")
    assert out.read_bytes() == LIBS["fused_mm"]
    out = cuda_build.install("fused_c3", LIBS["fused_c3"])
    assert out == cuda_build.library_path("fused_c3")
    assert out.read_bytes() == LIBS["fused_c3"]
    assert not list(build_dir.glob("*.tmp"))


def test_the_manifest_is_written_last(build_dir, tmp_path, monkeypatch):
    _built(build_dir)
    cache = AOTExecutableCache(str(tmp_path / "cache"))
    real = os.replace

    def crash(src, dst):
        if str(dst).endswith(ac.MANIFEST):
            raise OSError("crashed before the manifest")
        return real(src, dst)
    monkeypatch.setattr(ac.os, "replace", crash)
    with pytest.raises(OSError):
        cache.save(_fp(), set(LIBS))
    monkeypatch.setattr(ac.os, "replace", real)
    assert not (tmp_path / "cache" / ac.MANIFEST).exists()
    again = AOTExecutableCache(str(tmp_path / "cache"))
    assert again.try_load(_fp()) == [] and again.state == "cold"


def test_a_corrupt_blob_is_quarantined_and_republished(build_dir, tmp_path):
    _built(build_dir)
    d = tmp_path / "cache"
    AOTExecutableCache(str(d)).save(_fp(), set(LIBS))
    blob = d / cuda_build.library_path("fused_c3").name
    raw = bytearray(blob.read_bytes())
    raw[7] ^= 0xFF
    blob.write_bytes(bytes(raw))
    cuda_build.library_path("fused_c3").unlink()
    reg = MetricsRegistry()
    cache = AOTExecutableCache(str(d), registry=reg)
    assert cache.try_load(_fp()) == ["fused_mm"]
    assert (cache.state, cache.hits, cache.misses, cache.quarantined) == (
        "mismatch", 1, 1, 1)
    assert "quarantined" in cache.reason and "fused_c3" in cache.reason
    assert (d / (blob.name + ".quarantine")).exists() and not blob.exists()
    assert not cuda_build.library_path("fused_c3").exists()
    assert reg.get_metric("dl4j_aot_quarantined_total").get(
        library="fused_c3", reason="checksum") == 1.0
    _built(build_dir, ["fused_c3"])       # the live build
    cache.save(_fp(), set(LIBS))
    assert blob.read_bytes() == LIBS["fused_c3"]
    again = AOTExecutableCache(str(d))
    assert sorted(again.try_load(_fp())) == sorted(LIBS)
    assert again.state == "warm"


def test_entries_per_precision_coexist(build_dir, tmp_path):
    _built(build_dir)
    cache = AOTExecutableCache(str(tmp_path))
    cache.save(_fp(), {"fused_mm"})
    cache.save(_fp(precision="bf16"), set(LIBS))
    other = AOTExecutableCache(str(tmp_path))
    assert other.try_load(_fp(precision="int8")) == []
    assert other.state == "cold" and "'bf16', 'f32'" in other.reason
    assert AOTExecutableCache(str(tmp_path)).try_load(_fp()) == ["fused_mm"]
    store = ArtifactStore(str(tmp_path / "store"))
    AOTExecutableCache(store.cache_dir("k")).save(_fp(), {"fused_mm"})
    assert store.stats()["keys"]["k"] == {"published": True,
                                          "precisions": {"f32": 1}}


FIELDS = {
    "serving.feature_shape": dict(feature_shape=(N_IN + 1,)),
    "serving.dtype": dict(dtype=np.float64),
    "serving.ladder": dict(ladder=[1, 2]),
    "serving.calibration": dict(calibration="abc"),
    "model_version": dict(model_version="v2"),
}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_each_mismatched_serving_field_is_named(tmp_path, field):
    AOTExecutableCache(str(tmp_path)).save(_fp(), set())
    cache = AOTExecutableCache(str(tmp_path))
    assert cache.try_load(_fp(**FIELDS[field])) == []
    assert cache.state == "mismatch"
    assert f"'{field}'" in cache.reason


@pytest.mark.parametrize("field,value", [
    ("kernels", "0" * 12), ("torch", "0.0.0"), ("cuda", "11.0"),
    ("backend", {"platform": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
                 "capability": [9, 0]}),
    ("weights_sha256", "0" * 64)])
def test_each_mismatched_build_field_is_named(tmp_path, field, value):
    fp = _fp()
    AOTExecutableCache(str(tmp_path)).save(dict(fp, **{field: value}),
                                           set())
    cache = AOTExecutableCache(str(tmp_path))
    cache.try_load(fp)
    first = "backend.platform" if field == "backend" else field
    assert cache.state == "mismatch" and f"'{first}'" in cache.reason


def test_a_jax_format_cache_dir_is_a_named_mismatch(tmp_path):
    """A cache dir laid out by the JAX package (its format-2 manifest,
    its fingerprint, StableHLO blobs) is never served from."""
    from deeplearning4j_tpu.parallel import aot_cache as jac
    jparams = {"layer": {"W": np.arange(6.0, dtype=np.float32)
                         .reshape(2, 3)}}
    jfp = jac.fingerprint(jparams, {}, feature_shape=(N_IN,),
                          dtype=np.float32, ladder=[1, 2, 4])
    (tmp_path / "bucket_1.f32.stablehlo").write_bytes(b"hlo")
    (tmp_path / ac.MANIFEST).write_text(json.dumps({
        "format_version": jac.FORMAT_VERSION,
        "entries": {"f32": {"fingerprint": jfp, "buckets": [1],
                            "checksums": {"1": "x"}}}}))
    cache = AOTExecutableCache(str(tmp_path))
    assert cache.try_load(_fp()) == [] and cache.state == "mismatch"
    assert "'format_version'" in cache.reason and "torch-1" in cache.reason
    (tmp_path / ac.MANIFEST).write_text("{broken")
    cache = AOTExecutableCache(str(tmp_path))
    assert cache.try_load(_fp()) == [] and cache.state == "mismatch"
    assert "unreadable" in cache.reason


def test_weights_digest_and_spec_match_jax():
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import aot_cache as jac
    rng = np.random.default_rng(0)
    tree = {"b": {"W": rng.normal(size=(3, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "a": {"gamma": np.ones(2, np.float32)}}
    port = {k: {kk: torch.from_numpy(v) for kk, v in d.items()}
            for k, d in tree.items()}
    assert ac.weights_digest(port) == jac.weights_digest(tree)
    jb = {k: {kk: jnp.asarray(v, jnp.bfloat16) for kk, v in d.items()}
          for k, d in tree.items()}
    tb = {k: {kk: v.to(torch.bfloat16) for kk, v in d.items()}
          for k, d in port.items()}
    assert ac.weights_digest(tb) == jac.weights_digest(jb)
    assert ac.weights_digest(tb) != ac.weights_digest(port)
    spec = ac._tree_spec(port)
    assert spec[0] == ["a/gamma", "b/W", "b/b"]
    assert spec[1] == [[[2], "float32"], [[3, 4], "float32"],
                       [[4], "float32"]]


# ---- the engine, the fleet, the node, the CLI ----------------------------------

def test_record_sources_is_per_thread_and_nests(monkeypatch):
    import threading
    fake = SimpleNamespace(**{sym: (lambda *a: 0) for sym, _ in
                              cuda_build.SIGNATURES.values()})
    for s in cuda_build.SOURCES:
        monkeypatch.setitem(cuda_build._libs, s, fake)
    with cuda_build.record_sources() as outer:
        cuda_build.kernel("fused_mm")
        with cuda_build.record_sources() as inner:
            cuda_build.kernel("fused_c3_bwd_w")
        t = threading.Thread(target=cuda_build.kernel, args=("lstm_fwd",))
        t.start()
        t.join()
    assert inner == {"fused_c3_bwd"}
    assert outer == {"fused_mm", "fused_c3_bwd"}
    cuda_build.kernel("flash_fwd")
    assert outer == {"fused_mm", "fused_c3_bwd"}


def test_engine_fills_a_cold_cache_and_warms_from_it(build_dir, tmp_path):
    _built(build_dir)
    reg = MetricsRegistry()
    with _reaching(set(LIBS)):
        with _engine(tmp_path / "c", registry=reg) as cold:
            st = cold.stats()["aot_cache"]
            assert (st["state"], st["saved"]) == ("cold", 2)
            x = np.random.default_rng(0).normal(size=(3, N_IN)) \
                .astype(np.float32)
            want = cold.output(x)
        for s in LIBS:
            cuda_build.library_path(s).unlink()
        with _engine(tmp_path / "c", registry=reg) as warm:
            st = warm.stats()["aot_cache"]
            assert (st["state"], st["hits"], st["saved"]) == ("warm", 2, 0)
            assert sorted(st["libraries"]) == sorted(LIBS)
            assert np.array_equal(warm.output(x), want)
            warm.assert_warm()
    for s in LIBS:
        assert cuda_build.library_path(s).read_bytes() == LIBS[s]
    c = reg.get_metric("dl4j_serving_aot_cache_total")
    lab = dict(precision="f32")
    assert c.get(session="serve", event="save", **lab) == 2.0
    assert c.get(session="serve", event="hit", **lab) == 2.0
    assert cuda_build.build_log == {}


@pytest.mark.parametrize("change,field", [
    (dict(feature_shape=(N_IN, 1)), "serving.feature_shape"),
    (dict(batch_limit=8), "serving.ladder"),
    (dict(precision="bf16"), "serving.precision"),
    (dict(model_version="v7"), "model_version"),
    (dict(seed=2), "weights_sha256")])
def test_engine_names_the_field_a_cache_diverged_on(tmp_path, change,
                                                    field):
    """The cache's verdict is read at construction, before the warmup
    (left out here: the tiny MLN takes neither a (5, 1) feature nor bf16
    params; the save after a warmup is the test above's)."""
    with _engine(tmp_path) as eng:
        assert eng.stats()["aot_cache"]["state"] == "cold"
    change = dict(change)
    model = _tiny(change.pop("seed", 1))
    with _engine(tmp_path, model=model, warmup=False, **change) as eng:
        st = eng.stats()["aot_cache"]
        if field == "serving.precision":
            # entries are per precision: another one's is never consulted
            assert st["state"] == "cold"
            assert st["reason"] == "no 'bf16' entry (cache holds ['f32'])"
        else:
            assert st["state"] == "mismatch" and f"'{field}'" in st["reason"]


def test_engine_without_a_feature_shape_keeps_no_cache(tmp_path):
    with _engine(tmp_path, feature_shape=None, warmup=False) as eng:
        assert eng.aot_cache is None and "aot_cache" not in eng.stats()


def test_fleet_node_and_cli_reach_the_cache(tmp_path, capsys):
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    d = tmp_path / "cli"
    states = []
    for _ in range(2):
        front, server = cmd_serve(
            ["serve", "--model", MLP, "--device", "cpu", "--ui-port", "0",
             "--warmup-shape", "4", "--aot-cache-dir", str(d)], block=False)
        try:
            import urllib.request
            with urllib.request.urlopen(server.url + "/api/serving/stats",
                                        timeout=30) as r:
                states.append(json.loads(r.read())["aot_cache"]["state"])
        finally:
            front.shutdown()
            server.stop()
    assert states == ["cold", "warm"]
    assert f"aot_cache={d}" in capsys.readouterr().out
