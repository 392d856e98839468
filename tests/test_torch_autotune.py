"""The port's tuned configs (optimize/autotune.py) and their consumers on
the CPU, against the JAX package's.

- **The registry and ``choose``.** The same tunables with the JAX
  package's committed defaults; the same decision records.
- **Persistence.** A config the port saves loads back whole; the
  manifest is written last (a store with a blob and no manifest is
  ``absent``); a blob failing its checksum is quarantined; an unreadable
  manifest too; each fingerprint field that differs is named; a config
  the JAX package wrote in the same store layout loads as a
  ``format_version`` mismatch and the committed defaults apply; the
  JAX package reads the port's as a mismatch too.
- **Consumers.** ``fit`` takes ``fit.k_steps`` and ``feeder.depth`` from
  the process config (an explicit argument wins, a tuned k the feeder
  cannot serve degrades to 1), a directly built ``DeviceFeeder`` its
  depth, and the serving, generation and retrieval engines and ``serve``
  their sizes; ``--no-tuned`` skips the store's config.

Tests that install a process config remove it when they end.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
from deeplearning4j_tpu_torch.optimize import autotune as tat
from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore

REPO = Path(__file__).resolve().parents[1]
MLP = str(REPO / "tests" / "resources" / "regression" / "mlp_v1.zip")


@pytest.fixture(autouse=True)
def _no_process_config():
    tat.set_process_tuned(None)
    yield
    tat.set_process_tuned(None)


def _jat():
    from deeplearning4j_tpu.optimize import autotune as jat
    return jat


def _saved(tmp_path, values, **fp):
    cfg = tat.TunedConfig(values, fingerprint={
        **tat.fingerprint(device="cpu"), **fp})
    store = ArtifactStore(str(tmp_path / "store"))
    tat.save_tuned(store, cfg)
    return store, cfg


# ---- registry and decisions --------------------------------------------------

def test_registry_matches_jax():
    jat = _jat()
    assert list(tat.REGISTRY) == list(jat.REGISTRY)
    for name, t in jat.REGISTRY.items():
        assert tat.REGISTRY[name] == tat.Tunable(**t.__dict__)
    assert (tat.TUNED_KEY, tat.TUNED_MANIFEST, tat.TUNED_BLOB) == (
        jat.TUNED_KEY, jat.TUNED_MANIFEST, jat.TUNED_BLOB)
    assert tat.TUNED_REGISTRY_VERSION == jat.TUNED_REGISTRY_VERSION


CHOICES = [
    ("serving.batch_limit", [(8, 10.0), (16, 30.0), (32, 30.0)], {}),
    ("generation.prefill_chunk", [(0, 5.0), (16, 3.0), (64, 3.0)], {}),
    ("retrieval.nprobe", [(4, 900.0), (8, 800.0), (64, 100.0)],
     {"excluded": {4: "recall 0.91 < 0.95"}}),
    ("retrieval.nprobe", [(4, 900.0)], {"excluded": {4: "recall"}}),
    ("retrieval.k_ladder", [((1, 10, 100), 5.0), ((10, 100), 6.0)],
     {"note": "measured"}),
]


@pytest.mark.parametrize("name,measured,kw", CHOICES)
def test_choose_and_record_match_jax(name, measured, kw):
    jat = _jat()
    got = tat.choose(tat.REGISTRY[name], measured, **kw)
    want = jat.choose(jat.REGISTRY[name], measured, **kw)
    assert got == want
    cfg, jcfg = tat.TunedConfig(), jat.TunedConfig()
    cfg.record(got)
    jcfg.record(want)
    assert cfg.values == jcfg.values
    assert cfg.summary_rows() == jcfg.summary_rows()
    assert cfg.effective(name) == jcfg.effective(name)
    with pytest.raises(KeyError):
        cfg.record(dict(got, tunable="nope"))


def test_precedence_explicit_engine_process_default():
    cfg = tat.TunedConfig({"serving.batch_limit": 8})
    name = "serving.batch_limit"
    assert tat.resolve_tuned(None, None, name) == 32
    tat.set_process_tuned(tat.TunedConfig({name: 16}))
    assert tat.resolve_tuned(None, None, name) == 16
    assert tat.resolve_tuned(None, cfg, name) == 8
    assert tat.resolve_tuned(4, cfg, name) == 4
    assert tat.tuned_value("fit.k_steps") is None
    assert tat.TunedConfig.defaults().get(name, 3) == 3


# ---- persistence -------------------------------------------------------------

def test_save_load_round_trip(tmp_path):
    store, cfg = _saved(tmp_path, {"serving.batch_limit": 16,
                                   "retrieval.k_ladder": [10, 100],
                                   "not.a.tunable": 1})
    reg = MetricsRegistry()
    got = tat.load_tuned(store, expect=tat.fingerprint(device="cpu"),
                         registry=reg)
    assert got.load_outcome == "loaded"
    assert got.values == {"serving.batch_limit": 16,
                          "retrieval.k_ladder": [10, 100]}
    assert got.fingerprint == cfg.fingerprint
    assert reg.get_metric("dl4j_autotune_artifact_loads_total").get(
        outcome="loaded") == 1.0
    # expect=None pins nothing
    assert tat.load_tuned(store, expect=None).load_outcome == "loaded"


def test_manifest_is_written_last(tmp_path):
    store = ArtifactStore(str(tmp_path))
    d = Path(store.cache_dir(tat.TUNED_KEY))
    (d / tat.TUNED_BLOB).write_text('{"values": {"fit.k_steps": 4}}')
    got = tat.load_tuned(store, expect=None)
    assert (got.load_outcome, got.values) == ("absent", {})
    tat.save_tuned(store, tat.TunedConfig(
        {"fit.k_steps": 2}, fingerprint=tat.fingerprint(device="cpu")))
    assert sorted(p.name for p in d.iterdir()) == [tat.TUNED_MANIFEST,
                                                   tat.TUNED_BLOB]
    with pytest.raises(ValueError, match="fingerprint"):
        tat.save_tuned(store, tat.TunedConfig({"fit.k_steps": 2}))


def test_corrupt_blob_and_manifest_are_quarantined(tmp_path):
    class Recorder:
        notes = []

        def note(self, key, value):
            self.notes.append((key, value))
    store, _ = _saved(tmp_path, {"fit.k_steps": 4})
    d = Path(store.cache_dir(tat.TUNED_KEY))
    raw = bytearray((d / tat.TUNED_BLOB).read_bytes())
    raw[5] ^= 0xFF
    (d / tat.TUNED_BLOB).write_bytes(bytes(raw))
    rec = Recorder()
    got = tat.load_tuned(store, expect=None, recorder=rec)
    assert (got.load_outcome, got.values) == ("corrupt", {})
    assert "checksum" in got.load_reason
    assert (d / (tat.TUNED_BLOB + ".quarantine")).exists()
    assert rec.notes[-1][1]["outcome"] == "corrupt"
    (d / tat.TUNED_MANIFEST).write_text("{not json")
    got = tat.load_tuned(store, expect=None)
    assert got.load_outcome == "corrupt"
    assert (d / (tat.TUNED_MANIFEST + ".quarantine")).exists()
    assert tat.load_tuned(store, expect=None).load_outcome == "absent"


FIELDS = [("registry_version", 0), ("torch", "0.0"), ("cuda", "0.0"),
          ("backend", {"platform": "cuda", "device_kind": "NVIDIA H100",
                       "capability": [9, 0]}),
          ("model_version", "v9"), ("weights_sha256", "0" * 64)]


@pytest.mark.parametrize("field,value", FIELDS)
def test_each_mismatched_field_is_named(tmp_path, field, value):
    bound = dict(model_version="v1", weights_sha256="f" * 64)
    store, _ = _saved(tmp_path, {"fit.k_steps": 4},
                      **dict(bound, **{field: value}))
    expect = dict(tat.fingerprint(device="cpu"), **bound)
    got = tat.load_tuned(store, expect=expect)
    assert (got.load_outcome, got.values) == ("mismatch", {})
    first = "backend.platform" if field == "backend" else field
    assert f"'{first}'" in got.load_reason


def test_wildcards_accept_any_model(tmp_path):
    store, _ = _saved(tmp_path, {"fit.k_steps": 4}, model_version="v9",
                      weights_sha256="0" * 64)
    got = tat.load_tuned(store, expect=tat.fingerprint(device="cpu"))
    assert got.load_outcome == "loaded"


def test_the_packages_read_each_others_configs_as_mismatches(tmp_path):
    """A config the JAX package wrote sits in the same layout: the port
    loads it as a named mismatch and applies nothing, and the JAX
    package reads the port's the same way."""
    import jax
    jat = _jat()
    from deeplearning4j_tpu.parallel.aot_cache import \
        ArtifactStore as JStore
    jstore = JStore(str(tmp_path / "jax"))
    jat.save_tuned(jstore, jat.TunedConfig(
        {"serving.batch_limit": 8}, fingerprint=jat.fingerprint()))
    assert jat.load_tuned(jstore, expect=jat.fingerprint()).values == {
        "serving.batch_limit": 8}
    got = tat.load_tuned(ArtifactStore(str(tmp_path / "jax")),
                         expect=tat.fingerprint(device="cpu"))
    assert (got.load_outcome, got.values) == ("mismatch", {})
    assert "'format_version'" in got.load_reason
    assert "torch-1" in got.load_reason
    store, _ = _saved(tmp_path, {"serving.batch_limit": 8})
    back = jat.load_tuned(JStore(str(store.root)), expect=jat.fingerprint())
    assert back.load_outcome == "mismatch" and back.values == {}
    assert jax is not None


def test_fingerprint_names_torch_cuda_and_the_device():
    import torch
    fp = tat.fingerprint(device="cpu")
    assert fp["format_version"] == tat.TUNED_FORMAT_VERSION
    assert (fp["torch"], fp["cuda"]) == (torch.__version__,
                                         torch.version.cuda)
    assert fp["backend"]["platform"] == "cpu"
    assert fp["weights_sha256"] is None
    assert set(fp) == {"format_version", "registry_version",
                       "model_version", "weights_sha256", "torch", "cuda",
                       "backend"}


# ---- consumers ---------------------------------------------------------------

def _mln():
    from test_torch_online import _tiny_model
    return _tiny_model()


def _iterator(n=12, batch=4):
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return ArrayDataSetIterator(DataSet(x, y), batch)


def test_fit_takes_tuned_k_steps_and_depth_and_explicit_wins():
    tat.set_process_tuned(tat.TunedConfig({"fit.k_steps": 3,
                                           "feeder.depth": 4}))
    m = _mln()
    m.fit(_iterator())
    assert (m.last_feeder.k_steps, m.last_feeder.depth) == (3, 4)
    assert m.iteration == 3
    m.fit(_iterator(), k_steps=1, prefetch=1)
    assert (m.last_feeder.k_steps, m.last_feeder.depth) == (1, 1)


def test_a_tuned_k_degrades_where_an_explicit_one_raises():
    from deeplearning4j_tpu_torch.datasets.iterators import \
        AsyncShieldDataSetIterator
    tat.set_process_tuned(tat.TunedConfig({"fit.k_steps": 4}))
    m = _mln()
    m.fit(_iterator(), prefetch=0)
    assert m.last_feeder is None and m.iteration == 3
    m.fit(AsyncShieldDataSetIterator(_iterator()))
    assert m.iteration == 6
    with pytest.raises(ValueError, match="device feeder"):
        m.fit(_iterator(), prefetch=0, k_steps=4)


def test_a_directly_built_feeder_takes_the_tuned_depth():
    from deeplearning4j_tpu_torch.datasets.feeder import (DEFAULT_DEPTH,
                                                          DeviceFeeder)
    assert DeviceFeeder([], device="cpu").depth == DEFAULT_DEPTH
    tat.set_process_tuned(tat.TunedConfig({"feeder.depth": 3}))
    assert DeviceFeeder([], device="cpu").depth == 3
    assert DeviceFeeder([], device="cpu", depth=1).depth == 1


def test_engines_are_sized_by_a_tuned_config():
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    cfg = tat.TunedConfig({"serving.batch_limit": 4})
    with ServingEngine(_mln(), tuned_config=cfg, warmup=False,
                       registry=MetricsRegistry()) as eng:
        assert eng.batch_limit == 4 and eng.tuned_config is cfg
    tat.set_process_tuned(tat.TunedConfig({"serving.batch_limit": 2}))
    with ServingEngine(_mln(), warmup=False,
                       registry=MetricsRegistry()) as eng:
        assert eng.ladder == [1, 2]
    with ServingEngine(_mln(), batch_limit=8, tuned_config=cfg,
                       warmup=False, registry=MetricsRegistry()) as eng:
        assert eng.batch_limit == 8


def test_retrieval_engine_takes_the_tuned_ladder_and_nprobe():
    from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex
    corpus = np.random.default_rng(0).normal(size=(512, 8)) \
        .astype(np.float32)
    cfg = tat.TunedConfig({"retrieval.k_ladder": [5, 20],
                           "retrieval.nprobe": 3})
    idx = ShardedCorpusIndex.build(corpus, shard_rows=256, ivf_clusters=8,
                                   nprobe_hint=2, device="cpu")
    eng = RetrievalEngine(idx, tuned_config=cfg, max_batch=4,
                          registry=MetricsRegistry(), device="cpu")
    assert (eng.k_ladder, eng.nprobe) == ((5, 20), 3)


def _serve(argv):
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    return cmd_serve(["serve", "--model", MLP, "--device", "cpu",
                      "--ui-port", "0", *argv], block=False)


@pytest.mark.parametrize("argv,limit,outcome", [
    ([], 8, "loaded"),
    (["--batch-limit", "4"], 4, "loaded"),
    (["--no-tuned"], 32, None),
    (["--tuned-config", "other"], 32, "absent"),
])
def test_serve_loads_the_store_config(tmp_path, capsys, argv, limit,
                                      outcome):
    store, _ = _saved(tmp_path, {"serving.batch_limit": 8})
    front, server = _serve(["--artifact-store", str(store.root), *argv])
    try:
        assert front.engine.batch_limit == limit
        cfg = tat.process_tuned()
        assert (cfg.load_outcome if cfg else None) == outcome
        out = capsys.readouterr().out
        assert ("tuned config: " in out) == (outcome is not None)
        assert f"batch_limit={limit}" in out
    finally:
        front.shutdown()
        server.stop()


def test_serve_names_the_field_of_a_foreign_config(tmp_path, capsys):
    store, _ = _saved(tmp_path, {"serving.batch_limit": 8},
                      backend={"platform": "tpu", "device_kind": "TPU v5",
                               "capability": None})
    front, server = _serve(["--artifact-store", str(store.root)])
    try:
        assert front.engine.batch_limit == 32
        out = capsys.readouterr().out
        assert "tuned config: mismatch" in out
        assert "backend.platform" in out
    finally:
        front.shutdown()
        server.stop()
    assert json.loads((Path(store.cache_dir(tat.TUNED_KEY))
                       / tat.TUNED_MANIFEST).read_text())["format_version"] \
        == tat.TUNED_FORMAT_VERSION
    assert os.path.isdir(store.root)
