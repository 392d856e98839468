"""The port's span tracer and flight recorder (observe/tracer.py,
observe/flight_recorder.py) against the JAX package's on the CPU.

- The Chrome trace of the same fits (an iterator epoch at K = 1 and
  K = 2 through the feeder, one DataSet step, with telemetry) has the
  same event schema, the same span names and categories, and the same
  number of each span, in both packages; with ``max_events`` reached,
  the same count of dropped events.
- The flight recorder's ``poll`` (a non-finite row) and ``record_crash``
  (an exception, an OOM) write the same files in both packages, with
  the same reasons, at most one dump a reason and at most ``max_dumps``
  dumps; ``DL4J_CRASH_DUMPS=0`` turns the default recorder off in both;
  ``_classify`` gives the same answer on the JAX package's marker
  strings, and the port names ``torch.OutOfMemoryError`` "oom"; an
  exception leaving ``fit`` is dumped and raised again.
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import \
    ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.observe import flight_recorder as JFR
from deeplearning4j_tpu.observe.tracer import SpanTracer as JTracer
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.observe import flight_recorder as TFR
from deeplearning4j_tpu_torch.observe.tracer import NULL_TRACER, SpanTracer
from test_torch_telemetry import batches, collectors, mln_pair


def traced_fits(tracer_kw=None):
    """Both models fitted the same way with a tracer and telemetry; the
    two Chrome traces."""
    tm, jm = mln_pair()
    x, y = batches("mln", 40)
    tt, jt = SpanTracer(**(tracer_kw or {})), JTracer(**(tracer_kw or {}))
    tc, jc = collectors(flush_interval=3, histograms=False)
    for m, t, c in ((tm, tt, tc), (jm, jt, jc)):
        m.set_tracer(t)
        m.set_telemetry(c)
    for k in (1, 2):
        tm.fit(ArrayDataSetIterator(DataSet(x, y), 8), k_steps=k)
        jm.fit(JArrayIt(JDataSet(x, y), 8), k_steps=k)
    tm.fit(DataSet(x[:8], y[:8]))
    jm.fit(JDataSet(x[:8], y[:8]))
    return tt, jt


def _census(trace):
    out = {}
    for ev in trace["traceEvents"]:
        key = (ev["name"], ev["cat"], ev["ph"])
        out[key] = out.get(key, 0) + 1
    return out


def test_chrome_trace_has_the_same_schema_and_spans():
    tt, jt = traced_fits()
    got, want = tt.to_chrome_trace(), jt.to_chrome_trace()
    assert set(got) == set(want)
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    assert set(got["otherData"]) == set(want["otherData"])
    assert _census(got) == _census(want)
    names = {name for name, _, _ in _census(got)}
    assert {"etl", "host_to_device", "feed_stall", "dispatch",
            "telemetry_flush"} <= names
    for ge, je in zip(sorted(got["traceEvents"], key=lambda e: e["name"]),
                      sorted(want["traceEvents"], key=lambda e: e["name"])):
        assert set(ge) == set(je)
        assert set(ge.get("args", {})) == set(je.get("args", {}))


def test_dropped_events_count_alike(tmp_path):
    tt, jt = traced_fits(dict(max_events=7))
    assert len(tt.events) == len(jt.events) == 7
    assert tt.dropped_events == jt.dropped_events > 0
    path = tt.save(str(tmp_path / "trace.json"))
    with open(path) as f:
        saved = json.load(f)
    assert saved["otherData"]["dropped_events"] == tt.dropped_events


def test_null_tracer_records_nothing_and_profiler_ranges_open():
    with NULL_TRACER.span("x"):
        pass
    assert NULL_TRACER.events == []
    t = SpanTracer(use_torch_profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("dispatch", cat="step"):
            torch.ones(4).sum()
    assert [e["name"] for e in t.events] == ["dispatch"]
    assert "dispatch" in {e.key for e in prof.key_averages()}


def _dump_files(path):
    return sorted(os.listdir(path))


def _nan_fit(mod_pair, rec, tracer):
    tm, jm = mod_pair
    x, y = batches("mln", 24)
    x[3, 1] = np.nan
    tc, jc = collectors(flush_interval=2, hist_interval=100)
    for m, c, r, t in ((tm, tc, rec[0], tracer[0]),
                       (jm, jc, rec[1], tracer[1])):
        m.set_telemetry(c)
        m.set_flight_recorder(r)
        m.set_tracer(t)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 8))
    jm.fit(JArrayIt(JDataSet(x, y), 8))


def test_recorder_writes_the_same_dumps(tmp_path):
    recs = (TFR.FlightRecorder(str(tmp_path / "t"), max_dumps=2),
            JFR.FlightRecorder(str(tmp_path / "j"), max_dumps=2))
    pair = mln_pair()
    _nan_fit(pair, recs, (SpanTracer(), JTracer()))
    for r in recs:
        assert len(r.dumps) == 1 and "dump_nonfinite_" in r.dumps[0]
    assert _dump_files(recs[0].dumps[0]) == _dump_files(recs[1].dumps[0])
    assert "report.md" in _dump_files(recs[0].dumps[0])
    # a second non-finite poll does not dump again; an exception and an
    # OOM are new reasons, but max_dumps stops the third
    for m, r in zip(pair, recs):
        assert r.record_crash(m, reason="nonfinite") is None
        assert r.record_crash(m, exc=ValueError("boom")) is not None
        assert r.record_crash(
            m, exc=RuntimeError("RESOURCE_EXHAUSTED: Out of memory")) is None
    assert [os.path.basename(p).split("_")[1] for p in recs[0].dumps] == \
        [os.path.basename(p).split("_")[1] for p in recs[1].dumps] == \
        ["nonfinite", "exception"]
    assert _dump_files(recs[0].dumps[1]) == _dump_files(recs[1].dumps[1])
    with open(os.path.join(recs[0].dumps[0], "telemetry.json")) as f:
        tel = json.load(f)
    assert any(r["nonfinite_count"] > 0 for r in tel["records"])


def test_environment_switch_and_classification(monkeypatch):
    monkeypatch.setenv("DL4J_CRASH_DUMPS", "0")
    assert TFR.default_flight_recorder() is None
    assert JFR.default_flight_recorder() is None
    assert TFR.FlightRecorder().enabled is JFR.FlightRecorder().enabled \
        is False
    monkeypatch.setenv("DL4J_CRASH_DUMPS", "1")
    assert TFR.default_flight_recorder() is not None
    for marker in JFR._OOM_MARKERS + ("all good",):
        exc = RuntimeError(f"XLA says: {marker}")
        assert TFR._classify(exc) == JFR._classify(exc)
    assert TFR._classify(None) == JFR._classify(None) == "exception"
    assert TFR._classify(torch.OutOfMemoryError("x")) == "oom"


def test_exception_leaving_fit_is_dumped_and_raised(tmp_path):
    tm, _ = mln_pair()
    rec = TFR.FlightRecorder(str(tmp_path))
    tm.set_flight_recorder(rec)
    seen = []

    class Hook:
        def on_epoch_start(self, model, epoch):
            pass

        def iteration_done(self, *args):
            raise torch.OutOfMemoryError("CUDA out of memory (test)")

        def on_crash_dump(self, model, path, reason):
            seen.append(reason)
    tm.set_listeners(Hook())
    x, y = batches("mln", 16)
    with pytest.raises(torch.OutOfMemoryError):
        tm.fit(ArrayDataSetIterator(DataSet(x, y), 8))
    assert seen == ["oom"] and len(rec.dumps) == 1
    with open(os.path.join(rec.dumps[0], "memory.json")) as f:
        assert "analytic" in json.load(f)
    with open(os.path.join(rec.dumps[0], "report.md")) as f:
        assert "OutOfMemoryError" in f.read()
