"""The port's StatsListener (ui/stats.py) against the JAX package's on the
CPU, and the port's training dashboard fed by it.

The same narrow MultiLayerNetwork and batches in both packages: the
static record and every update record carry the same keys; without
telemetry the parameter and update statistics (host copies of the
parameters) agree with the JAX package's — mean magnitudes and spreads
within 1e-4 relative (1e-7 absolute), histogram ranges within 1e-4 of
their extent and counts within 4 (the telemetry test's rounding rule);
with a histogram-enabled TelemetryCollector the statistics come from
the ring's histograms in both packages, within the same bounds. The
port's UIServer lists the session under ``/api/sessions`` and returns
its updates.
"""

import json
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import \
    ArrayDataSetIterator as JArrayIt
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.ui.stats import StatsListener as JStats
from deeplearning4j_tpu.ui.storage import \
    InMemoryStatsStorage as JStorage
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage, StatsListener,
                                         UIServer)
from test_torch_telemetry import batches, collectors, mln_pair

REL, COUNT_SLACK = 1e-4, 4


def run_both(telemetry):
    tm, jm = mln_pair()
    x, y = batches("mln", 32)
    stores = (InMemoryStatsStorage(), JStorage())
    tl = StatsListener(stores[0], session_id="s", histogram_bins=8)
    jl = JStats(stores[1], session_id="s", histogram_bins=8)
    tm.set_listeners(tl)
    jm.set_listeners(jl)
    if telemetry:
        tc, jc = collectors(flush_interval=1, hist_interval=1)
        tm.set_telemetry(tc)
        jm.set_telemetry(jc)
    tm.fit(ArrayDataSetIterator(DataSet(x, y), 8))
    jm.fit(JArrayIt(JDataSet(x, y), 8))
    return stores


def assert_stats_close(got, want):
    assert set(got) == set(want)
    for lname, w in want.items():
        g = got[lname]
        assert set(g) == set(w)
        for key in ("mean_magnitude", "stdev"):
            if key in w:
                assert g[key] == pytest.approx(w[key], rel=REL, abs=1e-7)
        gh, wh = g["histogram"], w["histogram"]
        extent = max(abs(wh["min"]), abs(wh["max"]), 1e-12)
        assert abs(gh["min"] - wh["min"]) <= REL * extent
        assert abs(gh["max"] - wh["max"]) <= REL * extent
        assert sum(gh["counts"]) == sum(wh["counts"])
        assert np.abs(np.subtract(gh["counts"],
                                  wh["counts"])).sum() <= COUNT_SLACK


@pytest.mark.parametrize("telemetry", [False, True])
def test_records_match_jax(telemetry):
    ts, js = run_both(telemetry)
    t_static, j_static = ts.get_static_info("s"), js.get_static_info("s")
    assert set(t_static) == set(j_static)
    for key in ("model_class", "num_params", "layer_names", "model_graph"):
        assert t_static[key] == j_static[key]
    tu, ju = ts.get_all_updates("s"), js.get_all_updates("s")
    assert len(tu) == len(ju) == 4
    for got, want in zip(tu, ju):
        assert set(got) == set(want)
        assert got["iteration"] == want["iteration"]
        assert got["score"] == pytest.approx(want["score"], rel=1e-5)
        for kind in ("param_stats", "update_stats", "grad_stats"):
            assert (kind in got) == (kind in want)
            if kind in want:
                assert_stats_close(got[kind], want[kind])
    if telemetry:
        assert "device_metrics" in tu[-1] and "grad_stats" in tu[-1]


def test_dashboard_lists_the_session():
    ts, _ = run_both(False)
    server = UIServer(port=0).attach(ts)
    server.start()
    try:
        with urllib.request.urlopen(server.url + "/api/sessions") as r:
            assert json.loads(r.read()) == ["s"]
        with urllib.request.urlopen(server.url + "/api/updates?session=s"
                                    ) as r:
            assert [u["iteration"] for u in json.loads(r.read())] == [
                1, 2, 3, 4]
    finally:
        server.stop()
