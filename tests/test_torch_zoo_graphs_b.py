"""GoogLeNet against the JAX package on the CPU (``tests/test_torch_zoo.py``'s
parity check), and YOLO2's default Adam step; split from
``test_torch_zoo_graphs.py`` so that test workers run them side by side.
"""

import pytest

from test_torch_zoo import GRAPHS, _ids, check_zoo_model


@pytest.mark.parametrize("case", [(name, {}) for name in GRAPHS[1:2]],
                         ids=_ids)
def test_graph_zoo_model_matches_jax(case):
    check_zoo_model(case)


@pytest.mark.parametrize("hw", [64, 96])
def test_yolo2_default_adam_step_jumps_the_loss_as_in_jax(hw):
    """YOLO2's default updater, Adam(1e-3), from the JAX package's random
    init on synthetic boxes (chip_smoke.py's zoo phase labels: half the
    cells hold an object): one step raises the loss many times over in
    both packages, by the same amount. The first step moves every weight
    by about ±lr whatever its gradient, so the box head's 1024 inputs
    shift its raw outputs, and exp(tw) with them, together. Bounds: the
    first loss within 1e-4 relative (the zoo file's YOLO2 bound); after
    the step, each loss above 10× the first, and the two within 10% of
    each other, since a gradient that the two summation orders put on
    either side of zero moves its weight by ±lr in opposite directions
    (measured on a CPU: 4% at 64×64, 0.6% at 96×96)."""
    import jax
    import numpy as np

    import deeplearning4j_tpu.zoo.models as JZ
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.serialization import (
        opt_state_from_jax, params_from_jax)
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration

    n, c = 2, 20
    jconf = JZ.YOLO2(num_classes=c, height=hw, width=hw).conf()
    tconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    jm = JGraph(jconf).init()
    tm = ComputationGraph(tconf, device="cpu").init()
    ts = jax.tree_util.tree_map(np.asarray, jm.train_state)
    params_from_jax(ts.params, ts.model_state, "cpu", model=tm)
    opt_state_from_jax(ts.opt_state, tm)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (n, hw, hw, 3)).astype(np.float32)
    g = hw // 32
    y = np.zeros((n, g, g, 4 + c), np.float32)
    y[..., 0] = rng.uniform(0, g, (n, g, g))
    y[..., 1] = rng.uniform(0, g, (n, g, g))
    y[..., 2:4] = rng.uniform(0.5, 4.0, (n, g, g, 2))
    obj = rng.uniform(size=(n, g, g)) < 0.5
    y[..., 4:][obj] = np.eye(c, dtype=np.float32)[
        rng.integers(0, c, int(obj.sum()))]
    lj, lt = [], []
    for _ in range(2):                       # fit reports the loss before
        jm.fit(JDataSet(x, y))               # its step
        lj.append(float(jm._last_loss))
        tm.fit(DataSet(x, y))
        lt.append(float(tm._last_loss))
    print(f"YOLO2 {hw}x{hw}, Adam(1e-3): JAX losses {lj}, port {lt}")
    assert lt[0] == pytest.approx(lj[0], rel=1e-4)
    assert min(lj[1], lt[1]) > 10 * lj[0]
    assert lt[1] == pytest.approx(lj[1], rel=0.1)
