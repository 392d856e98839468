"""The zoo's four graph models with the most layers (YOLO2, GoogLeNet,
InceptionResNetV1, FaceNetNN4Small2) against the JAX package on the CPU:
``tests/test_torch_zoo.py``'s parity check (output, loss, gradients and
one step, with that file's bounds). YOLO2 is here; GoogLeNet with the
YOLO2 Adam step is in ``test_torch_zoo_graphs_b.py``, InceptionResNetV1
and FaceNetNN4Small2 in ``test_torch_zoo_graphs_c.py``, so that test
workers run them side by side.
"""

import pytest

from test_torch_zoo import GRAPHS, _ids, check_zoo_model


@pytest.mark.parametrize("case", [(name, {}) for name in GRAPHS[:1]],
                         ids=_ids)
def test_graph_zoo_model_matches_jax(case):
    check_zoo_model(case)
