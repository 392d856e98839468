"""InceptionResNetV1 and FaceNetNN4Small2 against the JAX package on the
CPU (``tests/test_torch_zoo.py``'s parity check); split from
``test_torch_zoo_graphs.py`` so that test workers run them side by side.
"""

import pytest

from test_torch_zoo import GRAPHS, _ids, check_zoo_model


@pytest.mark.parametrize("case", [(name, {}) for name in GRAPHS[2:]],
                         ids=_ids)
def test_graph_zoo_model_matches_jax(case):
    check_zoo_model(case)
