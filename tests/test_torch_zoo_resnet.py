"""The unfused ResNet50 zoo model, with both stems, against the JAX package
on the CPU,
in a file of its own so that test workers run it beside the other zoo
files: ``tests/test_torch_zoo.py``'s parity check (output, loss,
gradients and one step, with that file's bounds).
"""

import pytest

from test_torch_zoo import _ids, _zoo_cases, check_zoo_model


@pytest.mark.parametrize("case", [c for c in _zoo_cases()
                                  if c[0] == "ResNet50" and not c[1].get("fused_blocks")], ids=_ids)
def test_zoo_model_matches_jax(case):
    check_zoo_model(case)
