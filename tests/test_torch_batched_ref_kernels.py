"""The batched solve against the reference's ``solve_batched``: 27pt, the kernel route (``kernels=True`` against ``pallas=True``).

The cases, lanes and checks of ``tests/test_torch_batched_ref.py``.
"""

import pytest

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_batched import CASES
from test_torch_batched_ref import check_against_reference


@pytest.mark.parametrize("norm_ref", [1.0, None])
@pytest.mark.parametrize("method, precond", CASES)
def test_batched_lanes_match_reference(x64, method, precond, norm_ref):
    check_against_reference(method, precond, "27pt", True, norm_ref)
