"""The batched solve against the reference's ``solve_batched``: 27pt, the
plain route (``kernels=False`` against ``pallas=False``).

On the 10×7×13 grid in f64, three lanes (a seeded normal one, ``A·1`` and
a zero one) go through the port's ``SolverSession.solve_batched`` and the
reference's (its vmapped solve, ``repro/api/session.py:455-535``), for
every method without a preconditioner and each preconditioner on every
method that takes one, on both routes (``kernels`` against the reference's
``pallas``: its Pallas kernels in interpret mode), under the absolute
criterion (``norm_ref`` 1.0) and the relative one (None, where the zero lane
breaks down or runs to ``maxiter``).  Each lane: ``iters`` and ``status``
equal, ``x`` within 1e-12 absolute, the history within rtol 1e-10 (plus
1e-13 of the initial residual, ``history_atol``) where finite and NaN at
the same places; and each lane bitwise the port's own single solve of it.
The other stencil and route are ``tests/test_torch_batched_ref_*.py``, one
file each (each file's solves take about a minute on one CPU worker).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_harness import x64  # noqa: F401  (fixture)
from test_torch_harness import assert_history_equal, ref_api, to_np
from test_torch_batched import CASES, assert_lanes_are_single_solves, lanes, session


def check_against_reference(method, precond, stencil, kernels, norm_ref):
    sess = session(method, precond, stencil=stencil, kernels=kernels, norm_ref=norm_ref)
    bs = lanes(sess)
    got = sess.solve_batched(bs)
    api = ref_api()
    rsess = api.SolverSession(method=method, grid=sess.problem.shape, stencil=stencil,
                              options=api.SolverOptions(pallas=kernels, precond=precond,
                                                        norm_ref=norm_ref, maxiter=300))
    want = rsess.solve_batched(jnp.asarray(to_np(bs)))
    np.testing.assert_array_equal(to_np(got.iters), to_np(want.iters))
    np.testing.assert_array_equal(to_np(got.status), to_np(want.status))
    for i in range(bs.shape[0]):
        np.testing.assert_allclose(to_np(got.x[i]), to_np(want.x)[i], rtol=0, atol=1e-12)
        assert_history_equal(got.history[i], to_np(want.history)[i], rtol=1e-10)
    assert_lanes_are_single_solves(sess, bs, got)


@pytest.mark.parametrize("norm_ref", [1.0, None])
@pytest.mark.parametrize("method, precond", CASES)
def test_batched_lanes_match_reference(x64, method, precond, norm_ref):
    check_against_reference(method, precond, "27pt", False, norm_ref)
