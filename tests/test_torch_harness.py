"""Shared harness of the PyTorch port's tests: loads the JAX reference.

The reference does not import cleanly under jax 0.9: ``repro/core/compat.py``
tests ``optimization_barrier_p in batching.primitive_batchers``, and that
object is now a write-only ``PrimitiveBatchersProxy`` with no
``__contains__``.  :func:`apply_jax_shim` gives the proxy's type a
``__contains__`` that looks the primitive up in
``jax._src.interpreters.batching.fancy_primitive_batchers`` (where the proxy
stores every rule).  It patches only that type, only in this test process,
only when ``__contains__`` is missing, and is idempotent.  It runs when this
module is imported, before any ``repro`` import of the port's tests.

Other ``tests/test_torch_*.py`` files get the reference through the helpers
here (``from test_torch_harness import ...``).
"""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch


def apply_jax_shim() -> None:
    from jax._src.interpreters import batching as _batching
    proxy_type = type(jax.interpreters.batching.primitive_batchers)
    if "__contains__" in vars(proxy_type) or proxy_type is dict:
        return

    def __contains__(self, prim):
        return prim in _batching.fancy_primitive_batchers

    proxy_type.__contains__ = __contains__


apply_jax_shim()


@pytest.fixture(scope="module")
def x64():
    """JAX in float64 for one test module, restored after it.  (The session
    fixture ``f64`` of ``tests/conftest.py`` would leave x64 on for every
    later test file of the same pytest-xdist worker.)"""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def ref_module(name: str):
    """The reference module ``repro.<name>`` (imported after the shim)."""
    return importlib.import_module(f"repro.{name}")


def ref_api():
    return ref_module("api")


def to_np(t) -> np.ndarray:
    """numpy view of a torch tensor or a jax array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def seeded(shape, seed: int, dtype=np.float64) -> np.ndarray:
    """Test input made with numpy from a seed, fed to both packages."""
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def history_atol(h_ref) -> float:
    """Absolute tolerance of residual norms: 1e-13 of the initial residual.

    The true residual ``b - A x`` of the stationary methods is a difference
    of nearly equal vectors, so its rounding scales with ``||b||`` (here the
    initial residual), not with the small ``||r||`` near convergence."""
    return 1e-13 * float(to_np(h_ref)[0])


def assert_history_equal(h_port, h_ref, *, rtol=1e-10) -> None:
    """Residual histories agree where finite (rtol, plus :func:`history_atol`)
    and are NaN at the same places."""
    a, b = to_np(h_port), to_np(h_ref)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=history_atol(h_ref))


def assert_telemetry_close(got, want, hist_ref, iters: int, res_col: int, *,
                           rtol=1e-12) -> None:
    """Telemetry buffers agree: NaN and inf at the same places (infs equal).

    The residual column ``res_col`` (the squared residual the history is
    the root of) is held as :func:`assert_history_equal` holds the history.
    Every other finite entry is within ``rtol`` of the reference's, relative
    to itself and scaled by the residual's fall up to its row (``h0 / h_k``
    from the reference's ``history``; the buffer's last row holds the last
    iteration once it overflows).  Each loop scalar is a dot of, or a
    quotient of dots of, the recurrence vectors, whose rounding under two
    summation orders grows as ``eps · h0 / h_k`` while the scalar falls with
    the residual; the history's own ``atol`` is that bound at 1e-13.  A row
    whose reference history is 0 or not finite gets no scaling."""
    a, b, h = to_np(got), to_np(want), to_np(hist_ref)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_array_equal(a[np.isinf(a)], b[np.isinf(b)])
    with np.errstate(invalid="ignore"):
        assert_history_equal(np.sqrt(a[:, res_col]), np.sqrt(b[:, res_col]))
    cap = a.shape[0]
    rows = np.arange(cap)
    k = np.where(rows == cap - 1, max(iters, cap - 1), rows).clip(max=len(h) - 1)
    hk = h[k]
    with np.errstate(divide="ignore", invalid="ignore"):
        fall = np.where((hk > 0) & np.isfinite(hk), np.maximum(h[0] / hk, 1.0), 1.0)
    others = np.arange(a.shape[1]) != res_col
    fin = np.isfinite(b) & others
    err = np.abs(np.where(fin, a, 0.0) - np.where(fin, b, 0.0))
    bound = np.where(fin, rtol * np.abs(b) * fall[:, None], 0.0)
    assert (err <= bound).all(), np.max(err - bound)


def test_shim_makes_reference_importable_and_runnable(x64):
    """With the shim, ``repro.api.solve`` imports and runs (merged CG on the
    Pallas path in interpret mode included)."""
    proxy_type = type(jax.interpreters.batching.primitive_batchers)
    assert "__contains__" in vars(proxy_type) or proxy_type is dict
    api = ref_api()
    res = api.solve(method="cg", grid=(8, 8, 8), stencil="7pt",
                    options=api.SolverOptions())
    assert int(res.status) == 0 and int(res.iters) > 0
    fused = api.solve(method="cg_merged", grid=(8, 8, 8), stencil="7pt",
                      options=api.SolverOptions(pallas=True))
    assert int(fused.iters) == int(res.iters)


def test_shim_is_idempotent():
    proxy_type = type(jax.interpreters.batching.primitive_batchers)
    before = vars(proxy_type).get("__contains__")
    apply_jax_shim()
    assert vars(proxy_type).get("__contains__") is before


@pytest.mark.parametrize("row, col, change, zero_last, passes", [
    (0, 1, 0.0, False, True),
    (3, 1, 1e-3, False, True),      # the last row's bound: 1e-12 × a fall of 1e10
    (3, 1, 1e-1, False, False),
    (0, 1, 1e-11, False, False),    # no fall yet: 1e-12
    (2, 0, 5e-7, False, False),     # the residual column: the history's tolerance
    (3, 1, 1e-6, True, False),      # a zero history row gets no scaling
], ids=["equal", "late-within", "late-past", "early-past", "residual-past",
        "zero-history"])
def test_telemetry_close_bounds(row, col, change, zero_last, passes):
    """:func:`assert_telemetry_close` on a buffer whose residual (column 0)
    falls 1e10 over four rows: the fall widens only the other columns, the
    residual column is held as the history is, and a row whose history is 0
    is held to the plain 1e-12."""
    h = np.array([1.0, 1e-3, 1e-6, 0.0 if zero_last else 1e-10])
    want = np.stack([h ** 2, [0.5, 2e-3, 3e-6, 4e-10]], axis=1)
    got = want.copy()
    got[row, col] *= 1 + change
    if passes:
        assert_telemetry_close(got, want, h, 3, 0)
    else:
        with pytest.raises(AssertionError):
            assert_telemetry_close(got, want, h, 3, 0)
