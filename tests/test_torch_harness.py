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
