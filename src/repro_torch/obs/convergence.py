"""Per-iteration convergence telemetry — the host-side half (counterpart of
``repro/obs/convergence.py``).

The device-side half is the driver's (``core.methods.Watch``): an opt-in,
bounded ``(rows, n_scalars)`` buffer of every declared loop-carry scalar,
written by the eager loop, the graphed block driver and the batched drivers
alike.  This module turns that buffer (and the always-present residual
``history``) into named per-scalar curves, trimmed residual curves, a JSON
record, and the offline true-residual recompute the tests hold the
telemetry to.

Enabled by ``SolverOptions(telemetry=True[, telemetry_buffer=N])``;
``python -m repro_torch.launch.solve --telemetry --json`` embeds
:func:`curve_record` in its record.
"""

from __future__ import annotations

import numpy as np
import torch


def _get_method(method: str):
    from repro_torch.core.methods import get_method
    return get_method(method)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def effective_rows(result) -> int:
    """Rows of ``result.telemetry`` actually written: ``iters + 1`` clamped
    to the buffer bound (iterations past the buffer overwrote its last
    row)."""
    if result.telemetry is None:
        raise ValueError("result carries no telemetry "
                         "(SolverOptions.telemetry was off)")
    cap = int(result.telemetry.shape[-2])
    return min(int(_np(result.iters).max()) + 1, cap)


def scalar_history(result, method: str) -> dict[str, np.ndarray]:
    """``{scalar name: per-iteration values}`` from a telemetry-carrying
    ``SolveResult``, keyed by the method's declared scalar slots and
    trimmed to the rows actually written (row 0 = the initial state)."""
    mdef = _get_method(method)
    rows = effective_rows(result)
    tele = _np(result.telemetry)[..., :rows, :]
    return {name: tele[..., i] for i, name in enumerate(mdef.scalars)}


def residual_curve(result) -> np.ndarray:
    """The per-iteration residual-norm curve, trimmed to ``iters + 1``
    entries (the NaN padding past convergence dropped).  Reads the driver's
    ``history``, present on every solve, telemetry or not."""
    hist = _np(result.history)
    return hist[..., : int(_np(result.iters).max()) + 1]


def telemetry_residuals(result, method: str) -> np.ndarray:
    """The residual curve as the telemetry buffer recorded it: sqrt of the
    method's declared ``res_scalar`` column.  Equals :func:`residual_curve`
    over the buffered rows."""
    mdef = _get_method(method)
    rows = effective_rows(result)
    tele = _np(result.telemetry)
    return np.sqrt(tele[..., :rows, mdef.res_index - len(mdef.vectors)])


def true_residual_norm(A, b, x) -> float:
    """``||b - A x||_2`` recomputed offline against the port's operator
    (``A.matvec``: a ``LocalOp`` or ``KernelOp``) — the ground truth the
    recurrence-carried curves drift from by O(eps * kappa) per
    iteration."""
    r = b - A.matvec(x)
    return float(torch.sqrt(torch.dot(r.reshape(-1), r.reshape(-1))))


def curve_record(result, method: str, *, scalars: bool = False) -> dict:
    """A JSON-able telemetry record for one solve (what the CLI's
    ``--telemetry --json`` embeds).

    Always: ``iters`` and the trimmed ``residuals`` curve.  When the result
    carries a telemetry buffer: ``telemetry_rows`` (buffer rows written)
    and, with ``scalars=True``, every named scalar curve.
    """
    out = {
        "iters": int(_np(result.iters).max()),
        "residuals": [float(v) for v in np.atleast_1d(
            np.asarray(residual_curve(result)).squeeze())],
    }
    if result.telemetry is not None:
        out["telemetry_rows"] = effective_rows(result)
        if scalars:
            out["scalars"] = {
                name: [float(v) for v in np.atleast_1d(vals.squeeze())]
                for name, vals in scalar_history(result, method).items()
            }
    return out
