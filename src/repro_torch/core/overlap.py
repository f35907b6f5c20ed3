"""Communication-overlap analysis of the solver steps (counterpart of
``repro/core/overlap.py``).

The paper demonstrates barrier elimination with Paraver traces (Fig. 1); the
reference measures it structurally on the compiled HLO.  The port measures
it on the op log of one step on a rank (``analysis.oplog``): for every
collective, the bytes of work issued between its start and its wait.  A
blocking barrier shows ~0 slack; an overlapped reduction a vector update's
or a SpMV's worth.

The thresholds are the reference's, in units of one local vector's bytes
``V``: a reduction is a *hard barrier* below ``V/8``
(``tests/test_distributed_solvers.py``); a halo swap is *blocking* below one
boundary plane.  :func:`collective_hides` maps a registry entry's
``reduction_hides`` onto the collectives its step issues and
:func:`meets_hide` holds one window to its class.
"""

from __future__ import annotations

from repro_torch.analysis.oplog import (
    OpLog,
    collective_bytes,
    count_collectives,
    overlap_slack,
    work_bytes,
)

__all__ = [
    "count_collectives",
    "collective_bytes",
    "overlap_slack",
    "record_step",
    "iteration_overlap_report",
    "blocking_reductions",
    "halo_slack",
    "blocking_halos",
    "spmv_bytes",
    "collective_hides",
    "meets_hide",
]

#: how much a reduction's window hides, least first (``reduction_hides``)
HIDE_ORDER = ("none", "vec", "spmv", "pipe")


def record_step(step_fn, *args, mesh, wrap=None) -> list[dict]:
    """The event log of one call ``step_fn(*args)`` on ``mesh``: its ops,
    kernel launches and the comm's starts and waits, in issue order.
    ``wrap(comm) -> comm`` puts a comm around the recording one for the
    call (a test double, say)."""
    log = OpLog()
    with mesh.record(log.events):
        if wrap is not None:
            mesh.comm = wrap(mesh.comm)
        with log:
            step_fn(*args)
    return log.events


def iteration_overlap_report(step_fn, *args, mesh, wrap=None) -> list[dict]:
    """Run one solver iteration (``solve_step_shardmap``'s step) and return
    the per-collective overlap slack (``analysis.oplog.overlap_slack``)."""
    return overlap_slack(record_step(step_fn, *args, mesh=mesh, wrap=wrap))


def blocking_reductions(report: list[dict], vector_bytes: float) -> int:
    """Global reductions (``all_gather``) with less hideable work than an
    eighth of one local vector: the step's hard barriers."""
    return sum(1 for r in report
               if r["op"] == "all_gather" and r["slack_bytes"] < vector_bytes / 8)


def halo_slack(report: list[dict]) -> list[dict]:
    """The halo-swap (``exchange``) entries of a slack report.  Under
    ``halo_mode="overlap"`` a matvec's swap carries the interior apply;
    under ``concat``/``scatter`` the apply waits for the planes, so the
    swap carries nothing."""
    return [r for r in report if r["op"] == "exchange"]


def blocking_halos(report: list[dict], plane_bytes: float | None = None) -> int:
    """Halo swaps with less hideable work than one boundary plane (each
    swap's own ``plane`` unless ``plane_bytes`` is given)."""
    return sum(1 for r in halo_slack(report)
               if r["slack_bytes"] < (r["plane"] if plane_bytes is None else plane_bytes))


def spmv_bytes(op, x, *, mesh) -> int:
    """The bytes of work of one ``op.matvec(x)`` on ``mesh`` (halo swaps
    included): the window a ``"spmv"`` or ``"pipe"`` reduction must cover."""
    return work_bytes(record_step(op.matvec, x, mesh=mesh))


def collective_hides(reduction_hides: tuple[str, ...], collectives: int) -> tuple[str, ...]:
    """The hide class of each collective a step issues, in order: the
    registry's logical reductions one to one, except that when a step
    stacks the trailing ones into fewer collectives (pcg's ``(r·z, r·r)``)
    the stacked collective takes the most hiding class among them: its
    window is theirs to share."""
    n = len(reduction_hides)
    if collectives >= n:
        return tuple(reduction_hides)
    head = tuple(reduction_hides[:collectives - 1])
    tail = max(reduction_hides[collectives - 1:], key=HIDE_ORDER.index)
    return head + (tail,)


def meets_hide(hide: str, slack: float, *, vector_bytes: float, spmv: float) -> bool:
    """Whether a reduction's window ``slack`` is of class ``hide``:
    ``"none"`` below ``V/8``; ``"vec"`` at least ``V``; ``"spmv"`` and
    ``"pipe"`` at least the step's own SpMV bytes."""
    if hide == "none":
        return slack < vector_bytes / 8
    if hide == "vec":
        return slack >= vector_bytes
    if hide in ("spmv", "pipe"):
        return slack >= spmv
    raise ValueError(f"unknown reduction hide class {hide!r}; options: {HIDE_ORDER}")
