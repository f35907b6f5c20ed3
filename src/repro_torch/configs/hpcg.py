"""The paper's own workload: HPCG sparse systems + solver selection.

The port's own copy of ``repro/configs/hpcg.py``, for the methods ported so
far (the preconditioned cells wait for ROADMAP queue 1 item 6).  Weak-scaling
sizes follow the paper's §4.1: 128³ per MPI rank, 128x128x3072 per hybrid
socket.  ``to_options()`` / ``session()`` turn a cell into the typed
``repro_torch.api`` objects that run it.
"""

from __future__ import annotations

import dataclasses

#: the paper's per-rank block and per-socket hybrid block (§4.1)
RANK_BLOCK = (128, 128, 128)
SOCKET_BLOCK = (128, 128, 3072)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    name: str
    method: str                  # repro_torch.api registry key
    stencil: str                 # "7pt" | "27pt"
    local_grid: tuple[int, int, int] = RANK_BLOCK
    tol: float = 1e-6
    maxiter: int = 600

    def to_options(self, **overrides):
        """The cell's ``repro_torch.api.SolverOptions`` (overrides win)."""
        from repro_torch.api import SolverOptions
        kw = dict(tol=self.tol, maxiter=self.maxiter)
        kw.update(overrides)
        return SolverOptions(**kw)

    def session(self, *, grid=None, device=None, **overrides):
        """A ready ``SolverSession`` for this cell (one rank's block)."""
        from repro_torch.api import SolverSession
        return SolverSession(method=self.method,
                             grid=tuple(grid or self.local_grid),
                             stencil=self.stencil, device=device,
                             options=self.to_options(**overrides))


SOLVER_CONFIGS = {
    f"hpcg-{m}-{s}": SolverConfig(name=f"hpcg-{m}-{s}", method=m, stencil=s)
    for m in ("jacobi", "gauss_seidel", "gauss_seidel_rb", "cg", "cg_nb",
              "bicgstab", "bicgstab_b1")
    for s in ("7pt", "27pt")
}
