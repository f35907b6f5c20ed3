"""Backend resolution: options + device + ranks -> how the solve executes.

Counterpart of ``repro/api/backend.py``:

  * ``local``     — one device; ``LocalOp`` with zero-padded halos.
  * ``shard_map`` — a mesh of the ranks of a ``torch.distributed`` process
                    group; ``DistributedOp`` with point-to-point halos and
                    one collective a global reduction, on every rank.

Resolution rules, the reference's with "devices" read as "ranks of the
default group":

  1. An explicit ``mesh`` always wins; ``options.dims_map`` then overrides
     the default grid-dim -> mesh-axis mapping.
  2. ``layout="local"`` forces the one-device path.
  3. ``layout="auto"`` picks local when no default group is initialised or
     it has one rank, else the paper-faithful 1-D z split over its ranks.
  4. ``layout="1d" | "2d" | "3d"`` build the corresponding mesh over the
     ranks (1-D ``cells`` / data×model / pod×data×model).

The kernel choice is orthogonal: ``options.kernels`` swaps the stencil SpMV
for the CUDA kernel and turns on the preconditioners' own kernels
(:func:`resolve_precond`), in either world.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.api.options import SolverOptions
from repro_torch.core.distributed import GridLayout, make_layout
from repro_torch.core.operators import Stencil
from repro_torch.core.problems import resolve_device
from repro_torch.launch.mesh import Mesh, make_mesh_for_devices, make_solver_mesh


@dataclasses.dataclass(frozen=True)
class Backend:
    """Resolved execution target for a solve."""

    kind: str                     # "local" | "shard_map"
    device: torch.device
    mesh: Mesh | None = None
    layout: GridLayout | None = None

    @property
    def n_devices(self) -> int:
        """The ranks of the mesh (1 for the local backend)."""
        return 1 if self.mesh is None else self.mesh.size

    def describe(self) -> str:
        if self.kind == "local":
            return f"local(1 device, {self.device})"
        return (f"shard_map({self.mesh.describe()}; "
                f"{self.mesh.backend or 'no group'}, {self.device})")


def _mesh_3d(n: int) -> Mesh:
    """pod×data×model mesh over ``n`` ranks (beyond-paper 3-D blocks)."""
    if n < 8:
        raise ValueError(f"3d layout needs >= 8 devices, have {n}")
    for model in (16, 8, 4, 2):
        if n % model == 0 and (n // model) % 2 == 0:
            return Mesh((2, n // model // 2, model), ("pod", "data", "model"))
    raise ValueError(f"cannot factor {n} devices into pod*data*model")


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def resolve_backend(options: SolverOptions | None = None, *, mesh: Mesh | None = None,
                    n_devices: int | None = None, device="cuda") -> Backend:
    """Apply the resolution rules above on ``device`` (CUDA without a card
    raises).  ``n_devices`` overrides the rank count the rules read (a test
    hook, as in the reference); the meshes are built on the default group."""
    options = options or SolverOptions()
    dev = resolve_device(device)
    if mesh is not None:
        return Backend(kind="shard_map", device=dev, mesh=mesh,
                       layout=make_layout(mesh, options.dims_map))
    n = n_devices if n_devices is not None else _world()
    layout = options.layout
    if layout == "local" or (layout == "auto" and n == 1):
        return Backend(kind="local", device=dev)
    if layout in ("auto", "1d"):
        mesh = make_solver_mesh(n)
    elif layout == "2d":
        mesh = make_mesh_for_devices(n)
    else:  # "3d"
        mesh = _mesh_3d(n)
    return Backend(kind="shard_map", device=dev, mesh=mesh,
                   layout=make_layout(mesh, options.dims_map))


def resolve_matvec(stencil: Stencil,
                   options: SolverOptions) -> Callable | None:
    """The padded-operand SpMV implementing ``options`` (None = plain);
    ``options.matvec_padded`` wins over ``kernels``."""
    if options.matvec_padded is not None:
        return options.matvec_padded
    if options.kernels:
        from repro_torch.kernels import ops
        return ops.make_matvec_padded(stencil)
    return None


def resolve_precond(options: SolverOptions):
    """The ``repro_torch.precond.Preconditioner`` ``options`` asks for.

    ``None`` for ``precond="none"``.  ``options.kernels`` flows into the
    preconditioners that have kernels (``KERNEL_PRECONDS``) unless
    ``precond_params`` pins ``use_kernels`` itself: the same one-flag rule as
    the stencil SpMV.
    """
    if options.precond in (None, "none"):
        return None
    from repro_torch.precond import KERNEL_PRECONDS, make_precond
    params = dict(options.precond_params or {})
    if options.kernels and options.precond in KERNEL_PRECONDS:
        params.setdefault("use_kernels", True)
    return make_precond(options.precond, **params)


def resolve_halo_mode(options: SolverOptions) -> str:
    """Resolve ``halo_mode="auto"`` for the distributed operator:
    ``"overlap"`` (the interior applied while the planes are in flight,
    bitwise the monolithic exchange) for the plain stencil apply,
    ``"concat"`` under the kernels or a custom ``matvec_padded``, whose
    operands are whole padded blocks."""
    if options.halo_mode != "auto":
        return options.halo_mode
    if options.matvec_padded is not None or options.kernels:
        return "concat"
    return "overlap"
