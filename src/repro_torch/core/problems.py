"""HPCG/HPCCG problem generation (paper §4.1).

Counterpart of ``repro/core/problems.py``.  The linear system is the standard
HPCG one: a centred stencil on a 3-D hexahedral mesh, with the right-hand side
``b = A·1`` (exact solution ``x* = 1``) and the iterate initialised to
``x0 = 0``.  The system has no weights: the stencil and the b/x0 arrays are its
whole state, so a problem carries its ``device`` and ``dtype`` explicitly
(there is no process-global precision flag as in JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.operators import STENCILS, Stencil

#: the dtypes the solver and its kernels take
DTYPES = (torch.float32, torch.float64)


def as_torch_dtype(dtype) -> torch.dtype:
    """``torch.float32``/``torch.float64`` from a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32,
               "float64": torch.float64}.get(np.dtype(dtype).name)
    if out not in DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}; use float32 or float64")
    return out


def resolve_device(device) -> torch.device:
    """A ``torch.device``; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class HPCGProblem:
    """The system ``A x = b`` on one device.

    ``b_data``/``x0_data`` hold explicit arrays when the problem was built
    from another package's state (:func:`from_reference`); otherwise ``b``
    and ``x0`` are generated (``A·1`` and zeros).
    """

    stencil: Stencil
    shape: tuple[int, int, int]
    dtype: torch.dtype
    device: torch.device
    b_data: torch.Tensor | None = dataclasses.field(default=None, compare=False)
    x0_data: torch.Tensor | None = dataclasses.field(default=None, compare=False)

    @property
    def rows(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    def b(self) -> torch.Tensor:
        """RHS for x* = 1: b = A @ ones (zero in the interior for HPCG-27)."""
        if self.b_data is not None:
            return self.b_data
        return self.stencil.matvec(self.x_true())

    def x0(self) -> torch.Tensor:
        if self.x0_data is not None:
            return self.x0_data
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    def x_true(self) -> torch.Tensor:
        return torch.ones(self.shape, dtype=self.dtype, device=self.device)


def make_problem(
    shape: tuple[int, int, int] = (128, 128, 128),
    stencil: str = "27pt",
    dtype=torch.float64,
    device="cuda",
) -> HPCGProblem:
    if stencil not in STENCILS:
        raise ValueError(f"unknown stencil {stencil!r}; options: {sorted(STENCILS)}")
    return HPCGProblem(stencil=STENCILS[stencil], shape=tuple(int(n) for n in shape),
                       dtype=as_torch_dtype(dtype), device=resolve_device(device))


def from_reference(stencil_name: str, shape, dtype, *, b=None, x0=None,
                   device="cuda") -> HPCGProblem:
    """The port's problem for the reference package's problem description.

    ``stencil_name``/``shape``/``dtype`` describe the JAX ``HPCGProblem``
    (``problem.stencil.name``, ``problem.shape``, ``problem.dtype``); ``b``
    and ``x0`` are optional numpy arrays (e.g. ``np.asarray(problem.b())``)
    copied onto ``device``, so both packages solve the identical system.
    """
    prob = make_problem(shape, stencil_name, dtype=dtype, device=device)

    def put(a):
        if a is None:
            return None
        arr = np.array(a)     # a private, writable copy
        if arr.shape != prob.shape:
            raise ValueError(f"array shape {arr.shape} != problem grid {prob.shape}")
        return torch.as_tensor(arr, dtype=prob.dtype, device=prob.device).contiguous()

    return dataclasses.replace(prob, b_data=put(b), x0_data=put(x0))
