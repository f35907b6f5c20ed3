"""Sparse operators for HPCG-class problems, as PyTorch tensor code.

Counterpart of ``repro/core/operators.py``.  The HPCG operator is a
constant-coefficient 7- or 27-point centred stencil on a dense ``(nx, ny, nz)``
grid (z contiguous).  It is applied as shifted adds over a zero-padded array:
zero halos reproduce the HPCG boundary treatment exactly, because the matrix
keeps a constant diagonal and drops out-of-domain neighbours.

The interior/shell split of the distributed SpMV (:func:`interior_matvec`,
:func:`shell_assemble`) and the ELLPACK operator (:class:`ELLOperator`, the
general bounded-row sparse path and the stencil's cross-check oracle) are the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _offsets_7pt() -> tuple[tuple[int, int, int], ...]:
    return (
        (-1, 0, 0), (1, 0, 0),
        (0, -1, 0), (0, 1, 0),
        (0, 0, -1), (0, 0, 1),
    )


def _offsets_27pt() -> tuple[tuple[int, int, int], ...]:
    offs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) != (0, 0, 0):
                    offs.append((dx, dy, dz))
    return tuple(offs)


def pad1(x: torch.Tensor) -> torch.Tensor:
    """Zero halo of width one on the last three axes: (..., nx, ny, nz) ->
    (..., nx+2, ny+2, nz+2)."""
    return F.pad(x, (1, 1, 1, 1, 1, 1))


@dataclasses.dataclass(frozen=True)
class Stencil:
    """Constant-coefficient centred stencil operator on a 3-D grid.

    ``A x`` for row (i,j,k):  ``diag * x[i,j,k] + off_coeff * sum(neigh x)``
    with out-of-domain neighbours dropped (== zero-padded halo).
    """

    name: str
    offsets: tuple[tuple[int, int, int], ...]
    diag: float
    off_coeff: float = -1.0

    @property
    def npoint(self) -> int:
        return len(self.offsets) + 1

    @property
    def nbar(self) -> int:
        """Average nonzeros per row (paper's n̄): 7 or 27 for interior rows."""
        return self.npoint

    def _shifted(self, xp: torch.Tensor, d: tuple[int, int, int]) -> torch.Tensor:
        nx, ny, nz = (n - 2 for n in xp.shape[-3:])
        dx, dy, dz = d
        return xp[..., 1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny, 1 + dz:1 + dz + nz]

    def matvec_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """Apply to a halo-padded array ``(nx+2, ny+2, nz+2)`` -> ``(nx, ny, nz)``.

        The plain PyTorch version of the stencil kernels: the centre term
        first, then the offsets in ``self.offsets`` order, one rounding per
        multiply and per add (the order the CUDA kernels keep).  Leading
        axes (a batch of lanes) pass through: the grid is the last three.
        """
        acc = self.diag * xp[..., 1:-1, 1:-1, 1:-1]
        for d in self.offsets:
            acc = acc + self.off_coeff * self._shifted(xp, d)
        return acc

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to an unpadded grid array ``(nx, ny, nz)`` with zero boundary."""
        return self.matvec_padded(pad1(x))

    # --- Gauss-Seidel helpers -------------------------------------------------
    def offdiag_apply_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """(A - D) x on a padded array."""
        acc = torch.zeros_like(xp[..., 1:-1, 1:-1, 1:-1])
        for d in self.offsets:
            acc = acc + self.off_coeff * self._shifted(xp, d)
        return acc

    def plane_offdiag_apply(self, xp: torch.Tensor, k: int) -> torch.Tensor:
        """(A - D) x restricted to z-plane ``k`` of the interior (padded ``xp``)."""
        nx, ny = xp.shape[-3] - 2, xp.shape[-2] - 2
        acc = torch.zeros_like(xp[..., 1:-1, 1:-1, 0])
        for dx, dy, dz in self.offsets:
            plane = xp[..., 1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny, k + 1 + dz]
            acc = acc + self.off_coeff * plane
        return acc


# -----------------------------------------------------------------------------
# Interior/boundary-shell split (the overlapped halo-exchange SpMV)
# -----------------------------------------------------------------------------
# Output cells at distance >= 1 from every decomposed face read no exchanged
# halo, so they can be computed while the halos are in flight; only the
# one-cell boundary shell waits for the received planes.  Both functions
# delegate the apply to a ``matvec_padded`` callable, and each output
# element's arithmetic is independent of its position, so the split is
# bitwise the monolithic apply.

def interior_matvec(mv_padded, x: torch.Tensor,
                    split_dims: Sequence[int]) -> torch.Tensor:
    """Apply the stencil to the halo-independent interior of a local block.

    ``x`` is the unpadded local block (leading axes, a batch of lanes, pass
    through: the grid is the last three).  Along each dim in ``split_dims``
    the block itself gives the one-cell support of its interior (output
    extent ``n - 2``); the other dims get the zero halo (physical boundary).
    """
    pad = []
    for d in (2, 1, 0):                     # F.pad lists the last dim first
        pad += [0, 0] if d in split_dims else [1, 1]
    return mv_padded(F.pad(x, pad))


def shell_assemble(mv_padded, xp: torch.Tensor, y_interior: torch.Tensor,
                   split_dims: Sequence[int]) -> torch.Tensor:
    """Finish the split apply: the boundary-shell slabs from the exchanged
    padded array ``xp``, concatenated around ``y_interior``.

    Slabs are computed per split dim (outermost last) over the
    still-interior extent of the dims assembled before them, so each edge or
    corner cell is made once, from the ``xp`` values the monolithic apply
    reads.  Leading axes of ``xp`` and ``y_interior`` (a batch of lanes)
    pass through; grid dim ``d`` is tensor dim ``d - 3``.
    """
    y = y_interior
    done: set[int] = set()
    for d in sorted(split_dims, reverse=True):
        def slab(lo: bool) -> torch.Tensor:
            idx = [Ellipsis]
            for e in range(3):
                pe = xp.shape[e - 3]
                if e == d:                      # 3 planes -> 1 output plane
                    s = 0 if lo else pe - 3
                    idx.append(slice(s, s + 3))
                elif e in split_dims and e not in done:
                    idx.append(slice(1, pe - 1))   # still at interior extent
                else:
                    idx.append(slice(0, pe))       # assembled or unsplit
            return mv_padded(xp[tuple(idx)])

        y = torch.cat([slab(True), y, slab(False)], dim=d - 3)
        done.add(d)
    return y


# HPCCG's generator puts 27.0 on the diagonal and -1 on every neighbour, for
# BOTH sparsity levels (the reference's comment gives the consequences).
STENCIL_7PT = Stencil(name="7pt", offsets=_offsets_7pt(), diag=27.0)
STENCIL_27PT = Stencil(name="27pt", offsets=_offsets_27pt(), diag=27.0)

STENCILS = {"7pt": STENCIL_7PT, "27pt": STENCIL_27PT}


# -----------------------------------------------------------------------------
# ELLPACK general-sparse path (oracle + unstructured matrices)
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class ELLOperator:
    """ELLPACK sparse matrix: a fixed number of nonzeros a row, masked.

    ``indices``: (rows, k) int64 column ids (any value where masked out).
    ``values`` : (rows, k) coefficients (0 where masked out).
    The gather in :meth:`matvec` is ``torch.take``; the stencil path is the
    one to prefer for HPCG matrices.
    """

    indices: torch.Tensor
    values: torch.Tensor

    @property
    def rows(self) -> int:
        return self.indices.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1)
        gathered = flat[self.indices]                        # (rows, k)
        y = torch.sum(self.values.to(x.dtype) * gathered, dim=1)
        return y.reshape(x.shape)


def build_ell_from_stencil(stencil: Stencil, shape: tuple[int, int, int], *,
                           device="cpu") -> ELLOperator:
    """Materialise the stencil on ``shape`` as an ELL matrix (slot 0 the
    diagonal, then the offsets in ``stencil.offsets`` order), in float64."""
    nx, ny, nz = shape
    n = nx * ny * nz
    k = stencil.npoint
    idx = np.zeros((n, k), dtype=np.int64)
    val = np.zeros((n, k), dtype=np.float64)
    grid = np.arange(n).reshape(shape)
    idx[:, 0] = np.arange(n)
    val[:, 0] = stencil.diag
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    for s, (dx, dy, dz) in enumerate(stencil.offsets, start=1):
        In, Jn, Kn = I + dx, J + dy, K + dz
        ok = (In >= 0) & (In < nx) & (Jn >= 0) & (Jn < ny) & (Kn >= 0) & (Kn < nz)
        neigh = grid[np.clip(In, 0, nx - 1), np.clip(Jn, 0, ny - 1), np.clip(Kn, 0, nz - 1)]
        idx[:, s] = np.where(ok, neigh, 0).reshape(-1)
        val[:, s] = np.where(ok, stencil.off_coeff, 0.0).reshape(-1)
    return ELLOperator(indices=torch.as_tensor(idx, device=device),
                       values=torch.as_tensor(val, device=device))


def build_dense_from_stencil(stencil: Stencil, shape: tuple[int, int, int]) -> np.ndarray:
    """Dense matrix for tiny grids — used by tests against numpy/scipy solves."""
    ell = build_ell_from_stencil(stencil, shape)
    n = int(np.prod(shape))
    A = np.zeros((n, n))
    idx, val = ell.indices.numpy(), ell.values.numpy()
    np.add.at(A, (np.repeat(np.arange(n), idx.shape[1]), idx.reshape(-1)), val.reshape(-1))
    return A


def touched_elements_per_iter(method: str, nbar: int) -> int:
    """Paper §3.1 analytic memory-traffic model, elements touched per row.

    CG: (12+n̄)r, CG-NB: (15+n̄)r, BiCGStab: (21+2n̄)r, BiCGStab-B1: (24+2n̄)r;
    the same accounting as the reference for the other methods.
    """
    table = {
        "cg": 12 + nbar,
        "cg_nb": 15 + nbar,
        "bicgstab": 21 + 2 * nbar,
        "bicgstab_b1": 24 + 2 * nbar,
        "pcg": 16 + nbar,
        "pbicgstab": 27 + 2 * nbar,
        "cg_merged": 15 + nbar,
        "cg_pipe": 21 + nbar,
        "pcg_merged": 19 + nbar,
        "pcg_pipe": 28 + nbar,
        "bicgstab_merged": 33 + 2 * nbar,
        "pbicgstab_merged": 33 + 2 * nbar,
        "jacobi": 4 + nbar,
        "gauss_seidel": 6 + 2 * nbar,
        "gauss_seidel_rb": 6 + 2 * nbar,
    }
    return table[method]
