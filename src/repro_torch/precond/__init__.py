# The preconditioning subsystem (counterpart of repro.precond): the
# Preconditioner protocol with four reduction-free implementations, consumed
# by pcg, pbicgstab and pcg_merged through SolverOptions.precond.  Importing
# the implementation modules registers them.
from repro_torch.precond.base import (
    PRECONDITIONERS,
    Preconditioner,
    make_precond,
    precond_names,
    register_preconditioner,
)
from repro_torch.precond.chebyshev import Chebyshev, gershgorin_bounds
from repro_torch.precond.jacobi import BlockJacobi, PointJacobi
from repro_torch.precond.ssor import SSOR

#: preconditioners with a CUDA kernel behind ``use_kernels=True`` (the
#: counterpart of the reference's ``PALLAS_PRECONDS``)
KERNEL_PRECONDS = ("block_jacobi", "chebyshev")

__all__ = [
    "KERNEL_PRECONDS",
    "PRECONDITIONERS",
    "BlockJacobi",
    "Chebyshev",
    "PointJacobi",
    "Preconditioner",
    "SSOR",
    "gershgorin_bounds",
    "make_precond",
    "precond_names",
    "register_preconditioner",
]
