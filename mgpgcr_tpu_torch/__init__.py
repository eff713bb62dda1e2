"""mgpgcr_tpu_torch: the PyTorch + CUDA port of ``mgpgcr_tpu``.

Fields are split re/im ``cplx.CF`` pairs in the slab layout
``(4, 3, T, Z, Y*X)``; the Wilson--Dirac operator ``A = I - kD`` runs on
hand-written CUDA kernels for Hopper (``csrc/``, built by one ``nvcc`` call
at first use and bound with ``ctypes``), and flexible GCR runs either as
the generic loop or through the kernels, in the restart-cycle form or the
loop form on direction stacks (and as the host-driven ``gcr_solve_eager``),
plain or with the two-level multigrid preconditioner (``setup_mg``). Entry
points run on CUDA unless the caller passes ``device="cpu"``; CPU tensors
take each kernel's plain PyTorch version. The JAX package ``mgpgcr_tpu``
is the reference this package is held against.
"""

from mgpgcr_tpu_torch import cplx, fields
from mgpgcr_tpu_torch.mesh import BlockMap, LatticeMesh
from mgpgcr_tpu_torch.ops.dense import DenseOperator
from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash import (
    CudaWilsonDirac,
    field_from_numpy,
    field_to_numpy,
    links_from_numpy,
)
from mgpgcr_tpu_torch.ops.wilson_slab import (
    SlabWilsonDirac,
    field_from_slab,
    field_to_slab,
    links_to_slab,
    with_link_dtype,
)
from mgpgcr_tpu_torch.solvers.gcr import GCRSolver, gcr_solve, gcr_solve_eager, gcr_solve_jit
from mgpgcr_tpu_torch.solvers.mg import MGPreconditioner, mg_from_numpy, setup_mg
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors
from mgpgcr_tpu_torch.solvers.result import SolveResult

__all__ = [
    "cplx",
    "fields",
    "LatticeMesh",
    "BlockMap",
    "DenseOperator",
    "DiracOperator",
    "CudaWilsonDirac",
    "SlabWilsonDirac",
    "links_from_numpy",
    "field_from_numpy",
    "field_to_numpy",
    "field_to_slab",
    "field_from_slab",
    "links_to_slab",
    "with_link_dtype",
    "GCRParams",
    "MGParams",
    "GCRSolver",
    "SolveResult",
    "gcr_solve",
    "gcr_solve_eager",
    "gcr_solve_jit",
    "MGPreconditioner",
    "setup_mg",
    "mg_from_numpy",
    "inverse_power_vectors",
]
