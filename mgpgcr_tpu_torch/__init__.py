"""mgpgcr_tpu_torch: the PyTorch + CUDA port of ``mgpgcr_tpu``.

Fields are split re/im ``cplx.CF`` pairs in the slab layout
``(4, 3, T, Z, Y*X)``; the Wilson--Dirac operator ``A = I - kD`` runs on
hand-written CUDA kernels for Hopper (``csrc/``, built by one ``nvcc`` call
at first use and bound with ``ctypes``), and flexible GCR runs either as
the generic loop or through the kernels, in the restart-cycle form or the
loop form on direction stacks (and as the host-driven ``gcr_solve_eager``),
plain or with the multigrid preconditioner (``setup_mg``: any number of
levels, dense, block-ELL or block-stencil coarse operators), on one card or
domain-decomposed over (t, z) shards (``gcr_solve_sharded`` per rank,
``gcr_solve_grid`` for every rank of a grid in one process; ranks as
threads or as ``torch.distributed`` processes, ``parallel/``). Around the
solve: mixed-precision refinement to complex128 residuals
(``refined_solve``, ``wilson_refined_solve``), low eigenpairs
(``smallest_eigenpairs``), the even-odd Schur solve, plain or with MG on
the half mesh (``EvenOddWilson``, ``eo_solve``, ``setup_eo_mg``), the
quenched heat-bath generator (``gauge.thermalized_links``), and matrix
ingestion (``io/``, ``CSRMatrix``, ``detect_wilson``,
``wilson_operator_from_csr``). The decomposed paths: the sharded MG setup
and the distributed MG-preconditioned solve (``setup_mg_sharded``,
``mg_gcr_solve_sharded``, ``mg_gcr_solve_grid``) and the sharded even-odd
solve (``eo_sharded``, ``eo_solve_grid``). The driver: run configs
(``config.py``), MG checkpoints (``save_mg_setup`` / ``load_mg_setup`` and
their sharded forms, the JAX package's file format), run logs, traces and
profiling (``utils/``), and the command line ``python -m mgpgcr_tpu_torch``.
Entry points run on CUDA unless the caller passes ``device="cpu"``; CPU
tensors take each kernel's plain PyTorch version. The JAX package
``mgpgcr_tpu`` is the reference this package is held against.
"""

from mgpgcr_tpu_torch import cplx, fields, gauge
from mgpgcr_tpu_torch.config import ProblemConfig, RunConfig, load_config, save_config
from mgpgcr_tpu_torch.io.checkpoint import (
    load_mg_setup,
    load_mg_setup_sharded,
    save_mg_setup,
    save_mg_setup_sharded,
)
from mgpgcr_tpu_torch.gauge import thermalized_links, thermalized_links_cf
from mgpgcr_tpu_torch.mesh import BlockMap, LatticeMesh
from mgpgcr_tpu_torch.ops.base import FunctionOperator
from mgpgcr_tpu_torch.ops.blockstencil import StencilBlockOperator
from mgpgcr_tpu_torch.ops.bsr import BlockSparseOperator
from mgpgcr_tpu_torch.ops.coo import COOMatrix
from mgpgcr_tpu_torch.ops.csr import CSRMatrix
from mgpgcr_tpu_torch.ops.dense import DenseOperator
from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash_dist import ShardLocalWilsonDirac
from mgpgcr_tpu_torch.ops.dslash import (
    CudaWilsonDirac,
    field_from_numpy,
    field_to_numpy,
    links_from_numpy,
)
from mgpgcr_tpu_torch.ops.ell import ELLOperator
from mgpgcr_tpu_torch.ops.eo import (
    EvenOddWilson,
    SchurDirac,
    field_from_eo,
    field_to_eo,
    make_schur,
)
from mgpgcr_tpu_torch.ops.ingest import (
    SpinConjugatedOperator,
    WilsonDetection,
    detect_wilson,
    wilson_operator_from_csr,
)
from mgpgcr_tpu_torch.ops.wilson import WilsonDiracOperator, materialize_csr, materialize_ell
from mgpgcr_tpu_torch.ops.wilson_slab import (
    SlabWilsonDirac,
    field_from_slab,
    field_to_slab,
    links_to_slab,
    with_link_dtype,
)
from mgpgcr_tpu_torch.parallel import (
    ShardedWilsonDirac,
    ShardGrid,
    ThreadComm,
    TorchDistComm,
    gather_field,
    init_distributed,
    make_shard_grid,
    run_spmd,
    shard_field,
)
from mgpgcr_tpu_torch.solvers.eigen import EigenResult, smallest_eigenpairs
from mgpgcr_tpu_torch.solvers.eo import (
    eo_field_sharding,
    eo_half_mesh,
    eo_mg_params,
    eo_sharded,
    eo_solve,
    eo_solve_grid,
    setup_eo_mg,
)
from mgpgcr_tpu_torch.solvers.gcr import GCRSolver, gcr_solve, gcr_solve_eager, gcr_solve_jit
from mgpgcr_tpu_torch.solvers.gcr_dist import gcr_solve_grid, gcr_solve_sharded
from mgpgcr_tpu_torch.solvers.mg import (
    MGPreconditioner,
    coarse_cycle_counts,
    mg_from_numpy,
    reset_coarse_cycle_counts,
    reset_smoother_counts,
    setup_mg,
    setup_mg_from,
    smoother_counts,
)
from mgpgcr_tpu_torch.solvers.mg_dist import (
    ShardedMGPreconditioner,
    ShardLocalCoarseStencil,
    mg_gcr_solve_grid,
    mg_gcr_solve_sharded,
    setup_mg_sharded,
)
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors
from mgpgcr_tpu_torch.solvers.refine import (
    RefineResult,
    refined_solve,
    wilson_apply_hi,
    wilson_refined_solve,
)
from mgpgcr_tpu_torch.solvers.result import SolveResult

__all__ = [
    "cplx",
    "fields",
    "LatticeMesh",
    "BlockMap",
    "DenseOperator",
    "BlockSparseOperator",
    "StencilBlockOperator",
    "FunctionOperator",
    "WilsonDiracOperator",
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
    "coarse_cycle_counts",
    "reset_coarse_cycle_counts",
    "smoother_counts",
    "reset_smoother_counts",
    "setup_mg",
    "setup_mg_from",
    "mg_from_numpy",
    "inverse_power_vectors",
    "ShardLocalWilsonDirac",
    "ShardedWilsonDirac",
    "ShardGrid",
    "ThreadComm",
    "TorchDistComm",
    "gather_field",
    "init_distributed",
    "make_shard_grid",
    "run_spmd",
    "shard_field",
    "gcr_solve_sharded",
    "gcr_solve_grid",
    "RefineResult",
    "refined_solve",
    "wilson_refined_solve",
    "wilson_apply_hi",
    "EigenResult",
    "smallest_eigenpairs",
    "EvenOddWilson",
    "SchurDirac",
    "make_schur",
    "field_to_eo",
    "field_from_eo",
    "eo_solve",
    "eo_half_mesh",
    "eo_mg_params",
    "setup_eo_mg",
    "eo_sharded",
    "eo_field_sharding",
    "eo_solve_grid",
    "ShardedMGPreconditioner",
    "ShardLocalCoarseStencil",
    "setup_mg_sharded",
    "mg_gcr_solve_sharded",
    "mg_gcr_solve_grid",
    "ProblemConfig",
    "RunConfig",
    "load_config",
    "save_config",
    "save_mg_setup",
    "load_mg_setup",
    "save_mg_setup_sharded",
    "load_mg_setup_sharded",
    "gauge",
    "thermalized_links",
    "thermalized_links_cf",
    "CSRMatrix",
    "COOMatrix",
    "ELLOperator",
    "materialize_csr",
    "materialize_ell",
    "WilsonDetection",
    "SpinConjugatedOperator",
    "detect_wilson",
    "wilson_operator_from_csr",
]
