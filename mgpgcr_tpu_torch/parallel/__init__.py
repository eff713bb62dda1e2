"""Domain decomposition: a lattice split over (t, z) shards, each driven by
one rank of a ``ShardGrid``.

Counterpart of ``mgpgcr_tpu/parallel``. Where the JAX package runs its
per-shard code inside ``shard_map`` over a device mesh, the port runs it
once per rank against a communicator (``comm.py``): ranks as threads of one
process (``run_spmd``), or one process each under ``torch.distributed``.
"""

from mgpgcr_tpu_torch.parallel.comm import Comm, ThreadComm, TorchDistComm, run_spmd
from mgpgcr_tpu_torch.parallel.dist import (
    DistConfig,
    config_from_env,
    init_distributed,
    is_coordinator,
    process_summary,
)
from mgpgcr_tpu_torch.parallel.halo import periodic_shift
from mgpgcr_tpu_torch.parallel.mesh import (
    ShardGrid,
    balanced_factors,
    gather_field,
    make_shard_grid,
    shard_field,
    shard_links,
)
from mgpgcr_tpu_torch.parallel.wilson import ShardedWilsonDirac

__all__ = [
    "Comm",
    "ThreadComm",
    "TorchDistComm",
    "run_spmd",
    "DistConfig",
    "config_from_env",
    "init_distributed",
    "is_coordinator",
    "process_summary",
    "periodic_shift",
    "ShardGrid",
    "balanced_factors",
    "gather_field",
    "make_shard_grid",
    "shard_field",
    "shard_links",
    "ShardedWilsonDirac",
]
