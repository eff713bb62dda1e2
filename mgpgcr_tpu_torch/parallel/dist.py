"""Multi-process runtime wiring through ``torch.distributed``.

Counterpart of ``mgpgcr_tpu/parallel/dist.py``. Every process runs the
same program, joins one process group, and drives its rank of a
``ShardGrid`` through ``parallel/comm.py::TorchDistComm``: NCCL when the
ranks hold CUDA tensors, gloo when they hold CPU tensors. Nothing is
staged through the host, and NCCL is never replaced by gloo for CUDA
tensors: a missing backend is an error.

Launch contract, in the order it is resolved:

- explicit arguments to :func:`init_distributed`;
- the ``MGPGCR_COORDINATOR`` (``host:port``, or any ``tcp://`` /
  ``file://`` init method), ``MGPGCR_NUM_PROCESSES`` and
  ``MGPGCR_PROCESS_ID`` environment variables;
- otherwise one process, and nothing is initialised.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from mgpgcr_tpu_torch import cplx

_ENV_COORD = "MGPGCR_COORDINATOR"
_ENV_NPROC = "MGPGCR_NUM_PROCESSES"
_ENV_PID = "MGPGCR_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Resolved multi-process topology of the current run."""

    coordinator: Optional[str]
    num_processes: int
    process_id: int

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def config_from_env() -> Optional[DistConfig]:
    """Read an explicit multi-process topology from MGPGCR_* env vars.
    Returns None when unset."""
    coord = os.environ.get(_ENV_COORD)
    nproc = os.environ.get(_ENV_NPROC)
    pid = os.environ.get(_ENV_PID)
    if coord is None and nproc is None and pid is None:
        return None
    if not (coord and nproc is not None and pid is not None):
        raise ValueError(
            f"partial multi-process env: need all of {_ENV_COORD}, "
            f"{_ENV_NPROC}, {_ENV_PID} (got coord={coord!r}, "
            f"nproc={nproc!r}, pid={pid!r})"
        )
    return DistConfig(coord, int(nproc), int(pid))


def backend_for(device) -> str:
    """The process-group backend for tensors on ``device`` (CUDA unless
    named): NCCL for CUDA, gloo for the CPU; raises when it is missing."""
    import torch.distributed as dist

    dev = cplx.resolve_device(device)
    name = "nccl" if dev.type == "cuda" else "gloo"
    ok = dist.is_available() and (
        dist.is_nccl_available() if name == "nccl" else dist.is_gloo_available())
    if not ok:
        raise RuntimeError(f"torch.distributed backend {name!r} is not available for {dev}")
    return name


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> DistConfig:
    """Join the process group of this run (idempotent) and return its
    topology; see the module docstring for the resolution order. With
    nothing configured this is a no-op returning a 1-process config."""
    import torch.distributed as dist

    env = config_from_env()
    if coordinator is None and env is not None:
        coordinator = env.coordinator
        num_processes = num_processes or env.num_processes
        process_id = env.process_id if process_id is None else process_id
    if coordinator is None and num_processes is None:
        return DistConfig(None, 1, 0)
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("need a coordinator, the number of processes and this process's id")
    backend = backend_for(device)
    if not dist.is_initialized():
        method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=method, world_size=int(num_processes),
                                rank=int(process_id))
    return DistConfig(coordinator, dist.get_world_size(), dist.get_rank())


def is_coordinator() -> bool:
    """True on the process that should write artifacts / print results."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def process_summary() -> dict:
    """Topology facts for logging: rank, process count, backend, local
    devices and their kind."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "process_id": dist.get_rank() if up else 0,
        "num_processes": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "local_devices": torch.cuda.device_count() if cuda else 0,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
    }
