"""Wrappers of the hand-written CUDA kernels (``csrc/``) with their plain
PyTorch versions. A wrapper launches its kernel for CUDA tensors and runs
the plain version for CPU tensors; ``<wrapper>.launches`` counts the
kernels that ran, whether the wrapper launched them or a CUDA graph
replayed them (``credit_launches``)."""

from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.kernels.coarse_gcr import (
    coarse_gcr_dir,
    coarse_gcr_dots,
    coarse_gcr_start,
    coarse_gcr_update,
)
from mgpgcr_tpu_torch.kernels.dslash import dslash_apply, dslash_mu
from mgpgcr_tpu_torch.kernels.dslash_dist import dslash_dist
from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_z_step
from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import gcr_stream_step_dist
from mgpgcr_tpu_torch.kernels.gcr_kernels import (
    ap_update,
    basis_flush,
    beta_dots,
    dir_update,
    update_r,
    update_xr,
)
from mgpgcr_tpu_torch.kernels.spmv import stencil_spmv
from mgpgcr_tpu_torch.kernels.transfer import prolong, restrict

WRAPPERS = (
    dslash_apply, gcr_stream_step, ap_update, basis_flush, update_r, gcr_z_step, restrict,
    prolong, update_xr, beta_dots, dir_update, stencil_spmv, dslash_mu, dslash_dist,
    gcr_stream_step_dist, coarse_gcr_start, coarse_gcr_dots, coarse_gcr_dir, coarse_gcr_update,
)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def credit_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (wrapper name -> launches) to the wrappers' counts:
    the kernels of a CUDA graph replay, which calls no wrapper, or, negated,
    the launches counted while capturing one, which runs no kernel."""
    for w in WRAPPERS:
        _lib.count(w, counts.get(w.__name__, 0))
