"""Profiling: ``torch.profiler`` phase labels and a roofline model.

Counterpart of ``mgpgcr_tpu/utils/profiling.py``:

- ``annotate("phase")`` labels a host phase (``torch.profiler.
  record_function``); it shows on the timeline of any enclosing capture
  and costs next to nothing otherwise;
- ``trace(logdir)`` captures the host and the card (CPU and CUDA
  activities) over the block and writes a Chrome trace to
  ``logdir/trace.json``;
- ``roofline(...)`` pairs an analytic byte and flop count of a call with
  its measured seconds: achieved GB/s, Gflop/s, Gnnz/s and the share of
  the card's memory rate. The byte and flop models are the JAX package's.

The rates are the NVIDIA H100's data-sheet peaks (SXM part, at its full
700 W power limit), matched on ``torch.cuda.get_device_name``: 3.35e12 B/s
of HBM and 67e12 f32 flop/s outside the tensor cores. A card set below
700 W reaches less. The CPU takes a nominal 5e10 B/s; a card not in the
table has no rates, and its rooflines carry no share of the memory rate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator

import torch

from mgpgcr_tpu_torch import cplx

# HBM bytes/s and peak f32 flop/s by device-name substring
HBM_BW = {
    "h100": 3.35e12,
    "cpu": 5.0e10,
}
F32_FLOPS = {
    "h100": 67e12,
}


def _kind(device=None) -> str:
    dev = cplx.resolve_device(device)
    return torch.cuda.get_device_name(dev).lower() if dev.type == "cuda" else "cpu"


def chip_bandwidth(device=None) -> float | None:
    """HBM bytes/s of ``device`` (CUDA unless named); None where the card
    is not in the table."""
    kind = _kind(device)
    if kind == "cpu":
        return HBM_BW["cpu"]
    return next((bw for key, bw in HBM_BW.items() if key != "cpu" and key in kind), None)


def chip_flops(device=None) -> float | None:
    """Peak f32 flop/s of ``device`` (CUDA unless named); None where the
    card is not in the table."""
    kind = _kind(device)
    return next((f for key, f in F32_FLOPS.items() if key in kind), None)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a host-side phase on the profiler timeline. Safe without an
    active trace; safe on the CPU."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    card when there is one) into ``logdir/trace.json`` (Chrome trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Analytic cost of one kernel invocation + achieved rates."""

    name: str
    bytes_moved: int
    flops: int
    nnz: int
    seconds: float
    bandwidth: float | None  # device HBM bytes/s used for fractions; None if unknown

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def gflops_per_s(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def vs_hbm_roofline(self) -> float | None:
        """Fraction of the bandwidth-bound speed of light achieved; None
        where the device's rate is unknown."""
        if self.bandwidth is None:
            return None
        return self.bytes_moved / self.bandwidth / self.seconds

    def asdict(self) -> dict:
        return {
            "kernel": self.name,
            "bytes": self.bytes_moved,
            "flops": self.flops,
            "nnz": self.nnz,
            "seconds": round(self.seconds, 9),
            "gbytes_per_s": round(self.gbytes_per_s, 2),
            "gflops_per_s": round(self.gflops_per_s, 2),
            "gnnz_per_s": round(self.gnnz_per_s, 3),
            "vs_hbm_roofline": None if self.bandwidth is None else round(self.vs_hbm_roofline, 4),
        }


def roofline(
    name: str,
    seconds: float,
    bytes_moved: int,
    flops: int = 0,
    nnz: int = 0,
    device=None,
) -> Roofline:
    return Roofline(
        name, int(bytes_moved), int(flops), int(nnz), seconds, chip_bandwidth(device)
    )


def dslash_roofline(
    mesh,
    seconds: float,
    field_itemsize: int = 4,
    link_itemsize: int = 4,
    device=None,
) -> Roofline:
    """Roofline for one Wilson-Dirac hopping application on ``mesh``.

    Minimal HBM traffic per site (complex elements): 4x9 links at
    ``link_itemsize`` per real part, 12 field reads + 12 writes at
    ``field_itemsize``. Flops: 8 directions x (half-spinor project 12 +
    SU(3) 2x3x3 cmul-adds 132 + reconstruct 12) ~= 1320 real flops/site.
    nnz: the fixture-equivalent 39 nnz/row x 12 rows.
    """
    v = mesh.n_sites
    bytes_moved = v * (
        4 * 9 * 2 * link_itemsize + (12 + 12) * 2 * field_itemsize
    )
    return roofline(
        "wilson_dslash",
        seconds,
        bytes_moved,
        flops=1320 * v,
        nnz=39 * 12 * v,
        device=device,
    )


def gcr_iteration_roofline(
    mesh,
    seconds: float,
    restart: int,
    field_itemsize: int = 4,
    device=None,
) -> Roofline:
    """Roofline for one fused-GCR iteration's FIELD ALGEBRA (excluding the
    operator apply): the x, r, p, Ap updates stream 2 reads + 2 writes +
    2 reads; the beta dots the S-slot Ap stack + Az; the direction update
    the stacks again plus z, Az, r. Per complex element of the field
    (size n = 12 V), with S slots: ~ (6 + (S+1) + (2S+3)) = 3S + 10
    element moves."""
    v = mesh.n_sites
    n = 12 * v
    moves = (3 * restart + 10) * n
    return roofline(
        "gcr_iteration_algebra",
        seconds,
        moves * 2 * field_itemsize,
        flops=(8 * restart + 16) * n,
        device=device,
    )
