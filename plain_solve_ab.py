#!/usr/bin/env python3
"""A/B timing of the port's plain fused solve across checkouts, on one GPU.

For each round, and for each checkout given in turn, one fresh process
imports that checkout's ``mgpgcr_tpu_torch`` and times the restart-5 fused
GCR solve of ``chip_smoke.py``'s plain path (32^4, the tiled
``data/links_16_b6.0_s0.npz`` field, two-row f32 links, k = 0.125, tol
1e-6): one warm-up solve, then ``--solves`` timed solves, each as ms per
iteration on the CUDA-synchronised host clock. It also times the host
microseconds per call of the K2 wrapper (``gcr_stream_step``) on a 4^4
lattice, where the device never holds the host back. Processes alternate
A, B, A, B, ... so that drifts of the shared host fall on both alike.

Run: ``python3 plain_solve_ab.py PARENT_CHECKOUT . [--rounds 4] [--solves 10]``
(each checkout builds its own kernels at first use). Prints the card
line, one JSON line per process and a summary line per checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def worker(tree: Path, n_solves: int) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import mgpgcr_tpu_torch
    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, LatticeMesh, cplx, gcr_solve,
    )
    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step

    if not Path(mgpgcr_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {mgpgcr_tpu_torch.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    mesh = LatticeMesh((32, 32, 32, 32, 4, 3))
    with np.load(tree / "data" / "links_16_b6.0_s0.npz") as f:
        reps = (1, 2, 2, 2, 2, 1, 1)
        canon = (np.tile(f["re"], reps), np.tile(f["im"], reps))
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, 0.125)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    params = GCRParams(tol=1e-6, max_iter=500, restart=5, fused=True)
    gcr_solve(a, b, params)
    ms = []
    for _ in range(n_solves):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        res = gcr_solve(a, b, params)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - s0) / res.n_iters)

    small = LatticeMesh((4, 4, 4, 4, 4, 3))
    sop = CudaWilsonDirac.build(tuple(x[:, :4, :4, :4, :4] for x in canon), small,
                                compress=True, antiperiodic_t=True, device=dev)
    r = cplx.random(torch.Generator(device=dev).manual_seed(1), sop.field_shape, torch.float32,
                    dev)
    aps = cplx.stack_zeros(5, r)
    alpha = torch.tensor(0.3, dtype=torch.complex64, device=dev)
    kt = torch.tensor(0.125, dtype=torch.complex64, device=dev)

    def step():
        gcr_stream_step(sop.links, r, aps, alpha, kt, 3, small, anti_t=True)

    for _ in range(100):
        step()
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for _ in range(3000):
        step()
    us = 1e6 * (time.perf_counter() - s0) / 3000
    torch.cuda.synchronize()
    return {"tree": str(tree), "iters": res.n_iters, "ms_per_iter": ms,
            "median_ms_per_iter": statistics.median(ms), "k2_wrapper_host_us": us}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--solves", type=int, default=10)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    if args.worker:
        print(json.dumps(worker(trees[0], args.solves)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("plain_solve_ab.py needs a CUDA device; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = {t: [] for t in trees}
    for _ in range(args.rounds):
        for t in trees:
            out = subprocess.run([sys.executable, __file__, str(t), "--worker", "--solves",
                                  str(args.solves)], capture_output=True, text=True, check=True)
            row = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            rows[t].append(row)
    for t, rs in rows.items():
        meds = [r["median_ms_per_iter"] for r in rs]
        print(json.dumps({"summary": str(t), "card": card, "median_ms_per_iter": meds,
                          "mean_of_medians": statistics.mean(meds),
                          "k2_wrapper_host_us": [r["k2_wrapper_host_us"] for r in rs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
