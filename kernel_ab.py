#!/usr/bin/env python3
"""A/B timing of the port's redesigned kernels across checkouts, on one GPU.

For each checkout given, in the turns A, B, B, A (``--rounds`` times), one
fresh process imports that checkout's ``mgpgcr_tpu_torch`` and times, at
``chip_smoke.py``'s shapes, each kernel through its wrapper two ways: CUDA
events around 20 wrapper calls (``chip_smoke.cuda_ms``, the wrapper's host
work inside the window) and a CUDA graph of the calls replayed between
events (``chip_smoke.graph_ms``, the host outside it). Kernels: B12
``stencil_spmv`` at the config of record's coarse level (8^4 blocks, ne 20,
f32 and bf16 blocks) and the three-level grids (4^4 and 2^4, ne 12); K2
``gcr_stream_step`` and B9 ``gcr_z_step`` at 32^4 (mean over lim 1-5,
two-row f32 links); K1 ``dslash_apply`` at 32^4 as the control; B14
``dslash_dist`` and B15 ``gcr_stream_step_dist`` on a 16x16x32x32 shard with
z split (ghosts of the right shapes, random values). The links are the
tiled ``data/links_16_b6.0_s0.npz`` field; everything else is seeded.

Run: ``python3 kernel_ab.py PARENT_CHECKOUT . [--rounds 1]`` (each checkout
builds its own kernels at first use). Prints the card line, one JSON line
per process and one summary line per kernel: ms per call by checkout, in
the order the processes ran.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def worker(tree: Path) -> dict:
    # this checkout's helpers and shapes
    from chip_smoke import K, RESTART as S, ROOT, SPMV_SHAPES, cuda_ms, graph_ms

    sys.path.insert(0, str(tree))
    import math

    import numpy as np
    import torch

    import mgpgcr_tpu_torch
    from mgpgcr_tpu_torch import LatticeMesh, cplx, links_from_numpy
    from mgpgcr_tpu_torch.kernels.dslash import dslash_apply
    from mgpgcr_tpu_torch.kernels.dslash_dist import Ghosts, dslash_dist
    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_z_step
    from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import gcr_stream_step_dist
    from mgpgcr_tpu_torch.kernels.spmv import stencil_spmv

    if not Path(mgpgcr_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {mgpgcr_tpu_torch.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}

    def both(name, fn, calls=1):
        out[name] = {"events_ms": cuda_ms(fn) / calls, "graph_ms": graph_ms(fn, calls=calls)}

    for name, (dims, ne) in SPMV_SHAPES.items():
        nb = math.prod(dims)
        blocks = cplx.random(gen, (nb, 2 * len(dims) + 1, ne, ne), torch.float32, dev)
        x = cplx.random(gen, (nb * ne,), torch.float32, dev)
        for bname, bl in (("f32", blocks), ("bf16", blocks.astype(torch.bfloat16))):
            both(f"stencil_spmv/{name}/{bname}", lambda: stencil_spmv(bl, x, dims))
        del blocks, x, bl

    with np.load(ROOT / "data" / "links_16_b6.0_s0.npz") as f:
        canon = (np.tile(f["re"], (1, 2, 2, 2, 2, 1, 1)), np.tile(f["im"], (1, 2, 2, 2, 2, 1, 1)))
    mesh = LatticeMesh((32, 32, 32, 32, 4, 3))
    links = links_from_numpy(canon, mesh, dev, compress=True)
    shape = (4, 3, 32, 32, 32 * 32)
    psi, r, z = (cplx.random(gen, shape, torch.float32, dev) for _ in range(3))
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    kt = torch.tensor(K, dtype=torch.complex64, device=dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    both("dslash_apply", lambda: dslash_apply(links, psi, mesh, kt, True))
    both("gcr_stream_step", lambda: [gcr_stream_step(links, r, aps, alpha, kt, lim, mesh, True)
                                     for lim in range(1, S + 1)], S)
    both("gcr_z_step", lambda: [gcr_z_step(links, z, r, aps, kt, lim, mesh, True)
                                for lim in range(1, S + 1)], S)
    del links, psi, r, z, aps

    # rank 0's shard of the (2, 2) grid: t and z halved
    lm = LatticeMesh((16, 16, 32, 32, 4, 3))
    half = tuple(c[:, :16, :16, :32, :32] for c in canon)
    sl = links_from_numpy(half, lm, dev, compress=True)
    t, zz, v = 16, 16, 32 * 32
    fshape = (4, 3, t, zz, v)
    psi, r = (cplx.random(gen, fshape, torch.float32, dev) for _ in range(2))
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    g = Ghosts(tp=cplx.random(gen, (4, 3, 1, zz, v), torch.float32, dev),
               tm=cplx.random(gen, (4, 3, 1, zz, v), torch.float32, dev),
               ut=cplx.random(gen, (1, 1, 2, 3, zz, v), torch.float32, dev),
               zp=cplx.random(gen, (4, 3, t, 1, v), torch.float32, dev),
               zm=cplx.random(gen, (4, 3, t, 1, v), torch.float32, dev),
               uz=cplx.random(gen, (t, 1, 2, 3, 1, v), torch.float32, dev))
    both("dslash_dist", lambda: dslash_dist(sl, psi, lm, g, kt))
    both("gcr_stream_step_dist",
         lambda: [gcr_stream_step_dist(sl, r, aps, alpha, kt, lim, lm, g)
                  for lim in range(1, S + 1)], S)
    torch.cuda.synchronize()
    return {"tree": str(tree), "kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    if args.worker:
        print(json.dumps(worker(trees[0])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA device; none is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1]
    rows = []
    for t in order:
        out = subprocess.run([sys.executable, __file__, str(t), "--worker"],
                             capture_output=True, text=True, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    for name in rows[0]["kernels"]:
        summary = {"summary": name, "card": card}
        for t in trees:
            rs = [r["kernels"][name] for r in rows if r["tree"] == str(t)]
            summary[str(t)] = {k: [r[k] for r in rs] for k in ("graph_ms", "events_ms")}
            summary[str(t)]["median_graph_ms"] = statistics.median(r["graph_ms"] for r in rs)
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
