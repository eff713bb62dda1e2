"""The lower-precision controls and the planted faults that ``correct``
must catch, and the study that reads them on the chip.

Controls, one step below the precision each configuration states:
- the f32 cells: the program's own bfloat16 link storage (its
  ``link_dtype`` option), everything else as configured;
- the refinement cell: its complex128 residual operator replaced by the
  reference's operator in complex64.
Faults, planted under the timed path: a solve that returns its start
(x = 0) unchanged; half the right-hand sides left unsolved (every other
solve returns 0); a solution altered where it is produced (one site of x
shifted by a thousandth of its norm). A one-chip cell has no exchange
between chips to leave out. In the MG cells besides: the preconditioner
left out (M = I, as with the coarse solve off), and the null-vector setup
left out (the hierarchy built on random vectors).

    python3 -m portbench.controls --workload <cell> --seconds <s> \
        --seeds <n,...> --control-seeds <n,...> [--faults <all|name,...>] \
        [--fault-seeds <n,...>]

prints one JSON line per run: the worst residual, the most outer
iterations, the judged count and the solves, for the program, the
control and each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import harness, sources
from portbench.reference import wilson


def c64_apply_hi(dims, k: float, antiperiodic: bool):
    """A factory of refinement residual operators: the reference's A in
    complex64 on flat canonical complex128 fields."""

    def make(links):
        u = torch.complex(links[0], links[1]).to(torch.complex64)

        def apply_hi(x):
            y = wilson.dirac(u, sources.flat_to_lattice(x, dims).to(torch.complex64), k,
                             antiperiodic)
            return sources.lattice_to_flat(y).to(torch.complex128)

        return apply_hi

    return make


def control_kwargs(spec: dict) -> dict:
    cfg, tr = spec["config"], spec["traffic"]
    if tr.get("refine_tol") is not None:
        return {"apply_hi": c64_apply_hi(tuple(cfg["lattice"]), float(tr["k"]),
                                         cfg["boundary_t"] == "antiperiodic")}
    return {"link_dtype": "bfloat16"}


def _zero(x):
    if hasattr(x, "re"):
        return type(x)(torch.zeros_like(x.re), torch.zeros_like(x.im))
    return x * 0


def fault_unchanged(b, x):
    return _zero(x)


def fault_half():
    calls = [0]

    def fault(b, x):
        calls[0] += 1
        return _zero(x) if calls[0] % 2 == 0 else x

    return fault


def fault_altered(b, x):
    if hasattr(x, "re"):
        re = x.re.clone()
        re.view(-1)[0] += 1e-3 * float(torch.sqrt((x.re ** 2 + x.im ** 2).sum()))
        return type(x)(re, x.im)
    y = x.copy()
    y[0] += 1e-3 * float((abs(x) ** 2).sum() ** 0.5)
    return y


def precond_off(apply):
    """The preconditioner left out: M = I."""
    return lambda r: r


@contextlib.contextmanager
def random_null_vectors():
    """The null-vector setup left out: the program's hierarchy is built on
    its random start vector and n - 1 more random vectors."""
    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.solvers import mg

    real = mg.inverse_power_vectors

    def planted(a, b0, n_vecs, params, n_power_iters=10, comm=None):
        gen = torch.Generator(device=b0.re.device).manual_seed(0x5EED)

        def draw():
            return torch.randn(b0.re.shape, generator=gen, dtype=b0.re.dtype,
                               device=b0.re.device)

        return cplx.stack([b0] + [cplx.CF(draw(), draw()) for _ in range(n_vecs - 1)])

    mg.inverse_power_vectors = planted
    try:
        yield
    finally:
        mg.inverse_power_vectors = real


FAULTS = {"unchanged": lambda: {"fault": fault_unchanged},
          "half": lambda: {"fault": fault_half()},
          "altered": lambda: {"fault": fault_altered}}
MG_FAULTS = {"precond_off": lambda: {"precond": precond_off},
             "random_null_vectors": lambda: {"patch": random_null_vectors()}}


def faults(spec: dict) -> dict:
    """The faults a cell can have, each a maker of ``one``'s keywords."""
    return {**FAULTS, **(MG_FAULTS if "mg" in spec["config"] else {})}


def one(spec, seed: int, seconds: float, device, patch=None, **kw) -> dict:
    t = time.perf_counter()
    with patch if patch is not None else contextlib.nullcontext():
        cell = harness.Cell(spec, seed, device=device, **kw)
        cell.window(seconds)
    cell.release()
    cell.judge()
    r = cell.run
    return {"seed": seed, "correct": r.correct, "relres_max": r.checks["relres_max"]["value"],
            "outer_iters_max": max(s["iters"] for s in r.solves), "judged": r.n_judged,
            "solves": len(r.solves), "iters": [s["iters"] for s in r.solves],
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="'all' or fault names, comma-separated")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    for s in seeds:
        print(json.dumps({"cell": args.workload, "side": "program",
                          **one(spec, s, args.seconds, "cuda")}), flush=True)
    for s in cseeds:
        print(json.dumps({"cell": args.workload, "side": "control",
                          **one(spec, s, args.seconds, "cuda", **control_kwargs(spec))}),
              flush=True)
    if args.faults:
        fseeds = [int(s) for s in args.fault_seeds.split(",") if s] or (cseeds or seeds)[:1]
        chosen = faults(spec)
        if args.faults != "all":
            chosen = {n: chosen[n] for n in args.faults.split(",")}
        for name, make in chosen.items():
            for s in fseeds:
                print(json.dumps({"cell": args.workload, "side": f"fault.{name}",
                                  **one(spec, s, args.seconds, "cuda", **make())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
