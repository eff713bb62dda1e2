"""One V-cycle of the timed path against ``reference/vcycle.py``, at a
smoothed-MG cell's size, on the card; and the program's counters over
one window solve.

    python3 -m portbench.vcycle_compare --workload <cell> --seed <n>

The cell is set up as a run sets it up (its field, its hierarchy, the
warm-up solve), then one more source is solved as in the window, keeping
the residuals handed to the preconditioner at the outer iterations
``AT``. Each is applied again by the cell's hierarchy (the coarse GCR
replayed from its CUDA graphs) and by the float64 reference on the same
links and basis, the reference's coarse GCR stopped at the iteration
count the program's took. Two controls are applied to the same residual
and held to the same reference: the smoother on bfloat16 links, and the
post-smooth left out. Prints one JSON line for the solve (outer
iterations, preconditioner applies, ``smoother_counts()``,
``coarse_cycle_counts()``) and one per residual: the relative difference
||y - y_ref|| / ||y_ref|| of the program and of each control. A cell
whose V-cycle has no smoother gets the first line only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from portbench import harness, sources
from portbench.reference import vcycle

AT = (0, 10, 40)  # outer iterations whose residuals are compared


def _lattice(cf, dims):
    return sources.slab_to_lattice(cf.re, cf.im, dims)


def _rel(y, ref, dims) -> float:
    return float(torch.linalg.vector_norm(_lattice(y, dims) - ref) / torch.linalg.vector_norm(ref))


def compare(spec: dict, seed: int, device, at) -> list[dict]:
    """The lines the command prints, for the cell ``spec`` on ``device``."""
    import mgpgcr_tpu_torch as P

    cfg, mgc = spec["config"], spec["config"]["mg"]
    kept, calls, coarse_iters = {}, [0], []

    def keep(apply):
        def wrapped(r):
            if calls[0] in at:
                kept[calls[0]] = P.cplx.CF(r.re.clone(), r.im.clone())
            calls[0] += 1
            return apply(r)

        return wrapped

    cell = harness.Cell(spec, seed, device=device, precond=keep)
    kept.clear()
    calls[0] = 0
    P.reset_smoother_counts()
    P.reset_coarse_cycle_counts()
    _, info = cell._solve(cell._source(cell.gen, 0, None))
    coarse = P.coarse_cycle_counts()
    smooth = mgc["smoother_gcr"]
    lines = [{"outer_iters": info["iters"], "applies": calls[0], "smoother": P.smoother_counts(),
              "smoother_iters_reckoned": calls[0] * 2 * (smooth or {"max_iter": 0})["max_iter"],
              "coarse_cycles": coarse,
              "replayed_share": coarse["replays"] / (coarse["replays"] + coarse["eager_cycles"])}]
    if smooth is None:
        return lines

    mgp, dims, k = cell.mgp, cell.prog.dims, cell.k
    solve = mgp.coarse_solve.solve

    def counted(*a, **kw):  # the coarse GCR's iteration count, read after it
        state = solve(*a, **kw)
        coarse_iters.append(int(state["it"]))
        return state

    mgp.coarse_solve.solve = counted
    controls = {
        "bf16_smoother_links": dataclasses.replace(
            mgp, a_smooth=P.DiracOperator(P.with_link_dtype(mgp.a.d, torch.bfloat16), k)),
        "no_post_smooth": dataclasses.replace(
            mgp, params=dataclasses.replace(mgp.params, n_post_smooth=0)),
    }
    links = torch.complex(cell.base[0].double(), cell.base[1].double())
    basis = torch.stack([sources.slab_to_lattice(mgp.q_field.re[e], mgp.q_field.im[e], dims)
                         for e in range(mgp.q_field.shape[0])])
    transfer = vcycle.Transfer(basis, int(mgc["block"]))
    del basis
    for i in sorted(kept):
        r = kept[i]
        y = mgp.apply(r)
        ref = vcycle.vcycle(links, k, transfer, _lattice(r, dims), coarse_iters[-1],
                            int(mgc["coarse_gcr"]["restart"]), int(smooth["max_iter"]),
                            int(smooth["restart"]),
                            antiperiodic_t=cfg["boundary_t"] == "antiperiodic")
        line = {"outer_iteration": i, "coarse_iters": coarse_iters[-1],
                "program": _rel(y, ref, dims)}
        for name, m in controls.items():
            line[name] = _rel(m.apply(r), ref, dims)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vcycle_compare: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    for line in compare(spec, args.seed, "cuda", AT):
        print(json.dumps({"cell": args.workload, "seed": args.seed, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
