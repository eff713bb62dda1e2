"""One cell of the benchmark: set-up, the measured window, the traced
segment and the judgement.

The program under test is ``mgpgcr_tpu_torch`` (imported here and
nowhere in ``reference/``). A cell is a configuration file
(``configs/<config>.json``: lattice, gauge field, operator and solver
settings) under a traffic file (``traffic/<cell>.json``: k, tolerance,
sources, configurations per window, refinement, the judged sample and
the limit). The window is a closed loop with one client: one right-hand
side at a time, the next handed over once the previous solution is back
and synchronised; it ends at the first unit boundary past ``seconds``
(a solve, or with a pool of gauge configurations one configuration's
operator build, MG setup and columns). The judgement recomputes, in
float64 with ``reference/wilson.py``, the residual of a seeded sample of
the window's solutions, the solve of most iterations among them; where
the traffic names ``outer_iters_limit`` (the MG cells), it also holds the
most outer iterations of any window solve, which only the preconditioner
keeps down.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import random
import time
from pathlib import Path

import torch

from portbench import sources
from portbench.reference import wilson

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mgpgcr_tpu")
SEED_MASK = (1 << 63) - 1


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------
def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, its
    traffic and the metrics it reports, each read from its own file."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def mine(metric) -> bool:
        return name in metric.get("workloads", [name])

    return {
        "cell": cell, "config": config, "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------
class Program:
    """The calls into ``mgpgcr_tpu_torch`` that a cell makes."""

    def __init__(self, config: dict, traffic: dict, device, link_dtype: str | None = None):
        import mgpgcr_tpu_torch as P

        self.P, self.device = P, torch.device(device)
        self.dims = tuple(config["lattice"])
        self.mesh = P.LatticeMesh((*self.dims, 4, 3))
        self.k = float(traffic["k"])
        self.antiperiodic = config["boundary_t"] == "antiperiodic"
        self.rows = int(config["link_rows"])
        self.link_dtype = getattr(torch, link_dtype or config["link_dtype"])
        g = config["gcr"]
        self.params = P.GCRParams(tol=float(config["tol"]), max_iter=int(g["max_iter"]),
                                  restart=int(g["restart"]), fused=bool(g["fused"]))
        self.mg_params = None
        if "mg" in config:
            m = config["mg"]
            self.mg_params = P.MGParams(
                block=int(m["block"]), n_nullvecs=int(m["n_nullvecs"]),
                setup_gcr=P.GCRParams(**m["setup_gcr"]),
                setup_power_iters=int(m["setup_power_iters"]),
                coarse_gcr=P.GCRParams(**m["coarse_gcr"]),
                smoother_gcr=(None if m["smoother_gcr"] is None
                              else P.GCRParams(**m["smoother_gcr"])),
                coarse_format=m["coarse_format"],
            )

    def cf(self, pair):
        return self.P.cplx.CF(*pair)

    def build(self, links):
        """A = I - kD on canonical (re, im) float32 links."""
        d = self.P.CudaWilsonDirac.build(
            self.cf(links), self.mesh, compress=self.rows == 2, antiperiodic_t=self.antiperiodic,
            link_dtype=self.link_dtype, device=self.device)
        return self.P.DiracOperator(d, self.k)

    def setup_mg(self, a, seed: int, timings: dict | None):
        gen = torch.Generator(device=self.device).manual_seed(seed & SEED_MASK)
        return self.P.setup_mg(gen, a, self.mesh, self.mg_params, timings=timings)

    def solve(self, a, b, precond):
        res = self.P.gcr_solve(a, self.cf(b), self.params, precond=precond)
        return res.x, {"iters": int(res.n_iters), "converged": bool(res.converged)}

    def apply_hi(self, links):
        return self.P.wilson_apply_hi(self.cf(links), self.mesh, self.k,
                                      antiperiodic=self.antiperiodic, device=self.device)

    def refine(self, a, b_flat, apply_hi, tol: float, precond=None):
        res = self.P.wilson_refined_solve(a, self.mesh, b_flat, self.params, apply_hi,
                                          precond=precond, tol=tol)
        return res.x, {"iters": res.total_inner_iters, "rounds": int(res.n_refine),
                       "converged": bool(res.converged)}

    def launches(self) -> dict:
        from mgpgcr_tpu_torch.kernels import launch_counts

        return dict(launch_counts())


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    cell: dict
    config: dict
    traffic: dict
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    solves: list = dataclasses.field(default_factory=list)  # per solve: ms, iters, ...
    setups: list = dataclasses.field(default_factory=list)  # setup_mg timings per configuration
    vcycle_s: list = dataclasses.field(default_factory=list)  # synchronised precond spans
    trace: object = None  # trace.Trace of the traced segment
    traced_solves: list = dataclasses.field(default_factory=list)
    traced_launches: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    setup_phases: dict = dataclasses.field(default_factory=dict)  # seconds of each set-up step
    checks: dict = dataclasses.field(default_factory=dict)
    n_judged: int = 0
    correct: bool = False

    @property
    def dims(self):
        return tuple(self.config["lattice"])

    @property
    def solved(self) -> int:
        """Solves reported converged, less those the judgement found over
        its limit."""
        return sum(1 for s in self.solves if s["converged"] and s.get("judged_ok", True))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function("portbench." + name)


class Cell:
    """Set-up of one cell on ``device``, then ``window``, ``traced`` and
    ``judge``. ``link_dtype`` and ``apply_hi`` replace the configuration's
    link storage and the refinement's residual operator (the controls),
    ``fault`` wraps the solve and ``precond`` the preconditioner's apply
    (the fault tests)."""

    def __init__(self, spec: dict, seed: int, device="cuda", root: Path = ROOT,
                 link_dtype: str | None = None, apply_hi=None, fault=None, precond=None):
        self.run = Run(spec["cell"], spec["config"], spec["traffic"], torch.device(device))
        cfg, tr = spec["config"], spec["traffic"]
        self.dev = torch.device(device)
        self.prog = Program(cfg, tr, self.dev, link_dtype)
        self.seed = seed & SEED_MASK
        self.rng = random.Random(self.seed)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        self.fault, self.precond_fault = fault, precond
        self.k, self.tol_hi = float(tr["k"]), tr.get("refine_tol")
        phases, clock = self.run.setup_phases, [time.perf_counter()]

        def phase(name):
            _sync(self.dev)
            now = time.perf_counter()
            phases[name] = now - clock[0]
            clock[0] = now

        self.base = sources.load_links(cfg["field"], self.prog.dims, root, self.dev, self.seed)
        phase("field")
        n_pool = int(tr.get("configurations", 0))
        self.pool = [sources.gauge_transform(self.base, self.gen) for _ in range(n_pool)]
        phase("pool")
        self.sample_size = int(tr["judge_sample"])
        self.sample, self.longest, self.n_seen = [], None, 0
        self._apply_hi_override = apply_hi
        self.a = self.mgp = self.apply_hi = None
        # warm-up: build, set up and solve once, as a unit of the window does
        self._prepare(self.base, self._setup_seed())
        phase("operator_and_mg_setup")
        warm = torch.Generator(device=self.dev).manual_seed(self.seed ^ 0x5EED)
        b = self._source(warm, 0, (0,) * len(self.prog.dims))
        self._solve(b)
        phase("warm_up_solve")
        if self.pool:
            self.a = self.mgp = None

    # -- pieces -------------------------------------------------------------
    def _setup_seed(self) -> int:
        fixed = self.run.traffic.get("mg_setup_seed")
        return int(fixed) if fixed is not None else self.rng.getrandbits(63)

    def _prepare(self, links, setup_seed: int, spans: bool = False, timed: bool = False):
        self.a = self.mgp = self.apply_hi = None
        with _span("operator", spans):
            self.a = self.prog.build(links)
            if self.tol_hi is not None:
                self.apply_hi = (self._apply_hi_override(links) if self._apply_hi_override
                                 else self.prog.apply_hi(links))
            _sync(self.dev)
        if self.prog.mg_params is not None:
            timings = {} if timed else None
            with _span("mg_setup", spans):
                self.mgp = self.prog.setup_mg(self.a, setup_seed, timings)
                _sync(self.dev)
            if timed:
                self.run.setups.append(timings)

    def _source(self, gen, column: int, site):
        tr = self.run.traffic
        if tr["sources"] == "noise":
            return sources.noise_source(gen, self.prog.dims, self.dev)
        spin, colour = divmod(column, 3)
        return sources.point_source(self.prog.dims, site, spin, colour, self.dev)

    def _precond(self, spans: bool, sync_spans: bool):
        if self.mgp is None:
            return None
        apply = self.mgp.apply if self.precond_fault is None else self.precond_fault(self.mgp.apply)
        if not (spans or sync_spans):
            return apply

        def timed(r):
            with _span("vcycle", spans):
                if sync_spans:
                    _sync(self.dev)
                    t = time.perf_counter()
                y = apply(r)
                if sync_spans:
                    _sync(self.dev)
                    self.run.vcycle_s.append(time.perf_counter() - t)
            return y

        return timed

    def _solve(self, b, spans: bool = False, sync_spans: bool = False):
        """One right-hand side through the program; (x, info)."""
        precond = self._precond(spans, sync_spans)
        if self.tol_hi is not None:
            flat = sources.lattice_to_flat(sources.slab_to_lattice(*b, self.prog.dims))
            x, info = self.prog.refine(self.a, flat, self.apply_hi, float(self.tol_hi), precond)
        else:
            x, info = self.prog.solve(self.a, b, precond)
        if self.fault is not None:
            x = self.fault(b, x)
        return x, info

    def _keep(self, b, x, info, links_index):
        """Reservoir sample of the window's solves, drawn from the seed,
        and the solve of most iterations."""
        item = (b, x, links_index, info)
        self.n_seen += 1
        if len(self.sample) < self.sample_size:
            self.sample.append(item)
        else:
            j = self.rng.randrange(self.n_seen)
            if j < self.sample_size:
                self.sample[j] = item
        if self.longest is None or info["iters"] > self.longest[3]["iters"]:
            self.longest = item

    def _units(self, spans: bool = False, sync_spans: bool = False, timed_setup: bool = True,
               keep: bool = True):
        """Yield after each solve: (solve record, True at a unit boundary)."""
        tr = self.run.traffic
        u = 0
        while True:
            idx = None
            columns, site = int(tr.get("columns", 1)), None
            if self.pool:
                idx = u % len(self.pool)
                self._prepare(self.pool[idx], self._setup_seed(), spans, timed_setup)
                site = tuple(self.rng.randrange(n) for n in self.prog.dims)
            for col in range(columns):
                with _span("source", spans):
                    b = self._source(self.gen, col, site)
                    _sync(self.dev)
                t = time.perf_counter()
                with _span("solve", spans):
                    x, info = self._solve(b, spans, sync_spans)
                    _sync(self.dev)
                info["ms"] = 1e3 * (time.perf_counter() - t)
                if keep:
                    self._keep(b, x, info, idx)
                yield info, col == columns - 1
            u += 1

    # -- the phases ---------------------------------------------------------
    def window(self, seconds: float, sync_spans: bool = False) -> None:
        """The measured window: whole units until ``seconds`` have passed
        and at least the traffic's ``min_units`` are done."""
        _sync(self.dev)
        min_units, units = int(self.run.traffic.get("min_units", 1)), 0
        t0 = time.perf_counter()
        for info, boundary in self._units(sync_spans=sync_spans):
            self.run.solves.append(info)
            units += boundary
            if boundary and units >= min_units and time.perf_counter() - t0 >= seconds:
                break
        self.run.window_s = time.perf_counter() - t0

    def traced(self, n_solves: int) -> None:
        """``n_solves`` more solves of the same traffic under the profiler
        (a configuration's build and MG setup first, where the cell has a
        pool); their solutions are not judged."""
        from torch.profiler import ProfilerActivity, profile

        from portbench import trace

        import warnings

        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        before = self.prog.launches()
        _sync(self.dev)
        prof = profile(activities=acts)
        prof.start()
        with torch.profiler.record_function("portbench.traced"):
            for i, (info, _) in enumerate(self._units(spans=True, timed_setup=False, keep=False)):
                self.run.traced_solves.append(info)
                if i + 1 >= n_solves:
                    break
            _sync(self.dev)
        prof.stop()
        after = self.prog.launches()
        self.run.traced_launches = {k: after[k] - before.get(k, 0) for k in after}
        self.run.trace = trace.collect(prof)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.a = self.mgp = self.apply_hi = None
        self.prog = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> None:
        """The float64 residual of every sampled solution, and in the MG
        cells the most outer iterations of any window solve; ``correct``
        when each is within the traffic's limit. A judged solve over the
        limit does not count as solved."""
        items = list(self.sample)
        if self.longest is not None and all(self.longest is not it for it in items):
            items.append(self.longest)
        dims = tuple(self.run.config["lattice"])
        worst = float("inf") if not items else 0.0
        cache = {}
        limit = float(self.run.traffic["limit"])
        for b, x, idx, info in items:
            if idx not in cache:
                cache.clear()
                re, im = self.base if idx is None else self.pool[idx]
                cache[idx] = torch.complex(re.double(), im.double())
            b_lat = sources.slab_to_lattice(*b, dims)
            if hasattr(x, "re"):  # a slab CF field
                x_lat = sources.slab_to_lattice(x.re, x.im, dims)
            else:  # the refinement's flat complex128 solution
                x_lat = sources.flat_to_lattice(torch.as_tensor(x).to(self.dev), dims)
            rel = wilson.relative_residual(cache[idx], self.k, b_lat, x_lat,
                                           self.run.config["boundary_t"] == "antiperiodic")
            rel = rel if rel == rel else float("inf")
            info["judged_ok"] = rel <= limit
            worst = max(worst, rel)
        worst = worst if math.isfinite(worst) else 1e308  # JSON has no inf
        self.run.n_judged = len(items)
        checks = {"relres_max": {"value": worst, "limit": limit}}
        if self.run.traffic.get("outer_iters_limit") is not None:
            most = max((s["iters"] for s in self.run.solves), default=0)
            checks["outer_iters_max"] = {"value": most,
                                         "limit": int(self.run.traffic["outer_iters_limit"])}
        self.run.checks = checks
        self.run.correct = bool(items) and all(c["value"] <= c["limit"] for c in checks.values())
