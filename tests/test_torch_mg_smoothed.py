"""The smoothed V-cycle (``solvers/mg.py::MGPreconditioner.apply`` with
the GCR(4) pre- and post-smoother) against the benchmark's plain float64
V-cycle (``portbench/reference/vcycle.py``) on the CPU, 4^4: seeded Haar
links, a seeded hierarchy (block 2, ne 8, block-stencil coarse operator),
k = 0.23, where a coarse iteration more or less still shows. Both sides
fix their coarse iteration count (coarse tol 0, 25 iterations at restart
10, so the last restart cycle is cut) and take the same basis and links.

Planted faults in the program each fail the comparison: a bfloat16
smoother operator, a dropped pre- or post-smooth, and a coarse correction
taken on r instead of r - A x. The program's smoother counters
(``smoother_counts``) and its profiler span ``mg.smooth`` are held to the
work of an apply, and the benchmark's readers of the smoother's kernels
(``portbench/smooth_kernels.py``, ``mg.smooth_share``,
``smooth_iter_roofline``) to a synthetic trace."""

import dataclasses

import pytest
import torch

from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    cplx,
    reset_smoother_counts,
    setup_mg,
    smoother_counts,
    with_link_dtype,
)
from portbench import run as bench_run
from portbench import smooth_kernels, sources
from portbench.reference import roofline, vcycle, wilson
from portbench.trace import Trace

DIMS = (4, 4, 4, 4)
K = 0.23
BLOCK = 2
COARSE = GCRParams(tol=0.0, max_iter=25, restart=10)
# The program computes in float32 (fields, links, every dot), the
# reference in float64: one V-cycle of ~40 operator applications and the
# dots of 33 GCR iterations reads ~1.3e-7 (about 2 float32 roundings).
# 1e-5 leaves 75x room above it and sits 130x under bfloat16 smoother
# links (~2e-3, their 3.9e-3 rounding) and 9x under one coarse
# iteration fewer on the reference side (~9e-5).
TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    u = sources.haar_su3(torch.Generator().manual_seed(161), (4, *DIMS), "cpu")
    re, im = u.real.float(), u.imag.float()
    mesh = LatticeMesh((*DIMS, 4, 3))
    d = CudaWilsonDirac.build(cplx.CF(re, im), mesh, compress=True, antiperiodic_t=True,
                              device="cpu")
    params = MGParams(block=BLOCK, n_nullvecs=4, coarse_format="stencil", coarse_gcr=COARSE)
    mgp = setup_mg(torch.Generator().manual_seed(162), DiracOperator(d, K), mesh, params)
    b = sources.noise_source(torch.Generator().manual_seed(163), DIMS, "cpu")
    q = mgp.q_field
    basis = torch.stack([sources.slab_to_lattice(q.re[e], q.im[e], DIMS)
                         for e in range(q.shape[0])])
    links = torch.complex(re.double(), im.double())
    transfer = vcycle.Transfer(basis, BLOCK)
    r = sources.slab_to_lattice(*b, DIMS)
    ref = vcycle.vcycle(links, K, transfer, r, COARSE.max_iter, COARSE.restart)
    return dict(d=d, mgp=mgp, r=cplx.CF(*b), links=links, transfer=transfer, r_lat=r, ref=ref)


def _rel(y: cplx.CF, ref: torch.Tensor) -> float:
    got = sources.slab_to_lattice(y.re, y.im, DIMS)
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def test_apply_matches_the_reference(case):
    assert _rel(case["mgp"].apply(case["r"]), case["ref"]) <= TOL


def _coarse_on_r(mgp, r):
    """The V-cycle with its coarse correction taken on r, not r - A x."""
    x = mgp._smooth(r, cplx.zeros_like(r), 1, x_is_zero=True)
    ec = mgp.coarse_solve.solve(mgp.coarse, mgp.restrict(r), mgp.params.coarse_gcr)["x"]
    return mgp._smooth(r, mgp.prolong(ec, base=x), 1)


def _faulty(case, fault: str):
    mgp = case["mgp"]
    if fault == "bf16_smoother":
        bf = DiracOperator(with_link_dtype(case["d"], torch.bfloat16), K)
        return dataclasses.replace(mgp, a_smooth=bf).apply
    if fault in ("n_pre_smooth", "n_post_smooth"):
        return dataclasses.replace(
            mgp, params=dataclasses.replace(mgp.params, **{fault: 0})).apply
    return lambda r: _coarse_on_r(mgp, r)


@pytest.mark.parametrize("fault", ["bf16_smoother", "n_pre_smooth", "n_post_smooth",
                                   "coarse_on_r"])
def test_a_planted_fault_fails_the_comparison(case, fault):
    assert _rel(_faulty(case, fault)(case["r"]), case["ref"]) > TOL


def test_the_coarse_count_shows(case):
    """One coarse iteration fewer on the reference side is outside TOL:
    the comparison holds the coarse GCR's count, not only its span."""
    fewer = vcycle.vcycle(case["links"], K, case["transfer"], case["r_lat"],
                          COARSE.max_iter - 1, COARSE.restart)
    assert _rel(case["mgp"].apply(case["r"]), fewer) > TOL


@pytest.mark.parametrize("smoother,iters", [("gcr", 8), ("neumann", 2 * 4)])
def test_smoother_counts(case, smoother, iters):
    """Two smoother solves an apply (pre and post), each of its iterations
    (the GCR(4) smoother's tol is 0: 4 each; Neumann: its 4 terms)."""
    mgp = case["mgp"]
    if smoother == "neumann":
        mgp = dataclasses.replace(mgp, params=dataclasses.replace(mgp.params,
                                                                  smoother="neumann"))
    reset_smoother_counts()
    mgp.apply(case["r"])
    assert smoother_counts() == {"calls": 2, "iterations": iters}
    mgp.apply(case["r"])
    assert smoother_counts() == {"calls": 4, "iterations": 2 * iters}
    reset_smoother_counts()
    assert smoother_counts() == {"calls": 0, "iterations": 0}


def _spans(apply, r) -> list:
    """The profiler's kind of each ``mg.smooth`` event in one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply(r)
    return [e.activity_type() for e in prof.profiler.kineto_results.events()
            if e.name() == "mg.smooth"]


def test_each_smoother_solve_has_its_span(case):
    """Two spans an apply, each a plain host range: a user annotation
    would be mirrored onto the card's timeline as a range over the
    smoother's kernels, which the benchmark's trace reader counts as
    device work (``mg.idle_share`` would read the smoother as busy)."""
    assert _spans(case["mgp"].apply, case["r"]) == ["cpu_op", "cpu_op"]


def test_deflation_runs_no_smoother(case):
    """With the smoother off (the config of record) the apply is the
    deflation: no smoother solve, no span, no count."""
    mgp = dataclasses.replace(case["mgp"], params=dataclasses.replace(
        case["mgp"].params, smoother_gcr=None))
    reset_smoother_counts()
    assert _spans(mgp.apply, case["r"]) == []
    assert smoother_counts() == {"calls": 0, "iterations": 0}


def test_reference_gcr_solves_and_the_transfer_is_orthonormal(case):
    """The reference's own pieces: 60 GCR(10) iterations at k = 0.12 reduce
    the residual of A x = r by orders of magnitude; P^H P = I for the
    program's per-block orthonormal basis; blocking and unblocking are
    inverse."""
    links, r = case["links"], case["r_lat"]

    def a(v):
        return wilson.dirac(links, v, 0.12)

    x = vcycle.gcr(a, r, 60, 10)
    assert torch.linalg.vector_norm(r - a(x)) < 1e-4 * torch.linalg.vector_norm(r)
    t = case["transfer"]
    c = torch.randn(t.q.shape[1], t.q.shape[0], dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(164))
    assert torch.allclose(t.restrict(t.prolong(c)), c, atol=1e-6)
    assert torch.equal(vcycle.unblocked(vcycle.blocked(r, BLOCK), DIMS, BLOCK), r)


# a synthetic timeline (ns): the smoother's K2 (ZSTEP false) and K3 with the
# reductions launched after them, K4, then the V-cycle's restriction and
# the outer loop's B9 (ZSTEP true) with its reduction and K1, none of which
# is the smoother's
OPS = [
    ("void mg::gcr_step_kernel<2, float, false, false>(float const*)", 100, 140),
    ("mg::reduce_partials_kernel(double const*)", 140, 145),
    ("mg::ap_update_kernel(float const*)", 150, 170),
    ("mg::reduce_partials_kernel(double const*)", 170, 172),
    ("mg::basis_flush_kernel(float const*)", 180, 200),
    ("void mg::restrict_kernel<float>(float const*)", 205, 218),
    ("void mg::gcr_step_kernel<2, float, true, false>(float const*)", 300, 330),
    ("mg::reduce_partials_kernel(double const*)", 330, 336),
    ("void mg::dslash_kernel<2, float, false, false>(float const*)", 340, 360),
]
SPANS = [("portbench.traced", 0, 1000), ("portbench.vcycle", 90, 220)]


def _run(trace, iters=(3, 2), smoother=None):
    cfg = {"lattice": [32, 32, 32, 32], "link_rows": 2, "link_dtype": "float32",
           "mg": {"smoother_gcr": smoother or {"tol": 0.0, "max_iter": 4, "restart": 4}}}
    return type("Run", (), {"trace": trace, "config": cfg, "dims": (32, 32, 32, 32),
                            "traced_solves": [{"iters": n} for n in iters]})()


def test_the_smoother_kernels_are_picked_by_name_and_order():
    trace = Trace(list(reversed(OPS)), SPANS, 0, 1000)
    assert smooth_kernels.seconds(trace) == pytest.approx((40 + 5 + 20 + 2 + 20) * 1e-9)


def test_the_smoother_readers():
    trace = Trace(OPS, SPANS, 0, 1000)
    share = bench_run.reader("metrics", "mg.smooth_share")
    assert share(_run(trace)) == pytest.approx(87 / 100)  # 13 of the V-cycle's busy is B10
    roof = bench_run.reader("metrics", "smooth_iter_roofline")
    nbytes = roofline.gcr_iteration_bytes((32, 32, 32, 32), 4)
    per_iter = 87e-9 / (5 * 2 * 4)  # 5 applies, 2 sweeps of 4 iterations each
    assert roof(_run(trace)) == pytest.approx(roofline.share_percent(nbytes, per_iter))
    assert roof(_run(None)) is None and share(_run(None)) is None
    assert roof(_run(trace, smoother={"tol": 1e-3, "max_iter": 4, "restart": 4})) is None
    assert roof(_run(trace, iters=())) is None
