"""Port parity for the loop-form and eager fused GCR and their kernels.

Kernels B6 ``update_xr``, B3 ``beta_dots``, B7 ``dir_update`` and K3's
``r`` form of ``ap_update``: the plain versions (CPU tensors) against the
JAX package's Pallas kernels in interpret mode, f32, S = 3, fields and
reductions to 1e-5 of each output's scale. B7 is checked with its ring
slot outside and inside the live prefix (truncation writes a row it reads).

Solves, float64 on a 4^4 lattice (k = 0.12, anti-periodic t), against the
JAX package's generic ``gcr_solve`` on ``TpuWilsonDirac``: the fused loop
form under restart with ``unroll="loop"``, truncation, residual refresh
and restart 20 (> 16, past the cycles form); the cycles form on
``SlabWilsonDirac`` with a right preconditioner (beta_dots and the r form
of ap_update); the fused eager loop against JAX ``gcr_solve_eager``.
Histories to rtol 1e-10 (atol 1e-13), the same iteration count, x to
1e-9 of scale. The JAX loop form compiles one kernel per live-prefix
length in interpret mode; ``tests/test_gcr_fused.py`` holds it equal to
the generic solve used here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.pallas import gcr_kernels as jgk
from mgpgcr_tpu.ops.wilson import antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.gcr import gcr_solve as j_gcr_solve
from mgpgcr_tpu.solvers.gcr import gcr_solve_eager as j_gcr_solve_eager
from mgpgcr_tpu.solvers.params import GCRParams as JParams
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    SlabWilsonDirac,
    cplx,
    gcr_solve,
    gcr_solve_eager,
)
from mgpgcr_tpu_torch.kernels.gcr_kernels import ap_update, beta_dots, dir_update, update_xr
from mgpgcr_tpu_torch.ops import wilson

DIMS = (4, 4, 4, 4)
SHAPE = (4, 3, 4, 4, 16)
K = 0.12
S = 3
ALPHA = 0.3 - 0.2j


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _jcf(z, dtype=jnp.float32):
    return jcplx.CF(jnp.asarray(z.real, dtype), jnp.asarray(z.imag, dtype))


def _tcf(z):
    return cplx.from_numpy(z, torch.float32, "cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(71)

    def field(lead=()):
        sh = lead + SHAPE
        return (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)).astype(np.complex64)

    return {
        "x": field(), "r": field(), "z": field(), "az": field(),
        "ps": field((S,)), "aps": field((S,)),
        "betas": (rng.standard_normal(S) + 1j * rng.standard_normal(S)).astype(np.complex64),
    }


def test_update_xr_matches_jax(data):
    slot = 1
    jx, jr, jr2 = jgk.update_xr(
        _jcf(data["x"]), _jcf(data["r"]), _jcf(data["ps"]), _jcf(data["aps"]), slot,
        jcplx.from_scalar(ALPHA, jnp.float32),
    )
    tx, tr, tr2 = update_xr(
        _tcf(data["x"]), _tcf(data["r"]), _tcf(data["ps"]), _tcf(data["aps"]), slot,
        torch.tensor(ALPHA, dtype=torch.complex64),
    )
    _close(cplx.to_numpy(tx), jcplx.to_numpy(jx))
    _close(cplx.to_numpy(tr), jcplx.to_numpy(jr))
    _close(float(tr2), float(jr2))


@pytest.mark.parametrize("lim", [1, S])
def test_beta_dots_matches_jax(data, lim):
    want = jcplx.to_numpy(jgk.beta_dots(_jcf(data["aps"]), _jcf(data["az"]), lim=lim))
    got = beta_dots(_tcf(data["aps"]), _tcf(data["az"]), lim).numpy()
    _close(got, want)
    assert got.shape == (S,) and np.all(got[lim:] == 0)


# (r given, lim, slot): the restart ring's slot past the live prefix, and
# slots inside it, where the kernel overwrites a row it reads
DIR_CASES = [(False, 2, 2), (False, S, 0), (True, S, 1)]


@pytest.mark.parametrize("with_r,lim,slot", DIR_CASES)
def test_dir_update_matches_jax(data, with_r, lim, slot):
    r = data["r"] if with_r else None
    jps, japs, japn, japr = jgk.dir_update(
        _jcf(data["z"]), _jcf(data["az"]), None if r is None else _jcf(r), _jcf(data["ps"]),
        _jcf(data["aps"]), _jcf(data["betas"]), slot, lim=lim,
    )
    ps, aps = _tcf(data["ps"]), _tcf(data["aps"])
    out = dir_update(
        _tcf(data["z"]), _tcf(data["az"]), None if r is None else _tcf(r), ps, aps,
        torch.as_tensor(data["betas"]), slot, lim,
    )
    assert out[0] is ps and out[1] is aps  # written in place
    _close(cplx.to_numpy(ps), jcplx.to_numpy(jps))
    _close(cplx.to_numpy(aps), jcplx.to_numpy(japs))
    _close(float(out[2]), float(japn))
    _close(complex(out[3]), complex(jcplx.to_numpy(japr)))
    # the rows other than the slot pass through
    keep = [j for j in range(S) if j != slot]
    assert np.array_equal(cplx.to_numpy(aps)[keep], data["aps"][keep])


def test_ap_update_r_form_matches_jax(data):
    lim, slot = S, 0  # the cycle's last step: the slot inside the live prefix
    japs, japn, japr = jgk.ap_update(
        _jcf(data["az"]), _jcf(data["r"]), _jcf(data["aps"]), _jcf(data["betas"]), slot, lim
    )
    aps = _tcf(data["aps"])
    out, apn, apr = ap_update(
        _tcf(data["az"]), aps, torch.as_tensor(data["betas"]), slot, lim, r=_tcf(data["r"])
    )
    assert out is aps
    _close(cplx.to_numpy(out), jcplx.to_numpy(japs))
    _close(float(apn), float(japn))
    _close(complex(apr), complex(jcplx.to_numpy(japr)))


# ---- whole solves, float64 ------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(61, mesh)
    rng = np.random.default_rng(62)
    rhs = rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)
    # a fixed right preconditioner both packages can apply: M v = w v
    w = 1.0 + 0.5 * rng.random(SHAPE)
    d = CudaWilsonDirac.build(links, mesh, compress=True, antiperiodic_t=True,
                              link_dtype=torch.float64, device="cpu")
    jd = TpuWilsonDirac.build(_jcf(antiperiodic_t(links), jnp.float64), JMesh(mesh.dims))
    return {
        "mesh": mesh, "links": links, "w": w,
        "a": DiracOperator(d, K), "b": cplx.from_numpy(rhs, torch.float64, "cpu"),
        "ja": JDirac(jd, jcplx.from_scalar(K, jnp.float64)), "jb": _jcf(rhs, jnp.float64),
    }


def _precond(w):
    wt = torch.as_tensor(w)
    return lambda v: cplx.CF(v.re * wt, v.im * wt)


def _jprecond(w):
    wj = jnp.asarray(w)
    return lambda v: jcplx.CF(v.re * wj, v.im * wj)


def _history(res):
    h = np.asarray(res.res_history)
    return h[~np.isnan(h)]


def _compare(got, want):
    assert got.converged and bool(want.converged)
    assert got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(_history(got), _history(want), rtol=1e-10, atol=1e-13)
    xw = jcplx.to_numpy(want.x)
    _close(cplx.to_numpy(got.x), xw, 1e-9)


LOOP = {
    "restart_loop": dict(restart=5, unroll="loop"),
    "truncation": dict(truncation=5),
    "refresh": dict(restart=3, residual_refresh=7),
    "restart20": dict(restart=20),
}


@pytest.mark.parametrize("name", sorted(LOOP))
def test_fused_loop_matches_jax(problem, name):
    kw = dict(tol=1e-9, max_iter=60, **LOOP[name])
    got = gcr_solve(problem["a"], problem["b"], GCRParams(fused=True, **kw))
    want = jax.jit(lambda a, b: j_gcr_solve(a, b, JParams(**kw)))(problem["ja"], problem["jb"])
    _compare(got, want)


def test_fused_cycles_on_slab_operator_matches_jax(problem):
    """SlabWilsonDirac has no one-pass step: each cycle step runs update_r,
    M r, A z, beta_dots and ap_update in its r form."""
    mesh, links = problem["mesh"], problem["links"]
    slab = DiracOperator(SlabWilsonDirac.build(
        cplx.from_numpy(wilson.antiperiodic_t(links), torch.float64, "cpu"), mesh), K)
    kw = dict(tol=1e-9, max_iter=60, restart=5)
    got = gcr_solve(slab, problem["b"], GCRParams(fused=True, **kw),
                    precond=_precond(problem["w"]))
    m = _jprecond(problem["w"])
    want = jax.jit(lambda a, b: j_gcr_solve(a, b, JParams(**kw), precond=m))(
        problem["ja"], problem["jb"])
    _compare(got, want)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
@pytest.mark.parametrize("kw,check_every", [(dict(restart=5), 1), (dict(truncation=4), 3)])
def test_fused_eager_matches_jax(problem, kw, check_every, fused):
    """The eager history has n_iters + 1 entries. The fused form checking
    every 3rd iteration may run up to 2 past the JAX loop's stop (here 28
    is not a multiple of 3), on the same path; the generic form reads the
    norm every iteration."""
    params = dict(tol=1e-9, max_iter=60, **kw)
    got = gcr_solve_eager(problem["a"], problem["b"], GCRParams(fused=fused, **params),
                          check_every=check_every)
    want = j_gcr_solve_eager(problem["ja"], problem["jb"], JParams(**params))
    n = int(want.n_iters)
    assert got.converged and bool(want.converged)
    assert n <= got.n_iters <= n + (check_every - 1 if fused else 0)
    assert got.res_history.shape == (got.n_iters + 1,)
    np.testing.assert_allclose(got.res_history.numpy()[: n + 1], np.asarray(want.res_history),
                               rtol=1e-10, atol=1e-13)
    if got.n_iters == n:
        _close(cplx.to_numpy(got.x), jcplx.to_numpy(want.x), 1e-9)
    else:  # past JAX's stop: the port's own solution, by its true residual
        b = problem["b"]
        res = b - problem["a"].apply(got.x)
        rel = float(torch.sqrt(cplx.abs2_sum(res) / cplx.abs2_sum(b)))
        assert rel <= params["tol"]
