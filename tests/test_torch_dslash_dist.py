"""Port parity for the ghost-plane kernels' plain versions: B14
(``dslash_apply_local`` on CPU tensors, ranks under ``ThreadComm``)
against ``PallasWilsonDirac.build_sharded(..., interpret=True)`` for (t, z)
grids (2, 2), (4, 1) (anti-periodic, two-row links) and (1, 4), the port's
D psi and A psi = psi - k D psi both held to one JAX entry point per grid
(``apply`` on (2, 2), ``apply_dirac`` on the others); B15
(``gcr_stream_step_local``) against the JAX one-pass step inside
``shard_map`` on a (2, 2) grid, alpha != 0, lim 1 and 3. Float64; fields
to atol 1e-12, the partial dots summed over ranks to rtol 1e-10. Each JAX
program (interpret mode) is compiled once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.pallas.dslash import PallasWilsonDirac
from mgpgcr_tpu.ops.pallas.gcr_dslash_dist import gcr_stream_step_local as j_step_local
from mgpgcr_tpu.parallel import make_lattice_device_mesh
from mgpgcr_tpu_torch import LatticeMesh, ShardLocalWilsonDirac, cplx
from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import gcr_stream_step_local
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.parallel import gather_field, make_shard_grid, run_spmd, shard_field

DIMS = (4, 4, 2, 2)
K = 0.13
ALPHA = 0.3 - 0.2j
S = 4


@pytest.fixture(scope="module", autouse=True)
def _quick_compile():
    """Each interpret-mode JAX program here runs once: compile it without
    XLA's optimisation passes (restored after the module)."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(3, mesh)
    rng = np.random.default_rng(4)
    shape = (4, 3, DIMS[0], DIMS[1], DIMS[2] * DIMS[3])

    def field(*lead):
        return rng.standard_normal(lead + shape) + 1j * rng.standard_normal(lead + shape)

    return mesh, links, field(), field(), field(S)


def _jcf(z):
    return jcplx.CF(jnp.asarray(np.real(z)), jnp.asarray(np.imag(z)))


def _tcf(z):
    return cplx.from_numpy(np.asarray(z), torch.float64, "cpu")


def _jax_op(links, mesh, sizes, anti, compress):
    dmesh = make_lattice_device_mesh(4, axis_names=("t", "z"), axis_sizes=sizes)
    lcf = jcplx.ascf(jnp.asarray(links), jnp.float64)
    return PallasWilsonDirac.build_sharded(lcf, JMesh(mesh.dims), dmesh, axis_t="t",
                                           axis_z="z", compress=compress,
                                           antiperiodic_t=anti, interpret=True)


def _port_apply(links, mesh, sizes, anti, compress, psi):
    """(D psi, A psi) gathered from the ranks of a ThreadComm grid."""
    grid = make_shard_grid(sizes, ("t", "z"), device="cpu")
    k = torch.tensor(K, dtype=torch.complex128)

    def body(comm):
        d = ShardLocalWilsonDirac.build(links, mesh, comm, "t", "z", compress=compress,
                                        antiperiodic_t=anti, link_dtype=torch.float64)
        x = shard_field(psi, grid, comm.rank, "t", "z")
        return d.apply(x), d.apply_dirac(x, k)

    res = run_spmd(grid, body)
    return [cplx.to_numpy(gather_field([r[i] for r in res], grid, "t", "z")) for i in range(2)]


# the anti-periodic two-row case on the grid that splits t four ways: the
# sign rides the ghosts that cross the global t edge (ranks 3 -> 0 -> 3).
# Each grid compiles one JAX program (interpret mode, ~5 s): D psi through
# ``apply`` on (2, 2), A psi through ``apply_dirac`` on the others; the
# other output follows from A psi = psi - k D psi, exact to ~1e-15 here.
@pytest.mark.parametrize("sizes,anti,compress,entry", [
    ((2, 2), False, False, "apply"), ((4, 1), True, True, "apply_dirac"),
    ((1, 4), False, False, "apply_dirac")])
def test_dslash_dist_plain_matches_jax(problem, sizes, anti, compress, entry):
    mesh, links, psi, _, _ = problem
    op = _jax_op(links, mesh, sizes, anti, compress)
    x = op.shard_field(_jcf(psi))
    if entry == "apply":
        want_d = jcplx.to_numpy(jax.jit(lambda o, v: o.apply(v))(op, x))
        want_a = psi - K * want_d
    else:
        want_a = jcplx.to_numpy(jax.jit(lambda o, v, k: o.apply_dirac(v, k))(
            op, x, jcplx.from_scalar(K, jnp.float64)))
        want_d = (psi - want_a) / K
    got_d, got_a = _port_apply(links, mesh, sizes, anti, compress, _tcf(psi))
    np.testing.assert_allclose(got_d, want_d, atol=1e-12)
    np.testing.assert_allclose(got_a, want_a, atol=1e-12)


@pytest.mark.parametrize("lim,anti,compress", [(1, False, False), (3, True, True)])
def test_gcr_step_dist_plain_matches_jax(problem, lim, anti, compress):
    """B15's plain version: the pre-combined r' ghosts (alpha != 0 and a
    non-zero ap face, so an axpy applied to a ghost would show), the
    fields, and the partial dots summed over the ranks."""
    mesh, links, _, r, aps = problem
    d = _jax_op(links, mesh, (2, 2), anti, compress)
    lmesh = d.local_mesh()
    fspec, lspec = d._field_spec(), d._links_spec()
    aspec = P(None, None, None, "t", "z", None)

    def body(lk, rr, ap, al, kk):
        rp, az, r2, raw, apr = j_step_local(lk, rr, ap, al, kk, lim, lmesh, "t", 2, "z", 2,
                                            anti_t=anti, interpret=True)

        def tot(v):
            return jax.lax.psum(v, ("t", "z"))

        return rp, az, tot(r2), jcplx.CF(tot(raw.re), tot(raw.im)), jcplx.CF(
            tot(apr.re), tot(apr.im))

    fn = jax.shard_map(body, mesh=d.device_mesh, in_specs=(lspec, fspec, aspec, P(), P()),
                       out_specs=(fspec, fspec, P(), P(), P()), check_vma=False)
    alpha = jcplx.CF(jnp.asarray(ALPHA.real), jnp.asarray(ALPHA.imag))
    want = jax.jit(fn)(d.links, d.shard_field(_jcf(r)), _jcf(aps), alpha,
                       jcplx.from_scalar(K, jnp.float64))

    grid = make_shard_grid((2, 2), ("t", "z"), device="cpu")
    rt, apst = _tcf(r), _tcf(aps)
    at = torch.tensor(ALPHA, dtype=torch.complex128)
    kt = torch.tensor(K, dtype=torch.complex128)

    def rank(comm):
        op = ShardLocalWilsonDirac.build(links, mesh, comm, "t", "z", compress=compress,
                                         antiperiodic_t=anti, link_dtype=torch.float64)
        rl = shard_field(rt, grid, comm.rank, "t", "z")
        al = shard_field(apst, grid, comm.rank, "t", "z")
        rp, az, r2, raw, apr = gcr_stream_step_local(op.links, op.ghost_links, rl, al, at, kt,
                                                     lim, op.local_mesh, comm, "t", "z", anti)
        return rp, az, comm.allsum(r2), comm.allsum(raw), comm.allsum(apr)

    res = run_spmd(grid, rank)
    for i in (0, 1):
        got = cplx.to_numpy(gather_field([x[i] for x in res], grid, "t", "z"))
        np.testing.assert_allclose(got, jcplx.to_numpy(want[i]), atol=1e-12)
    np.testing.assert_allclose(float(res[0][2]), float(want[2]), rtol=1e-10)
    # the JAX step leaves the rows from lim to S-1 unwritten; they are zero here
    rows = {3: list(range(lim)), 4: list(range(lim)) + [S]}
    for i, live in rows.items():
        w = (np.asarray(want[i].re) + 1j * np.asarray(want[i].im))[live]
        got = res[0][i].numpy()
        np.testing.assert_allclose(got[live], w, rtol=1e-10, atol=1e-10 * np.abs(w).max())
        assert not np.any(np.delete(got, live))
