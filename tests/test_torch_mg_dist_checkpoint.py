"""Sharded MG checkpoints of the port (``io/checkpoint.py``) against the
JAX package's, and the port's ``ShardLocalCoarseStencil`` against JAX's.
float64, CPU, 4^4 lattice, k = 0.12, anti-periodic t, two-row links,
block 2, one near-null vector, a (2, 2) grid: ThreadComm ranks on the
port's side, a (2, 2) CPU device mesh on JAX's. No JAX
``setup_mg_sharded`` or ``mg_gcr_solve_sharded`` runs; JAX builds sharded
objects only by loading the port's file, and applies its
``ShardLocalCoarseStencil`` once.

- Sharded checkpoint: the port's file (stencil coarse, "stencil_sharded")
  loads in JAX (``load_mg_setup_sharded`` onto a (2, 2) device mesh of the
  same axis extents), JAX's re-save holds the same keys, dtypes, shapes,
  values and meta, and the port's load of JAX's file repeats the original
  V-cycle bit for bit on every rank.
- ``ShardLocalCoarseStencil.apply`` on a (2, 2) grid equals JAX's
  shard-local stencil apply (XLA, in ``shard_map``) on the same blocks and
  input, to 1e-12 of scale.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.io.checkpoint import load_mg_setup_sharded as j_load_sharded
from mgpgcr_tpu.io.checkpoint import save_mg_setup_sharded as j_save_sharded
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.pallas.dslash import PallasWilsonDirac
from mgpgcr_tpu.parallel import make_lattice_device_mesh
from mgpgcr_tpu.solvers.mg_dist import ShardLocalCoarseStencil as JShardLocalCoarseStencil
from mgpgcr_tpu_torch import (
    DiracOperator,
    LatticeMesh,
    ShardLocalWilsonDirac,
    cplx,
    load_mg_setup_sharded,
    make_shard_grid,
    run_spmd,
    save_mg_setup_sharded,
    shard_field,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mg_dist_worker as worker  # noqa: E402

K = 0.12


@pytest.fixture(autouse=True)
def thread_ranks():
    """Ranks as threads of one process: a short switch interval and one
    intra-op thread each, restored after the test."""
    old, old_threads = sys.getswitchinterval(), torch.get_num_threads()
    sys.setswitchinterval(1e-4)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        sys.setswitchinterval(old)
        torch.set_num_threads(old_threads)


@pytest.fixture(scope="module")
def problem():
    return worker.make_problem(k=K)


@pytest.fixture(scope="module")
def jax_operator(problem):
    """A over PallasWilsonDirac.build_sharded on a (2, 2) CPU device mesh."""
    jm = JMesh(tuple(int(d) for d in problem["dims"]))
    dmesh = make_lattice_device_mesh(4, axis_names=("t", "z"), axis_sizes=(2, 2))
    d = PallasWilsonDirac.build_sharded(jcplx.ascf(jnp.asarray(problem["links"]), jnp.float64),
                                        jm, dmesh, axis_t="t", axis_z="z", interpret=True,
                                        antiperiodic_t=True)
    return JDirac(d, jcplx.from_scalar(K, jnp.float64))


def test_sharded_checkpoint_both_directions(problem, jax_operator, tmp_path):
    mg = dataclasses.replace(worker.MG, coarse_format="stencil", smoother_gcr=None)
    grid = make_shard_grid((2, 2), ("t", "z"), device="cpu")
    rhs = cplx.from_numpy(problem["rhs"], torch.float64, "cpu")
    fa, fb = tmp_path / "port.npz", tmp_path / "jax.npz"

    def save(comm):
        mgp = worker.rank_setup(problem, comm, "z", mg)
        save_mg_setup_sharded(fa, mgp)
        return mgp.apply(shard_field(rhs, grid, comm.rank, "t", "z"))

    want = run_spmd(grid, save, timeout=120)

    jmgp = j_load_sharded(str(fa), jax_operator)
    assert isinstance(jmgp.coarse, JShardLocalCoarseStencil)
    j_save_sharded(str(fb), jmgp)
    with np.load(fa) as za, np.load(fb) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            if key == "meta":
                ma, mb = json.loads(str(za[key])), json.loads(str(zb[key]))
                assert ma == mb and ma["sharded"] and ma["coarse_kind"] == "stencil_sharded"
                continue
            assert za[key].dtype == zb[key].dtype and za[key].shape == zb[key].shape, key
            np.testing.assert_array_equal(za[key], zb[key])
        assert za["q5_re"].shape == (2, 2, 2, 4, 2 * 2 * 2 * 2 * 12)

    def load(comm):
        mesh = LatticeMesh(tuple(int(d) for d in problem["dims"]))
        d = ShardLocalWilsonDirac.build(problem["links"], mesh, comm, "t", "z", compress=True,
                                        antiperiodic_t=True, link_dtype=torch.float64)
        mgp = load_mg_setup_sharded(fb, DiracOperator(d, torch.tensor(K, dtype=torch.complex128)))
        return mgp.apply(shard_field(rhs, grid, comm.rank, "t", "z"))

    got = run_spmd(grid, load, timeout=120)
    for g, w in zip(got, want):
        assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)


def test_shard_local_stencil_apply_matches_jax(problem, jax_operator):
    from jax.sharding import PartitionSpec as P

    from mgpgcr_tpu.solvers.mg_dist import _geometry

    ja = jax_operator
    geom = _geometry(ja.d, 2)
    ne = 3
    rng = np.random.default_rng(4)
    shape = (2, 2, 4, 9, ne, ne)  # (Bt, Bz, By*Bx, 9, ne, ne)
    blocks = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x = rng.standard_normal((2, 2, 4, ne)) + 1j * rng.standard_normal((2, 2, 4, ne))
    # jitted: one compile of the shard_map body, where the eager call would
    # dispatch (and compile) each of its operations apart
    fn = jax.jit(jax.shard_map(lambda b, v: JShardLocalCoarseStencil(b, geom).apply(v),
                               mesh=ja.d.device_mesh,
                               in_specs=(P("t", "z"), P("t", "z")), out_specs=P("t", "z"),
                               check_vma=False))
    want = jcplx.to_numpy(fn(jcplx.ascf(jnp.asarray(blocks), jnp.float64),
                             jcplx.ascf(jnp.asarray(x), jnp.float64)))

    grid = make_shard_grid((2, 2), ("t", "z"), device="cpu")
    mesh = LatticeMesh(tuple(int(d) for d in problem["dims"]))

    def rank(comm):
        from mgpgcr_tpu_torch.parallel.mesh import cut_shard
        from mgpgcr_tpu_torch.solvers.mg_dist import ShardLocalCoarseStencil, _geometry as geo

        d = ShardLocalWilsonDirac.build(problem["links"], mesh, comm, "t", "z",
                                        link_dtype=torch.float64)
        g = geo(d, 2)
        local_b = cut_shard(torch.as_tensor(blocks), grid, comm.rank, {"t": 0, "z": 1})
        local_x = cut_shard(torch.as_tensor(x), grid, comm.rank, {"t": 0, "z": 1})
        y = ShardLocalCoarseStencil(local_b, g, comm).apply(cplx.ascf(local_x.reshape(-1)))
        return cplx.to_numpy(y).reshape(local_x.shape)

    out = run_spmd(grid, rank, timeout=60)
    got = np.concatenate([np.concatenate(out[0:2], axis=1), np.concatenate(out[2:4], axis=1)],
                         axis=0)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

