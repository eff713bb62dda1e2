"""Port parity for the domain-decomposition layer: ``balanced_factors``
against the JAX one, the halo shift under ``ThreadComm`` against
``torch.roll`` on the gathered field, the port's ``ShardedWilsonDirac``
against the JAX ``ShardedWilsonDirac`` on the conftest's virtual CPU
devices (float64, atol 1e-12), the communicator's rules (rank-order sums,
failures that surface instead of hanging), and the launch configuration
of ``parallel/dist.py``."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.parallel import ShardedWilsonDirac as JShardedWilsonDirac
from mgpgcr_tpu.parallel import balanced_factors as j_balanced_factors
from mgpgcr_tpu.parallel import make_lattice_device_mesh, shard_field as j_shard_field
from mgpgcr_tpu_torch import LatticeMesh, cplx
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.parallel import (
    ShardedWilsonDirac,
    balanced_factors,
    gather_field,
    make_shard_grid,
    periodic_shift,
    run_spmd,
    shard_field,
    shard_links,
)
from mgpgcr_tpu_torch.parallel import dist
from mgpgcr_tpu_torch.parallel.mesh import join_shards
from mgpgcr_tpu_torch.parallel.wilson import shard_lattice_field


@pytest.mark.parametrize("n,k", [(8, 3), (8, 2), (12, 2), (1, 2), (7, 2), (36, 3), (64, 4)])
def test_balanced_factors_match_jax(n, k):
    assert balanced_factors(n, k) == j_balanced_factors(n, k)


def test_grid_layout_is_row_major():
    grid = make_shard_grid((2, 3), ("t", "z"), device="cpu")
    assert [grid.coords(r) for r in range(6)] == [(i, j) for i in range(2) for j in range(3)]
    assert all(grid.rank_of(grid.coords(r)) == r for r in range(6))
    assert grid.axis_size("z") == 3 and grid.axis_size(None) == 1
    assert make_shard_grid(8, ("t", "z"), device="cpu").axis_sizes == (4, 2)


def test_shard_and_gather_round_trip():
    grid = make_shard_grid((2, 2), device="cpu")
    x = cplx.random(torch.Generator().manual_seed(1), (4, 3, 4, 6, 8), torch.float64, "cpu")
    parts = [shard_field(x, grid, r, "t", "z") for r in range(4)]
    assert parts[3].shape == (4, 3, 2, 3, 8)
    back = gather_field(parts, grid, "t", "z")
    assert torch.equal(back.re, x.re) and torch.equal(back.im, x.im)
    links = torch.arange(4 * 4 * 2 * 3 * 6 * 8.0).reshape(4, 4, 2, 3, 6, 8)
    assert torch.equal(shard_links(links, grid, 1, "t", "z"), links[:2, :, :, :, 3:])
    # a grid axis that splits nothing holds copies: the first is taken
    assert torch.equal(join_shards(parts, grid, {"t": -3}).re, gather_field(
        [parts[0], parts[0], parts[2], parts[2]], grid, "t", None).re)


@pytest.mark.parametrize("sizes,names", [((4,), ("t",)), ((2, 2), ("t", "z"))])
def test_periodic_shift_matches_roll(sizes, names):
    grid = make_shard_grid(sizes, names, device="cpu")
    x = torch.arange(2 * 8 * 4 * 5, dtype=torch.float64).reshape(2, 8, 4, 5)
    dims = {names[0]: 1, **({names[1]: 2} if len(names) > 1 else {})}
    cases = [(axis, name, s) for axis, name in ((1, names[0]), (2, names[-1]), (3, None))
             for s in (-1, 1)]

    def body(comm):
        from mgpgcr_tpu_torch.parallel.mesh import cut_shard

        xl = cut_shard(x, grid, comm.rank, dims)
        out = []
        for axis, name, s in cases:
            split = name if dims.get(name) == axis else None
            out.append(periodic_shift(xl, axis, s, comm, split))
        return out

    res = run_spmd(grid, body)
    for i, (axis, _, s) in enumerate(cases):
        got = join_shards([r[i] for r in res], grid, dims)
        assert torch.equal(got, torch.roll(x, s, axis)), (axis, s)


def test_allsum_is_rank_ordered_and_equal_on_every_rank():
    grid = make_shard_grid((3,), ("t",), device="cpu")
    vals = [torch.tensor([0.1 + 0.7j], dtype=torch.complex128) * (r + 1) ** 3 for r in range(3)]
    res = run_spmd(grid, lambda comm: comm.allsum(vals[comm.rank]))
    want = (vals[0] + vals[1]) + vals[2]
    assert all(torch.equal(r, want) for r in res)


def test_many_ranks_many_rounds_under_a_short_switch_interval():
    """More ranks than cores, a short interpreter switch interval, and
    rounds of exchanges and sums back to back through the two-row
    mailbox: every rank gets its neighbours' values and the exact sum
    every round; the shared launch counter loses no update."""
    import sys

    from mgpgcr_tpu_torch.kernels import _lib

    def counted():
        pass

    counted.launches = 0
    grid = make_shard_grid((4, 4), ("t", "z"), device="cpu")
    n, rounds = grid.size, 60

    def body(comm):
        for i in range(rounds):
            mine = torch.tensor([float(comm.rank + n * i)])
            nxt, prv = comm.exchange([(mine, "t", 1), (mine, "z", -1)])
            assert nxt.item() == comm.neighbour("t", 1) + n * i
            assert prv.item() == comm.neighbour("z", -1) + n * i
            assert comm.allsum(mine).item() == n * (n - 1) / 2 + n * n * i
            _lib.count(counted)
        return True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert run_spmd(grid, body, timeout=60.0) == [True] * n
    finally:
        sys.setswitchinterval(old)
    assert counted.launches == n * rounds


def test_a_failing_rank_surfaces_as_an_exception():
    """One rank raises while the others wait in a collective: run_spmd
    re-raises that rank's error at once, not after the timeout."""
    grid = make_shard_grid((2, 2), device="cpu")

    def body(comm):
        if comm.rank == 2:
            raise KeyError("boom")
        return comm.allsum(torch.ones(1))

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="boom") as info:
        run_spmd(grid, body, timeout=30.0)
    assert "raised by rank 2 of 4" in info.value.__notes__[0]
    assert time.perf_counter() - t0 < 10.0


def test_a_missing_rank_times_out_instead_of_hanging():
    """A rank that leaves before a collective the others enter: they give up
    after the barrier's timeout."""
    grid = make_shard_grid((2,), ("t",), device="cpu")

    def body(comm):
        if comm.rank == 1:
            return None
        return comm.recv_from_next(torch.ones(2), "t")

    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError) as info:
        run_spmd(grid, body, timeout=2.0)
    assert "raised by rank 0 of 2" in info.value.__notes__[0]
    assert time.perf_counter() - t0 < 20.0


def test_sharded_wilson_matches_jax():
    """The port's halo-exchanged stencil under ThreadComm against the JAX
    ShardedWilsonDirac inside shard_map, on the same links and field."""
    dims, sizes = (4, 4, 2, 2), (4, 2)  # the 8 virtual devices
    mesh = LatticeMesh((*dims, 4, 3))
    links = wilson.random_links_np(7, mesh)
    rng = np.random.default_rng(8)
    psi = rng.standard_normal((*dims, 4, 3)) + 1j * rng.standard_normal((*dims, 4, 3))

    dmesh = make_lattice_device_mesh(int(np.prod(sizes)), axis_names=("t", "z"),
                                     axis_sizes=sizes)
    jm = JMesh(mesh.dims)
    jop = JShardedWilsonDirac.build(jnp.asarray(links), jm, dmesh)
    # one jitted program: op-by-op dispatch of shard_map takes seconds longer
    want = np.asarray(jax.jit(jop.apply)(j_shard_field(jnp.asarray(psi), dmesh, jm)))

    grid = make_shard_grid(sizes, ("t", "z"), device="cpu")
    psi_t = torch.as_tensor(psi)

    def body(comm):
        op = ShardedWilsonDirac.build(links, mesh, comm)
        return op.apply(shard_lattice_field(psi_t, grid, comm.rank, mesh))

    parts = run_spmd(grid, body)
    got = join_shards(parts, grid, {"t": -6, "z": -5}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_dist_config_from_env(monkeypatch):
    for var in ("MGPGCR_COORDINATOR", "MGPGCR_NUM_PROCESSES", "MGPGCR_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert dist.config_from_env() is None
    monkeypatch.setenv("MGPGCR_COORDINATOR", "node0:8476")
    monkeypatch.setenv("MGPGCR_NUM_PROCESSES", "4")
    monkeypatch.setenv("MGPGCR_PROCESS_ID", "2")
    cfg = dist.config_from_env()
    assert (cfg.coordinator, cfg.num_processes, cfg.process_id) == ("node0:8476", 4, 2)
    assert cfg.is_multiprocess
    monkeypatch.delenv("MGPGCR_NUM_PROCESSES")
    with pytest.raises(ValueError):
        dist.config_from_env()


def test_init_distributed_single_process_noop(monkeypatch):
    """With no topology configured, init_distributed joins no process group."""
    for var in ("MGPGCR_COORDINATOR", "MGPGCR_NUM_PROCESSES", "MGPGCR_PROCESS_ID", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)

    def boom(*a, **k):  # pragma: no cover - would mean the guard failed
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    cfg = dist.init_distributed(device="cpu")
    assert not cfg.is_multiprocess and cfg.process_id == 0
    assert dist.is_coordinator()
    assert dist.process_summary()["num_processes"] == 1


def test_backend_follows_the_device():
    assert dist.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.backend_for(None)
