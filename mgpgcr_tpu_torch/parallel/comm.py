"""SPMD communicators: the port's counterparts of ``lax.ppermute``,
``lax.psum`` and ``lax.axis_index`` inside ``shard_map``.

The per-rank solver code is written once against :class:`Comm`, as the JAX
package's is written once inside ``shard_map``. Two implementations:

- :class:`ThreadComm` runs N ranks as threads of one process, which may all
  share one device (the JAX package's N virtual devices). Ranks meet at a
  shared mailbox guarded by a ``threading.Barrier``; every wait has a
  timeout, and a rank that raises breaks the barrier, so a failure surfaces
  as an exception in :func:`run_spmd` instead of a hang. Ranks on one card
  all launch on PyTorch's default stream of that card, so their kernels
  run in the order the host issues them and a deposited face is complete
  before any later kernel reads it.
- :class:`TorchDistComm` wraps an initialised ``torch.distributed`` group,
  one process per rank: NCCL for CUDA tensors, gloo for CPU ones.

``allsum`` returns the same bits on every rank: ThreadComm adds the ranks'
tensors in rank order; ``all_reduce`` gives every rank the same result.
"""

from __future__ import annotations

import threading

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.parallel.mesh import ShardGrid, rank_device

DEFAULT_TIMEOUT = 600.0  # seconds a rank waits for the others (a first kernel build included)


class Comm:
    """One rank's view of the grid: its coordinates, the ring neighbours
    along each axis, and the global sum. Fields may be tensors or CFs."""

    grid: ShardGrid
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.grid.size

    @property
    def coords(self) -> tuple[int, ...]:
        return self.grid.coords(self.rank)

    def axis_size(self, name: str | None) -> int:
        return self.grid.axis_size(name)

    def axis_index(self, name: str | None) -> int:
        return 0 if name is None else self.coords[self.grid.axis_names.index(name)]

    def neighbour(self, axis: str, step: int) -> int:
        """The rank ``step`` places along ``axis`` on its ring."""
        c = list(self.coords)
        i = self.grid.axis_names.index(axis)
        c[i] = (c[i] + step) % self.grid.axis_sizes[i]
        return self.grid.rank_of(c)

    def recv_from_next(self, x, axis: str):
        """Every rank sends ``x`` to its ring predecessor along ``axis`` and
        receives its successor's (rank j gets j+1's)."""
        return self.exchange([(x, axis, 1)])[0]

    def recv_from_prev(self, x, axis: str):
        """Every rank receives its ring predecessor's ``x`` (j gets j-1's)."""
        return self.exchange([(x, axis, -1)])[0]

    def exchange(self, items) -> list:
        """Several ring shifts in one round: for each ``(x, axis, step)``,
        the ``x`` of the rank ``step`` places along ``axis``. Every rank
        must pass items of the same axes and steps in the same order."""
        raise NotImplementedError

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of a real or complex tensor, on every rank."""
        raise NotImplementedError

    def all_gather(self, x) -> list:
        """Every rank's ``x`` (a tensor or CF of one shape on every rank),
        as a list indexed by rank, on every rank (``lax.all_gather``)."""
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError


class _Mailbox:
    """Two rows of one slot per rank, used in alternate rounds: a rank can
    write round n + 2's row only after every rank has reached round n + 1,
    that is, after all have read round n. One barrier per round."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.rows = ([None] * n, [None] * n)


def _own(x):
    """A contiguous copy of a tensor or CF that a rank deposits for others:
    the depositor may overwrite its own tensor after the round."""
    if cplx.is_cf(x):
        return cplx.CF(_own(x.re), _own(x.im))
    return x.clone(memory_format=torch.contiguous_format)


class ThreadComm(Comm):
    """A rank of :func:`run_spmd`: a thread sharing a mailbox with the others."""

    def __init__(self, grid: ShardGrid, rank: int, mailbox: _Mailbox, device: torch.device):
        self.grid, self.rank, self.device = grid, rank, device
        self._box = mailbox
        self._round = 0

    def _all(self, payload) -> list:
        """Deposit ``payload``; every rank's deposit of this round."""
        row = self._box.rows[self._round % 2]
        self._round += 1
        row[self.rank] = payload
        self._box.barrier.wait()
        return list(row)

    def exchange(self, items) -> list:
        posts = self._all([_own(x) for x, _, _ in items])
        return [posts[self.neighbour(axis, step)][i].to(self.device)
                for i, (_, axis, step) in enumerate(items)]

    def all_gather(self, x) -> list:
        return [p.to(self.device) for p in self._all(_own(x))]

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        parts = [p.to(self.device) for p in self._all(x)]
        total = parts[0]
        for p in parts[1:]:  # rank order: the same bits on every rank
            total = total + p
        return total

    def barrier(self) -> None:
        self._box.barrier.wait()


def run_spmd(grid: ShardGrid, fn, device=None, timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(comm)`` on every rank of ``grid`` as threads of this
    process and return the per-rank results. Each thread makes its rank's
    device (``grid.devices``, or ``device`` for all) current. If a rank
    raises, the others are released from their waits and its exception is
    re-raised here, with a note naming the rank, once every thread has
    ended; a rank that waits longer than ``timeout`` seconds for the others
    raises ``threading.BrokenBarrierError``."""
    n = grid.size
    box = _Mailbox(n, timeout)
    results, errors = [None] * n, [None] * n

    def body(rank: int) -> None:
        dev = rank_device(device) if device is not None else grid.devices[rank]
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[rank] = fn(ThreadComm(grid, rank, box, dev))
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[rank] = e
            box.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"spmd-rank-{r}", daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [(r, e) for r, e in enumerate(errors) if e is not None]
    if failed:
        # the rank that broke the barrier, not the ones it released
        rank, err = next(((r, e) for r, e in failed
                          if not isinstance(e, threading.BrokenBarrierError)), failed[0])
        err.add_note(f"raised by rank {rank} of {n} (run_spmd)")
        raise err
    return results


class TorchDistComm(Comm):
    """A rank of an initialised ``torch.distributed`` group (one process per
    rank; see ``parallel/dist.py::init_distributed``). ``grid`` lays the
    group's ranks out; ``device`` is this rank's device (CUDA unless
    named)."""

    def __init__(self, grid: ShardGrid, device=None, group=None):
        import torch.distributed as dist

        self._dist, self._group = dist, group
        self.rank = dist.get_rank(group)
        if dist.get_world_size(group) != grid.size:
            raise ValueError(f"group of {dist.get_world_size(group)} ranks, grid of {grid.size}")
        self.grid, self.device = grid, rank_device(device)

    def exchange(self, items) -> list:
        dist = self._dist
        ops, sent, got = [], [], []
        for x, axis, step in items:
            src, dst = self.neighbour(axis, step), self.neighbour(axis, -step)
            payload = torch.stack((x.re, x.im)) if cplx.is_cf(x) else x.contiguous()
            if src == self.rank:  # a ring of one
                got.append(payload.clone())
                continue
            sent.append(payload)
            got.append(torch.empty_like(payload))
            ops += [dist.P2POp(dist.isend, payload, dst, self._group),
                    dist.P2POp(dist.irecv, got[-1], src, self._group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [cplx.CF(g[0], g[1]) if cplx.is_cf(x) else g for g, (x, _, _) in zip(got, items)]

    def all_gather(self, x) -> list:
        if cplx.is_cf(x):
            return [cplx.CF(p[0], p[1]) for p in self.all_gather(torch.stack((x.re, x.im)))]
        y = torch.view_as_real(x) if x.is_complex() else x
        parts = [torch.empty_like(y) for _ in range(self.size)]
        self._dist.all_gather(parts, y.contiguous(), group=self._group)
        return [torch.view_as_complex(p) if x.is_complex() else p for p in parts]

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        self._dist.all_reduce(torch.view_as_real(y) if y.is_complex() else y,
                              op=self._dist.ReduceOp.SUM, group=self._group)
        return y

    def barrier(self) -> None:
        self._dist.barrier(group=self._group)
