"""MG-setup checkpointing.

Counterpart of ``mgpgcr_tpu/io/checkpoint.py``. The adaptive-MG setup
(near-null solves and the Galerkin assembly; the reference's
``MG::initialise``, MG.h:132-285) is the expensive precompute of a solve
session. These helpers save the setup's products, per level the blocked
basis ``q`` (ne, nb, block_len) and the Galerkin coarse operator, to a
portable ``.npz`` and rebuild the hierarchy from it, so that a later
session skips the setup.

The file is the JAX package's format version 2, byte-compatible in both
directions: the same keys, dtypes, shapes and ``meta`` JSON. The port's
slab ("tpu") levels keep only the field-shaped basis ``q_field``; the
blocked basis is derived from it on save and ``q_field`` is rebuilt on
load, as the JAX package derives its field basis. The JAX stencil coarse
operator records its backend: the port writes "xla" (what the JAX package
writes off the TPU) and ignores the value on load, as its
``StencilBlockOperator`` routes by device.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.blockstencil import StencilBlockOperator
from mgpgcr_tpu_torch.ops.bsr import BlockSparseOperator
from mgpgcr_tpu_torch.ops.dense import DenseOperator
from mgpgcr_tpu_torch.solvers.mg import _STORAGE, MGPreconditioner, field_basis
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams

# the JAX package's version: the block basis is stored (ne, nb, bl);
# version-1 files, (nb, bl, ne), are rejected
_FORMAT_VERSION = 2
_STENCIL_BACKEND = "xla"


def _params_to_dict(p):
    return None if p is None else dataclasses.asdict(p)


def _gcr_from_dict(d):
    return GCRParams(**d) if d is not None else None


def _mg_params_from_dict(d) -> MGParams:
    d = dict(d)
    for key in ("setup_gcr", "coarse_gcr", "smoother_gcr"):
        d[key] = _gcr_from_dict(d.get(key))
    if isinstance(d.get("block"), list):
        d["block"] = tuple(d["block"])
    return MGParams(**d)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _save_cdata(cdata, p: str, arrays: dict) -> None:
    """A complex tensor or a CF as the split pair ``coarse_re/_im``."""
    c = cplx.ascf(cdata)
    arrays[p + "coarse_re"] = _np(c.re)
    arrays[p + "coarse_im"] = _np(c.im)


def _load_cdata(z, p: str, meta: dict, dev) -> cplx.CF:
    if meta["cf"]:
        return cplx.CF(torch.as_tensor(z[p + "coarse_re"]).to(dev),
                       torch.as_tensor(z[p + "coarse_im"]).to(dev))
    return cplx.ascf(torch.as_tensor(z[p + "coarse"]).to(dev))


def _coarse_to_arrays(coarse, p: str, arrays: dict) -> tuple[str, dict]:
    """Serialise a (replicated) coarse operator; returns (kind, extra)."""
    extra = {}
    if isinstance(coarse, DenseOperator):
        kind, cdata = "dense", coarse.a
    elif isinstance(coarse, BlockSparseOperator):
        kind, cdata = "bsr", coarse.blocks
        arrays[p + "coarse_cols"] = _np(coarse.block_cols).astype(np.int32)
    elif isinstance(coarse, StencilBlockOperator):
        kind, cdata = "stencil", coarse.blocks
        extra["coarse_dims"] = list(coarse.dims)
        extra["coarse_backend"] = _STENCIL_BACKEND
    else:
        raise TypeError(f"unsupported coarse operator {type(coarse)!r}")
    _save_cdata(cdata, p, arrays)
    return kind, extra


def _coarse_from_arrays(z, p: str, meta: dict, dev):
    c = _load_cdata(z, p, meta, dev)
    if meta["coarse_kind"] == "dense":
        return DenseOperator(torch.complex(c.re, c.im))
    if meta["coarse_kind"] == "stencil":
        return StencilBlockOperator(c, tuple(meta["coarse_dims"]))
    return BlockSparseOperator(torch.complex(c.re, c.im), np.asarray(z[p + "coarse_cols"]))


def _blocked_basis(mgp: MGPreconditioner) -> cplx.CF:
    """The level's blocked basis (ne, nb, block_len): ``q``, or, on the slab
    layout, ``q_field`` relaid out one vector at a time."""
    if mgp.layout != "tpu":
        return mgp.q
    bm = mgp.block_map
    return cplx.stack([bm.to_blocked_tpu(mgp.q_field[e]) for e in range(mgp.q_field.shape[0])])


def _collect_level(mgp: MGPreconditioner, p: str, arrays: dict) -> dict:
    """Serialise one level's arrays under key prefix ``p``; returns meta."""
    q = _blocked_basis(mgp)
    arrays[p + "q_re"] = _np(q.re)
    arrays[p + "q_im"] = _np(q.im)
    del q
    coarse_kind, extra = _coarse_to_arrays(mgp.coarse, p, arrays)
    return {
        "layout": mgp.layout,
        "cf": True,
        "coarse_kind": coarse_kind,
        "mesh_dims": list(mgp.block_map.mesh.dims),
        "n_spacetime": mgp.block_map.mesh.n_spacetime,
        "block_dims": list(mgp.block_map.block_dims),
        "params": _params_to_dict(mgp.params),
        **extra,
    }


def save_mg_setup(path: str | os.PathLike, mgp: MGPreconditioner) -> None:
    """Persist every level of the (possibly multi-level) MG hierarchy."""
    arrays: dict[str, np.ndarray] = {}
    levels = []
    node = mgp
    i = 0
    while node is not None:
        levels.append(_collect_level(node, f"l{i}_", arrays))
        node = node.coarse_precond
        i += 1
    meta = {"version": _FORMAT_VERSION, "levels": levels}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def _load_level(z, p: str, meta: dict, a, dev, a_smooth=None):
    """One level around fine operator ``a``; returns (preconditioner without
    its deeper level, its coarse operator). Arrays go to ``dev`` in the
    file's dtypes (the slab basis in ``params.transfer_dtype`` when that is
    set), as the JAX package loads them."""
    mesh = LatticeMesh(tuple(meta["mesh_dims"]), meta["n_spacetime"])
    block_map = mesh.blocking(tuple(meta["block_dims"]))
    params = _mg_params_from_dict(meta["params"])
    if meta["cf"]:
        q = cplx.CF(torch.as_tensor(z[p + "q_re"]), torch.as_tensor(z[p + "q_im"]))
    else:
        q = cplx.ascf(torch.as_tensor(z[p + "q"]))
    q = q.to(dev)
    coarse = _coarse_from_arrays(z, p, meta, dev)
    q_field = None
    if meta["layout"] == "tpu":  # derived, not stored: a pure relayout of q
        q_field, q = field_basis(q, block_map), None
        if params.transfer_dtype is not None:
            q_field = q_field.astype(_STORAGE[params.transfer_dtype])
    return MGPreconditioner(a, q_field, coarse, block_map, params, a_smooth, q,
                            meta["layout"]), coarse


def _load_levels(z, levels: list, fine_op, dev, a_smooth=None):
    """The hierarchy of ``levels`` below ``fine_op``: coarse operators
    top-down, then preconditioners bottom-up."""
    built = []
    for i, lv in enumerate(levels):
        node, coarse = _load_level(z, f"l{i}_", lv, fine_op, dev, a_smooth if i == 0 else None)
        built.append(node)
        fine_op = coarse
    result = None
    for node in reversed(built):
        result = dataclasses.replace(node, coarse_precond=result)
    return result


def load_mg_setup(path: str | os.PathLike, a, smoother_operator=None) -> MGPreconditioner:
    """Rebuild the MG hierarchy around fine operator ``a``, on its device;
    each deeper level's fine operator is the previous level's coarse
    operator. ``smoother_operator`` is the first level's ``a_smooth`` (not
    stored, as in the JAX package)."""
    dev = getattr(a, "d", a).device
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown MG checkpoint version {meta['version']}")
        if meta.get("sharded"):
            raise ValueError("a sharded MG checkpoint (use load_mg_setup_sharded)")
        return _load_levels(z, meta["levels"], a, dev, smoother_operator)


# ---------------------------------------------------------------------------
# sharded hierarchy (solvers/mg_dist.py ShardedMGPreconditioner)
# ---------------------------------------------------------------------------
def save_mg_setup_sharded(path: str | os.PathLike, smgp) -> None:
    """Persist a sharded MG hierarchy; every rank must call it together,
    and rank 0 writes the file. The ranks' blocked bases are gathered into
    the global ``q5`` (ne, Bt, Bz, By*Bx, block_len), the JAX package's
    layout, and a shard-local stencil coarse level into its global rows
    ("stencil_sharded"). The shard geometry is not stored: it is derived at
    load from the operator's grid, so the file loads onto any grid with the
    same axis extents. Deeper replicated levels use the single-device
    level format."""
    from mgpgcr_tpu_torch.solvers.mg_dist import ShardLocalCoarseStencil

    from mgpgcr_tpu_torch.parallel.mesh import join_shards

    comm, geom = smgp.comm, smgp.geom
    dims = {geom.axis_t: 1, geom.axis_z: 2}
    q5 = join_shards(comm.all_gather(smgp.q5), geom.grid, dims)
    coarse = smgp.coarse
    blocks = None
    if isinstance(coarse, ShardLocalCoarseStencil):
        blocks = geom.gather_blocked(coarse.blocks, comm)
    if comm.rank != 0:
        comm.barrier()
        return
    arrays: dict[str, np.ndarray] = {"q5_re": _np(q5.re), "q5_im": _np(q5.im)}
    del q5
    if blocks is not None:
        coarse_kind, extra = "stencil_sharded", {}
        _save_cdata(blocks, "c_", arrays)
    else:
        coarse_kind, extra = _coarse_to_arrays(coarse, "c_", arrays)
    levels = []
    node = smgp.coarse_precond
    i = 0
    while node is not None:
        levels.append(_collect_level(node, f"l{i}_", arrays))
        node = node.coarse_precond
        i += 1
    meta = {
        "version": _FORMAT_VERSION,
        "sharded": True,
        "cf": True,
        "block": list(geom.block),
        "coarse_kind": coarse_kind,
        "params": _params_to_dict(smgp.params),
        "levels": levels,
        **extra,
    }
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)
    comm.barrier()


def load_mg_setup_sharded(path: str | os.PathLike, a):
    """Rebuild this rank's ``ShardedMGPreconditioner`` around ``a``, a
    ``DiracOperator`` over this rank's ``ShardLocalWilsonDirac``: the
    rank's slice of ``q5`` (as the field-shaped basis) and of the stencil
    rows go to the operator's device; replicated coarse operators and any
    deeper hierarchy load whole on every rank."""
    from mgpgcr_tpu_torch.parallel.mesh import cut_shard
    from mgpgcr_tpu_torch.solvers.mg_dist import (
        ShardedMGPreconditioner,
        ShardLocalCoarseStencil,
        _geometry,
        _replicated_stencil,
        _unwrap,
    )

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown MG checkpoint version {meta['version']}")
        if not meta.get("sharded"):
            raise ValueError("not a sharded MG checkpoint (use load_mg_setup)")
        params = _mg_params_from_dict(meta["params"])
        d, _ = _unwrap(a)
        geom = _geometry(d, params.block)
        dev = d.device
        if tuple(meta["block"]) != geom.block:
            raise ValueError(f"checkpoint block {meta['block']} against {geom.block}")

        def local(host, dims):
            return cut_shard(torch.as_tensor(host), geom.grid, geom.rank, dims).to(dev)

        qdims = {geom.axis_t: 1, geom.axis_z: 2}
        q5 = cplx.CF(local(z["q5_re"], qdims), local(z["q5_im"], qdims))
        ne = q5.shape[0]
        lbm = geom.local_block_map()
        q_field = field_basis(q5.reshape(ne, geom.nb_loc, lbm.block_len), lbm)
        if params.transfer_dtype is not None:
            q_field = q_field.astype(_STORAGE[params.transfer_dtype])

        fine_op = None
        if meta["coarse_kind"] == "stencil_sharded":
            cdims = {geom.axis_t: 0, geom.axis_z: 1}
            blocks = torch.complex(local(z["c_coarse_re"], cdims), local(z["c_coarse_im"], cdims))
            coarse = ShardLocalCoarseStencil(blocks, geom, d.comm)
            if meta.get("levels"):
                # the deeper levels' fine operator: the replicated twin of
                # the shard-local stencil, the same global blocks
                full = torch.complex(torch.as_tensor(z["c_coarse_re"]),
                                     torch.as_tensor(z["c_coarse_im"])).to(dev)
                fine_op = _replicated_stencil(full.reshape(geom.nb, 9, ne, ne), geom)
        else:
            coarse = _coarse_from_arrays(z, "c_", meta, dev)
            fine_op = coarse
        coarse_precond = _load_levels(z, meta.get("levels", []), fine_op, dev)
        return ShardedMGPreconditioner(a, q_field, coarse, geom, params, coarse_precond)
