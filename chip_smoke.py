#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mgpgcr_tpu_torch``) on one GPU.

Drives the port's main paths at the flagship 32^4 size: the 16^4
beta = 6.0 gauge field of ``data/links_16_b6.0_s0.npz`` tiled twice along
t, z, y and x, the Wilson-Dirac operator with two-row f32 links and the
in-kernel anti-periodic t boundary, A = I - 0.125 D, and restart-5 GCR to
1e-6: first plain, then right-preconditioned by the two-level multigrid
V-cycle (block 8^4, 6 null vectors, GCR(4) smoother on bf16 links, dense
coarse operator), each in the fused restart-cycle form (the hand-written
kernels) and the generic form; then the fused loop form on direction
stacks (restart with unroll="loop", truncation, residual refresh, MG under
unroll="auto") and the fused eager MG loop; then the reference's MG config
of record (block 4^4, 10 null vectors, smoother off, block-stencil coarse
operator of 81,920 unknowns; and the block-ELL one from the same blocks),
a three-level MG (the block-8 cell with block-stencil coarse operators on
4^4 and 2^4 blocks), and the plain fused solve on mu-major 3-row links
(``build(..., tb=2, zb=8)``); then the plain solve domain-decomposed over
(t, z) shards, ranks as threads sharing the card and as a one-process NCCL
group; then the seventh slice: mixed-precision refinement, low eigenpairs,
the even-odd Schur solve (plain and with MG), the heat bath on the card and
matrix ingestion; then the eighth: the command line in this process, MG
checkpoints, the sharded MG setup and solve, the sharded even-odd solve and
the driver's entry points (``__graft_entry_cuda__.py``).

Phases, each printed as one JSON line with its wall seconds:
  device    the card's name and power limit (nvidia-smi);
  build     the one nvcc call that builds csrc/*.cu;
  registers the registers, spill bytes and shared memory of every
            kernel instance (the step template's K2, B9 and B15 among
            them), from the build's -Xptxas -v report;
  oracle    the Dslash kernel against the numpy oracle on a 4^4 lattice;
  parity    every kernel against its plain PyTorch version at 32^4 (and
            B12 at the coarse grids of the MG paths);
  timing    CUDA-event times of each kernel, its plain version, its bound,
            and one PyTorch call computing the same function where there is
            one (an einsum or a matrix product for K3, K4, B2, B3, B6, B7,
            B10, B11 and B12, each checked against the plain version); for
            K1, K2, B9, B12 (every shape) and B13 also the time with the
            host out of the window (graph_ms: the wrapper calls captured in
            a CUDA graph and replayed), beside the wrapper's event time;
  solve     the plain path: both solve forms (two runs each, in turns),
            iteration counts, ms per iteration, the independent f64
            residual, launch counts;
  mg_setup  the MG setup's seconds per phase and its property checks;
  mg_solve  the MG path: both solve forms, outer iterations, ms per outer
            iteration, the V-cycle breakdown, the independent f64
            residual, launch counts;
  loop_solve  the loop-form and eager paths: iterations (and where the
            history first reaches the tolerance), ms per iteration, the
            independent f64 residual, launch counts;
  mg_record_setup, mg_record_solve  the config of record: setup seconds
            by phase, peak GiB, the coarse dimension, Galerkin P^H A P = C
            through the block-stencil kernel, the block-ELL apply against
            it, outer iterations and ms with each coarse format, the
            independent f64 residual, launches;
  mg_three_level  the three-level setup and solve, launches by phase;
  mu_major  the plain fused solve on mu-major links: iterations, ms, the
            independent f64 residual, launches (B13, and no one-pass step);
  dist_kernels  the ghost-plane kernels B14 and B15 on every rank of the
            (2, 2) and (4, 1) grids of ranks sharing the card and of a
            one-rank grid (the shard shapes of the dist solves), against
            their plain versions and, gathered, against K1 and K2; the host
            time of one exchange on each grid; their times (over short and
            long windows, in turns, and in a CUDA graph) and bounds on a
            16x16x32x32 shard of the (2, 2) grid;
  dist_solve  the plain cell's fused solve domain-decomposed over (t, z):
            (2, 2) and (4, 1) grids of ThreadComm ranks on the card, each
            timed four times in turns at interpreter switch intervals of
            5, 0.5, 50 and 5 ms, and a world-size-1 NCCL group;
            iterations, host ms per iteration, launches, the independent
            f64 residual of the gathered x;
  refine    the plain cell as the inner solve of mixed-precision
            refinement, the complex128 residual on the card, to 1e-10:
            rounds, inner iterations, history, ms per round;
  eigen     smallest_eigenpairs(n=4) of the plain operator: values,
            residuals, orthonormality;
  eo_solve  the plain cell through the even-odd Schur complement
            (from_dirac on 3-row links): iterations against the full
            solve's, ms per iteration, the host ms of one Schur apply, the
            independent f64 residual of the reconstructed x;
  eo_mg     setup_eo_mg (block 8, 6 null vectors, the half mesh) and the
            MG-preconditioned Schur solve on the 16^4 field: setup seconds
            by phase, outer iterations against the plain Schur solve's, ms,
            residual, and the column assembly's time estimate at 32^4;
  gauge     two heat-bath sweeps at 32^4 from a hot start, 20 at 8^4 from
            a cold start (plaquette band), SU(3) errors, a solve on the
            generated links;
  ingest    the 8^4 field as a CSR matrix: parsed.txt (native, numpy) and
            .npz round trips, Wilson detection, the routed operator and its
            solve against the direct one, B12 on the ingested stencil;
  cli       ``mgpgcr_tpu_torch.cli.main`` in this process: the 32^4 cf32
            solves (plain fused restart 5; --mg block 8, 6 null vectors;
            --mg with the block-stencil coarse operator, block 4, 10 null
            vectors, smoother off; --eo), a 3-point ksweep at 16^4,
            generate at 8^4 then solve --matrix (detection); each converged
            with its independent residual <= 2e-6 and its kernels launched;
            one ``python -m mgpgcr_tpu_torch info`` subprocess;
  checkpoint  save_mg_setup / load_mg_setup of the MG cell's hierarchy on the
            16^4 field (the 32^4 times estimated): the loaded V-cycle bit-equal,
            the same outer iterations;
  mg_dist   setup_mg_sharded and mg_gcr_solve_sharded: a world-size-1 NCCL
            group at 32^4 (the MG cell's parameters) and the (2, 2) and (4, 1)
            grids of thread ranks at 16^4, outer iterations within 1 of the
            single-device solves, setup seconds by phase, host ms per outer
            iteration, launches; B10, B11, B14 and B15 against their plain
            versions at every shard shape;
  eo_dist   the Schur solve on (t, z) shards (eo_sharded): a (2, 2) thread
            grid at 16^4 and a world-size-1 NCCL group at 32^4, iterations
            against eo_solve's;
  graft     __graft_entry_cuda__'s entry() step and dryrun_multichip(4).
The parity phase also holds B2, B3, K3, K4 on half-size fields and B10,
B11 on the half mesh's blocks; eo_mg and ingest add B10/B11 at their half
mesh and B12 at the ingested stencil. Then the kernel table, the card
line and the result line. Any failed check raises, and the script exits non-zero. Run: ``python3 chip_smoke.py``
(``--profile`` adds a torch.profiler breakdown of the fused solves).
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
FIELD_TOL = 1e-5  # max |kernel - plain| / max |plain| for fields
DOT_TOL = 1e-4  # relative error of reductions against the f64 plain version
GALERKIN_TOL = 1e-4  # f32 P^H A P against the assembled coarse matrix
K = 0.125
RESTART = 5
MG_BLOCK = 8
MG_NULLVECS = 6
DSLASH_FLOPS_PER_SITE = 1320  # 8 hops: projection, SU(3) x half spinor, reconstruction
RECON_FLOPS = 8 * 3 * 14  # row 2 of each of the 8 links: 6 complex mul + 3 sub
K_FLOPS = 12 * 8  # psi - k D psi
FIELD_B = 96  # bytes per site of one f32 field
LINK_B = {(3, "f32"): 288, (2, "f32"): 192, (3, "bf16"): 144, (2, "bf16"): 96}
PLAIN_KERNELS = ("dslash_apply", "gcr_stream_step", "ap_update", "basis_flush")
MG_KERNELS = PLAIN_KERNELS + ("update_r", "gcr_z_step", "restrict", "prolong")
REPLACES = {
    "dslash_apply": ("dslash", "mgpgcr_tpu/ops/pallas/dslash.py:268", "csrc/dslash.cu"),
    "gcr_stream_step": ("gcr_stream_step", "mgpgcr_tpu/ops/pallas/gcr_dslash.py:57",
                        "csrc/gcr_dslash.cu"),
    "ap_update": ("ap_update", "mgpgcr_tpu/ops/pallas/gcr_kernels.py:342",
                  "csrc/gcr_kernels.cu"),
    "basis_flush": ("basis_flush", "mgpgcr_tpu/ops/pallas/gcr_kernels.py:441",
                    "csrc/gcr_kernels.cu"),
    "update_r": ("update_r", "mgpgcr_tpu/ops/pallas/gcr_kernels.py:519", "csrc/gcr_kernels.cu"),
    "gcr_z_step": ("gcr_z_step", "mgpgcr_tpu/ops/pallas/gcr_dslash.py:397",
                   "csrc/gcr_dslash.cu"),
    "restrict": ("restrict", "mgpgcr_tpu/ops/pallas/transfer.py:96", "csrc/transfer.cu"),
    "prolong": ("prolong", "mgpgcr_tpu/ops/pallas/transfer.py:186", "csrc/transfer.cu"),
    "update_xr": ("update_xr", "mgpgcr_tpu/ops/pallas/gcr_kernels.py:93", "csrc/gcr_loop.cu"),
    "beta_dots": ("beta_dots", "mgpgcr_tpu/ops/pallas/gcr_kernels.py:171", "csrc/gcr_loop.cu"),
    "dir_update": ("dir_update", "mgpgcr_tpu/ops/pallas/gcr_kernels.py:225",
                   "csrc/gcr_loop.cu"),
    "stencil_spmv": ("stencil_spmv", "mgpgcr_tpu/ops/pallas/spmv.py:66", "csrc/spmv.cu"),
    "dslash_mu": ("dslash_mu", "mgpgcr_tpu/ops/pallas/dslash.py:83", "csrc/dslash.cu"),
    "dslash_dist": ("dslash_dist", "mgpgcr_tpu/ops/pallas/dslash_dist.py:55", "csrc/dslash.cu"),
    "gcr_stream_step_dist": ("gcr_stream_step_dist",
                             "mgpgcr_tpu/ops/pallas/gcr_dslash_dist.py:107",
                             "csrc/gcr_dslash.cu"),
}
REC_BLOCK, REC_NULLVECS = 4, 10  # the config of record (MGParams() defaults)
# B12's shapes on the MG paths: (grid of blocks, ne); the config of
# record's coarse level, and levels 2 and 3 of the three-level cell
SPMV_SHAPES = {"record": ((8, 8, 8, 8), 20), "level2": ((4, 4, 4, 4), 12),
               "level3": ((2, 2, 2, 2), 12)}
BIG_LIM = 20  # beta_dots past one chunk of 8 rows, lim past the cycles form's 16
TURN_ROUNDS = 5  # rounds of cycles, loop, loop, cycles in the loop/cycles comparison
DIST_SHARD = (2, 2)  # the (t, z) grid of the ghost-plane kernel checks: 16x16x32x32 shards
DIST_GRIDS = ((2, 2), (4, 1))  # the domain-decomposed solves' (t, z) grids
# B14/B15 are held to their plain versions at every shard shape the dist
# solves give them: the thread grids' and the world-1 group's one 32^4
# shard (t ghosts its own signed wrap planes, z wrapped in the kernel)
DIST_KERNEL_GRIDS = tuple((g, ("t", "z")) for g in DIST_GRIDS) + (((1,), ("t",)),)
EXCHANGE_REPS = 20  # exchanges of faces timed on the host
DIST_LONG_CALLS = 400  # B14/B15 calls in the long timing window (each tens of us)
# interpreter switch intervals (s) of the thread grids' timed solves, in
# turns: the default, 10x shorter, 10x longer, the default again
SWITCH_INTERVALS = (0.005, 0.0005, 0.05, 0.005)
# the kernels timed with the host out of the event window (graph_ms): ms
# per call, by wrapper name, for the kernels line and the timing phases
HOST_FREE: dict[str, float] = {}
REFINE_TOL = 1e-10  # the refine phase's true complex128 relative residual
PLAQ_B6, PLAQ_BAND = 0.5937, 0.05  # <P> at beta = 6.0 and tests/test_gauge.py's band


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref| / max |ref|, max |got - ref|) over a CF or tensor."""
    from mgpgcr_tpu_torch import cplx

    if cplx.is_cf(got):
        d = max(float((got.re - ref.re).abs().max()), float((got.im - ref.im).abs().max()))
        s = max(float(ref.re.abs().max()), float(ref.im.abs().max()))
    else:
        d = float((got.to(ref.dtype) - ref).abs().max())
        s = float(ref.abs().max())
    return d / s, d


def f64(x):
    import torch

    from mgpgcr_tpu_torch import cplx

    return x.astype(torch.float64) if cplx.is_cf(x) else x.to(torch.complex128)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 1, launches: int = 20, replays: int = 10) -> float:
    """Mean ms per kernel call of ``fn`` (which makes ``calls`` wrapper
    calls) with the host out of the event window: ``launches`` calls of
    ``fn`` captured in one CUDA graph after a warm-up, the graph replayed
    once, then ``replays`` times between CUDA events. The wrappers' checks
    and allocations run at capture only; the replays launch the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * launches * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_ms(fn, reps: int = 5) -> float:
    """Mean ms per call of ``fn`` on the host clock, synchronised, after one
    warm-up call: for pieces that wait on the host themselves."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def strip_params(name: str) -> str:
    """A demangled function name without its parameter list (the first "("
    outside the template arguments)."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def ptxas_report(text: str) -> list[dict]:
    """Registers, spill bytes and shared memory of each kernel, from nvcc's
    ``-Xptxas -v`` messages, names demangled where the toolkit's demangler
    is found."""
    import shutil

    entries, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"mangled": m.group(1)}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None and Path("/usr/local/cuda/bin/cu++filt").exists():
        tool = "/usr/local/cuda/bin/cu++filt"
    if tool and entries:
        out = subprocess.run([tool], input="\n".join(e["mangled"] for e in entries),
                             capture_output=True, text=True).stdout.splitlines()
        if len(out) == len(entries):
            for e, name in zip(entries, out):
                e["name"] = strip_params(name).replace("mg::", "")
    for e in entries:
        e.setdefault("name", e["mangled"])
        del e["mangled"]
    return entries


def profile_solve(a, b, params, card: str, precond=None, label: str = "profile") -> None:
    """torch.profiler over one fused solve: device time by kernel and the
    device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mgpgcr_tpu_torch import gcr_solve

    t1 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        res = gcr_solve(a, b, params, precond=precond)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - s0)
    kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kern.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    emit(label, t1, card=card, iters=res.n_iters, wall_ms=wall_ms, device_ms=device_ms,
         idle_share=1 - device_ms / wall_ms, launches=sum(e.count for e in kern),
         top=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in kern[:12]])


def mg_kernel_parity(mesh, variants, gen, note, S: int):
    """B2, B9, B10 and B11 against their plain versions at 32^4 (the field
    outputs against f32, the reductions against f64 plain versions).
    Returns the inputs the timing phase reuses."""
    import torch

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_z_step, gcr_z_step_plain
    from mgpgcr_tpu_torch.kernels.gcr_kernels import update_r, update_r_plain
    from mgpgcr_tpu_torch.kernels.transfer import prolong, prolong_plain, restrict, restrict_plain

    dev = variants[(2, "f32")].device
    fshape = (4, 3) + tuple(variants[(2, "f32")].shape[i] for i in (0, 4, 5))
    r = cplx.random(gen, fshape, torch.float32, dev)
    z = cplx.random(gen, fshape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    kt = torch.tensor(K, dtype=torch.complex64, device=dev)
    r64, z64, aps64 = f64(r), f64(z), f64(aps)
    for slot in range(S):
        got = update_r(r, aps, slot, alpha)
        note("update_r", f"r'/slot={slot}", rel_err(got[0], update_r_plain(r, aps, slot, alpha)[0]),
             FIELD_TOL)
        note("update_r", f"r2/slot={slot}",
             rel_err(got[1], update_r_plain(r64, aps64, slot, f64(alpha))[1]), DOT_TOL)
    for lname in ("f32", "bf16"):  # the outer operator's links and the smoother's
        lt = variants[(2, lname)]
        for lim in range(1, S + 1):
            what = f"{lname}/2row/lim={lim}"
            out = gcr_z_step(lt, z, r, aps, kt, lim, mesh, anti_t=True)
            pl = gcr_z_step_plain(lt, z, r, aps, kt, lim, mesh, anti_t=True)
            p64 = gcr_z_step_plain(lt, z64, r64, aps64, f64(kt), lim, mesh, anti_t=True)
            note("gcr_z_step", f"az/{what}", rel_err(out[0], pl[0]), FIELD_TOL)
            note("gcr_z_step", f"raw/{what}", rel_err(out[1][:lim], p64[1][:lim]), DOT_TOL)
            note("gcr_z_step", f"apr/{what}", rel_err(out[2][:lim], p64[2][:lim]), DOT_TOL)
            note("gcr_z_step", f"azr/{what}", rel_err(out[2][S:], p64[2][S:]), DOT_TOL)
            check(bool((out[1][lim:] == 0).all()) and bool((out[2][lim:S] == 0).all()),
                  f"gcr_z_step rows from lim={lim} are zero")
    del r64, z64, aps64

    bm = mesh.blocking(MG_BLOCK)
    ne = 2 * MG_NULLVECS
    q = cplx.random(gen, (ne,) + fshape, torch.float32, dev)
    xc = cplx.random(gen, (bm.n_blocks * ne,), torch.float32, dev)
    for qname, qf in (("f32", q), ("bf16", q.astype(torch.bfloat16))):
        note("restrict", f"{qname}", rel_err(restrict(qf, bm, r), restrict_plain(qf, bm, r)),
             FIELD_TOL)
        note("prolong", f"{qname}", rel_err(prolong(qf, bm, xc), prolong_plain(qf, bm, xc)),
             FIELD_TOL)
        note("prolong", f"{qname}/base/damping=0.7",
             rel_err(prolong(qf, bm, xc, r, 0.7), prolong_plain(qf, bm, xc, r, 0.7)), FIELD_TOL)
    return dict(r=r, z=z, aps=aps, alpha=alpha, kt=kt, q=q, xc=xc, bm=bm)


def mg_kernel_timing(mesh, variants, inp, S: int, table: dict) -> dict:
    """CUDA-event times of B2, B9, B10 and B11 and of their plain versions,
    with their bounds; the bf16 link and basis variants on the side."""
    import torch

    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_z_step, gcr_z_step_plain
    from mgpgcr_tpu_torch.kernels.gcr_kernels import update_r, update_r_plain
    from mgpgcr_tpu_torch.kernels.transfer import prolong, prolong_plain, restrict, restrict_plain

    r, z, aps, alpha, kt = inp["r"], inp["z"], inp["aps"], inp["alpha"], inp["kt"]
    q, xc, bm = inp["q"], inp["xc"], inp["bm"]
    n_sites = mesh.n_sites
    lt = variants[(2, "f32")]

    ms = cuda_ms(lambda: [update_r(r, aps, s, alpha) for s in range(S)]) / S
    pms = cuda_ms(lambda: [update_r_plain(r, aps, s, alpha) for s in range(S)], reps=5,
                  warmup=1) / S
    # the library yardstick: r' = r - alpha aps[slot] as one einsum over the
    # stacked complex [r; aps[0]] with weights [1; -alpha] (leaves out ||r'||^2)
    st = torch.stack([flat_complex(r), flat_complex(aps[0])])
    w = torch.stack([torch.ones_like(alpha), -alpha])
    lms = cuda_ms(lambda: torch.einsum("m,mn->n", w, st))
    lib = torch.einsum("m,mn->n", w, st)
    check(rel_err(lib, flat_complex(update_r_plain(r, aps, 0, alpha)[0]))[0] <= FIELD_TOL,
          "update_r's einsum yardstick")
    del st, lib
    nbytes = 3 * n_sites * FIELD_B
    table["update_r"] = (ms, pms, *bound(nbytes, n_sites * 12 * 12), lms, nbytes)

    def zsteps(fn, links):
        for lim in range(1, S + 1):
            fn(links, z, r, aps, kt, lim, mesh, anti_t=True)

    ms = cuda_ms(lambda: zsteps(gcr_z_step, lt)) / S
    HOST_FREE["gcr_z_step"] = graph_ms(lambda: zsteps(gcr_z_step, lt), calls=S)
    pms = cuda_ms(lambda: zsteps(gcr_z_step_plain, lt), reps=3, warmup=1) / S
    extra = {"gcr_z_step_bf16_2row_ms": cuda_ms(lambda: zsteps(gcr_z_step,
                                                               variants[(2, "bf16")])) / S}
    # per call, averaged over one cycle's lim = 1..S: links, z, r, aps[0:lim] in, az out
    nbytes = sum(n_sites * (LINK_B[(2, "f32")] + (2 + lim) * FIELD_B + FIELD_B)
                 for lim in range(1, S + 1)) / S
    flops = sum(n_sites * (DSLASH_FLOPS_PER_SITE + RECON_FLOPS + K_FLOPS + (2 * lim + 1) * 96)
                for lim in range(1, S + 1)) / S
    table["gcr_z_step"] = (ms, pms, *bound(nbytes, flops), None, nbytes)

    ne = q.shape[0]
    nc = bm.n_blocks * ne
    t, zd, y, xx = mesh.spacetime_dims
    split = ()
    for nbd, b in zip(bm.blocks_per_dim, bm.block_dims):
        split += (nbd, b)
    q16 = q.astype(torch.bfloat16)
    # the library yardstick: one einsum over the conjugated complex basis,
    # built once outside the timed region
    qc = torch.complex(q.re, -q.im).reshape((ne, 12) + split)
    xcx = torch.complex(r.re, r.im).reshape((12,) + split)
    lms = cuda_ms(lambda: torch.einsum("ekTtZzYyXx,kTtZzYyXx->TZYXe", qc, xcx))
    lib = {"restrict": torch.einsum("ekTtZzYyXx,kTtZzYyXx->TZYXe", qc, xcx)}
    del qc, xcx
    # and for B11: the basis stacked with the base as one more vector, whose
    # coefficient is 1 in every block, the damping folded into the others
    damping = 0.7
    qs = torch.cat([torch.complex(q.re, q.im).reshape((ne, 12) + split),
                    torch.complex(r.re, r.im).reshape((1, 12) + split)])
    cs = torch.cat([damping * torch.complex(xc.re, xc.im).reshape(bm.blocks_per_dim + (ne,)),
                    torch.ones(bm.blocks_per_dim + (1,), dtype=qs.dtype, device=qs.device)], -1)
    plms = cuda_ms(lambda: torch.einsum("ekTtZzYyXx,TZYXe->kTtZzYyXx", qs, cs))
    lib["prolong"] = torch.einsum("ekTtZzYyXx,TZYXe->kTtZzYyXx", qs, cs)
    del qs, cs
    # the yardsticks compute the kernels' functions
    want = restrict_plain(q, bm, r)
    check(rel_err(lib["restrict"].reshape(-1), torch.complex(want.re, want.im))[0] <= FIELD_TOL,
          "restrict's einsum yardstick")
    want = prolong_plain(q, bm, xc, r, damping)
    check(rel_err(lib["prolong"].reshape(want.shape), torch.complex(want.re, want.im))[0]
          <= FIELD_TOL, "prolong's einsum yardstick")
    del lib, want
    for qname, qf in (("f32", q), ("bf16", q16)):
        qbytes = ne * 12 * n_sites * 2 * qf.re.element_size()
        rbytes = qbytes + n_sites * FIELD_B + nc * 8
        pbytes = qbytes + 2 * n_sites * FIELD_B + nc * 8
        rms = cuda_ms(lambda: restrict(qf, bm, r))
        pms_k = cuda_ms(lambda: prolong(qf, bm, xc, r, damping))
        if qname == "f32":
            rp = cuda_ms(lambda: restrict_plain(qf, bm, r), reps=3, warmup=1)
            pp = cuda_ms(lambda: prolong_plain(qf, bm, xc, r, damping), reps=3, warmup=1)
            table["restrict"] = (rms, rp, *bound(rbytes, ne * 12 * n_sites * 8), lms, rbytes)
            table["prolong"] = (pms_k, pp, *bound(pbytes, ne * 12 * n_sites * 8 + 12 * n_sites * 4),
                                plms, pbytes)
        else:
            extra["restrict_bf16_basis_ms"] = rms
            extra["restrict_bf16_basis_bound_ms"] = bound(rbytes, 0)[0]
            extra["prolong_bf16_basis_ms"] = pms_k
            extra["prolong_bf16_basis_bound_ms"] = bound(pbytes, 0)[0]
    return extra


def flat_complex(f):
    """A CF field (or stack of fields) as one complex tensor, flattened per
    field: the input of the library yardsticks, built outside their timing."""
    import torch

    lead = f.shape[:-5]
    return torch.complex(f.re, f.im).reshape(lead + (-1,))


def loop_kernel_parity(fshape, dev, gen, note, S: int):
    """B6, B3, B7 and K3's r form against their plain versions at 32^4 (the
    field outputs against f32, the reductions against f64 plain versions).
    Returns the inputs the timing phase reuses."""
    import torch

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.kernels.gcr_kernels import (
        ap_update, ap_update_plain, beta_dots, beta_dots_plain, dir_update, dir_update_plain,
        update_xr, update_xr_plain,
    )

    x, r, z, az = (cplx.random(gen, fshape, torch.float32, dev) for _ in range(4))
    ps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    betas = torch.complex(torch.rand(S, generator=gen, device=dev),
                          torch.rand(S, generator=gen, device=dev)) - (0.5 + 0.5j)
    x64, r64, z64, az64, ps64, aps64 = map(f64, (x, r, z, az, ps, aps))
    for slot in range(S):
        got = update_xr(x, r, ps, aps, slot, alpha)
        pl = update_xr_plain(x, r, ps, aps, slot, alpha)
        p64 = update_xr_plain(x64, r64, ps64, aps64, slot, f64(alpha))
        note("update_xr", f"x'/slot={slot}", rel_err(got[0], pl[0]), FIELD_TOL)
        note("update_xr", f"r'/slot={slot}", rel_err(got[1], pl[1]), FIELD_TOL)
        note("update_xr", f"r2/slot={slot}", rel_err(got[2], p64[2]), DOT_TOL)

    big = cplx.random(gen, (BIG_LIM,) + fshape, torch.float32, dev)
    cases = [(aps, aps64, lim) for lim in range(1, S + 1)] + [(big, f64(big), BIG_LIM)]
    for stack, stack64, lim in cases:
        got = beta_dots(stack, az, lim)
        note("beta_dots", f"raw/S={stack.shape[0]}/lim={lim}",
             rel_err(got[:lim], beta_dots_plain(stack64, az64, lim)[:lim]), DOT_TOL)
        check(bool((got[lim:] == 0).all()), f"beta_dots rows from lim={lim} are zero")
    del cases

    # restart: slot = lim % S, past the live prefix but at the cycle's end;
    # truncation: slots inside the prefix, rows the kernel reads and writes
    b64 = f64(betas)
    for rr, rr64, form in ((None, None, "r=None"), (r, r64, "r")):
        for lim, slot in [(lim, lim % S) for lim in range(1, S + 1)] + [(S, 1), (S, S - 2)]:
            what = f"{form}/lim={lim}/slot={slot}"
            got = dir_update(z, az, rr, ps.clone(), aps.clone(), betas, slot, lim)
            pl = dir_update_plain(z, az, rr, ps.clone(), aps.clone(), betas, slot, lim)
            p64 = dir_update_plain(z64, az64, rr64, ps64.clone(), aps64.clone(), b64, slot, lim)
            note("dir_update", f"p/{what}", rel_err(got[0][slot], pl[0][slot]), FIELD_TOL)
            note("dir_update", f"ap/{what}", rel_err(got[1][slot], pl[1][slot]), FIELD_TOL)
            note("dir_update", f"norm/{what}", rel_err(got[2], p64[2]), DOT_TOL)
            note("dir_update", f"apr/{what}", rel_err(got[3], p64[3]), DOT_TOL)
            keep = [j for j in range(S) if j != slot]
            check(all(bool((got[k][j].re == src[j].re).all() and (got[k][j].im == src[j].im).all())
                      for k, src in ((0, ps), (1, aps)) for j in keep),
                  f"dir_update {what} leaves the other rows")
    for lim in range(1, S + 1):  # K3's r form, as the cycles form calls it
        slot = lim % S
        got = ap_update(az, aps.clone(), betas, slot, lim, r=r)
        pl = ap_update_plain(az, aps.clone(), betas, slot, lim, r=r)
        p64 = ap_update_plain(az64, aps64.clone(), b64, slot, lim, r=r64)
        note("ap_update", f"r-form/ap/lim={lim}", rel_err(got[0][slot], pl[0][slot]), FIELD_TOL)
        note("ap_update", f"r-form/norm/lim={lim}", rel_err(got[1], p64[1]), DOT_TOL)
        note("ap_update", f"r-form/apr/lim={lim}", rel_err(got[2], p64[2]), DOT_TOL)
    del x64, r64, z64, az64, ps64, aps64
    return dict(x=x, r=r, z=z, az=az, ps=ps, aps=aps, alpha=alpha, betas=betas, big=big)


def loop_kernel_timing(inp, n_sites: int, S: int, table: dict, variants: dict) -> dict:
    """CUDA-event times of B6, B3, B7 (both forms) and K3's r form, their
    plain versions, bounds and library yardsticks. Every yardstick is one
    PyTorch call on complex tensors stacked outside the timed region,
    checked against the plain version; it writes new tensors (no in-place
    stack row) and leaves out the reductions named beside it."""
    import torch

    from mgpgcr_tpu_torch.kernels.gcr_kernels import (
        ap_update, ap_update_plain, beta_dots, beta_dots_plain, dir_update, dir_update_plain,
        update_xr, update_xr_plain,
    )

    x, r, z, az, ps, aps = (inp[k] for k in ("x", "r", "z", "az", "ps", "aps"))
    alpha, betas, big = inp["alpha"], inp["betas"], inp["big"]
    dev = alpha.device
    fb = n_sites * FIELD_B  # one f32 field
    lims = range(1, S + 1)

    def cycle(fn):
        for lim in lims:
            fn(lim)

    def mean(fn):
        return sum(fn(lim) for lim in lims) / S

    extra = {}
    # B6: x' = x + alpha p, r' = r - alpha ap in one einsum (leaves out ||r'||^2)
    ms = cuda_ms(lambda: [update_xr(x, r, ps, aps, s, alpha) for s in range(S)]) / S
    pms = cuda_ms(lambda: [update_xr_plain(x, r, ps, aps, s, alpha) for s in range(S)],
                  reps=5, warmup=1) / S
    st = torch.stack([torch.stack([flat_complex(x), flat_complex(ps[0])]),
                      torch.stack([flat_complex(r), flat_complex(aps[0])])])
    w = torch.stack([torch.stack([torch.ones_like(alpha), alpha]),
                     torch.stack([torch.ones_like(alpha), -alpha])])
    lms = cuda_ms(lambda: torch.einsum("km,kmn->kn", w, st))
    lib = torch.einsum("km,kmn->kn", w, st)
    want = update_xr_plain(x, r, ps, aps, 0, alpha)
    for got, ref in zip(lib, want[:2]):
        check(rel_err(got, flat_complex(ref))[0] <= FIELD_TOL, "update_xr's einsum yardstick")
    del st, lib, want
    table["update_xr"] = (ms, pms, *bound(6 * fb, n_sites * 12 * 20), lms, 6 * fb)

    # B3: raw = conj(aps[0:lim]) @ az, one complex matrix-vector product
    ms = cuda_ms(lambda: cycle(lambda lim: beta_dots(aps, az, lim))) / S
    pms = cuda_ms(lambda: cycle(lambda lim: beta_dots_plain(aps, az, lim)), reps=5,
                  warmup=1) / S
    apc, azc = torch.complex(aps.re, -aps.im).reshape(S, -1), flat_complex(az)
    lms = cuda_ms(lambda: cycle(lambda lim: apc[:lim] @ azc)) / S
    ref = beta_dots_plain(f64(aps), f64(az), S)
    check(rel_err(apc @ azc, ref)[0] <= DOT_TOL, "beta_dots's matrix-vector yardstick")
    del apc, ref
    nbytes = mean(lambda lim: (lim + 1) * fb)
    table["beta_dots"] = (ms, pms, *bound(nbytes, mean(lambda lim: n_sites * 12 * 8 * lim)),
                          lms, nbytes)
    extra["beta_dots_lim20_ms"] = cuda_ms(lambda: beta_dots(big, az, BIG_LIM))
    extra["beta_dots_lim20_bound_ms"] = bound((BIG_LIM + 1) * fb, 0)[0]
    bigc = torch.complex(big.re, -big.im).reshape(BIG_LIM, -1)
    extra["beta_dots_lim20_library_ms"] = cuda_ms(lambda: bigc @ azc)
    del bigc, azc

    # B7: [p; ap] = sum_m w_m [[z, az]; [ps_j, aps_j]] with w = [1; -beta], one
    # einsum (leaves out ||ap||^2 and <ap, r>); K3 the same on [az; aps]
    sps, saps = ps.clone(), aps.clone()
    for form, rr in (("r=None", None), ("r", r)):
        ms = cuda_ms(lambda: cycle(lambda lim: dir_update(z, az, rr, sps, saps, betas,
                                                           lim % S, lim))) / S
        pms = cuda_ms(lambda: cycle(lambda lim: dir_update_plain(z, az, rr, sps, saps, betas,
                                                                  lim % S, lim)),
                      reps=3, warmup=1) / S
        nbytes = mean(lambda lim: (2 * lim + 4 + (rr is not None)) * fb)
        flops = mean(lambda lim: n_sites * 12 * (16 * lim + 12))
        if rr is None:
            table["dir_update"] = (ms, pms, *bound(nbytes, flops), None, nbytes)
        else:
            variants["dir_update"] = {"r": {"ms": ms, "plain_ms": pms,
                                            "bound_ms": bound(nbytes, flops)[0]}}
    st = torch.stack([torch.stack([flat_complex(z), flat_complex(az)])]
                     + [torch.stack([flat_complex(ps[j]), flat_complex(aps[j])])
                        for j in range(S)])
    ws = {lim: torch.cat([torch.ones(1, dtype=betas.dtype, device=dev), -betas[:lim]])
          for lim in lims}
    lms = cuda_ms(lambda: cycle(lambda lim: torch.einsum("m,mkn->kn", ws[lim], st[:lim + 1])))
    lms /= S
    lib = torch.einsum("m,mkn->kn", ws[S], st)
    want = dir_update_plain(z, az, None, ps.clone(), aps.clone(), betas, 0, S)
    for got, ref in zip(lib, (want[0][0], want[1][0])):
        check(rel_err(got, flat_complex(ref))[0] <= FIELD_TOL, "dir_update's einsum yardstick")
    table["dir_update"] = table["dir_update"][:4] + (lms,) + table["dir_update"][5:]
    variants["dir_update"]["r"]["library_ms"] = lms
    del st, lib, want

    st3 = torch.cat([flat_complex(az)[None], flat_complex(aps)])
    lms3 = cuda_ms(lambda: cycle(lambda lim: ws[lim] @ st3[:lim + 1])) / S
    want = ap_update_plain(az, aps.clone(), betas, 0, S)
    check(rel_err(ws[S] @ st3, flat_complex(want[0][0]))[0] <= FIELD_TOL,
          "ap_update's matrix-vector yardstick")
    del st3, want
    table["ap_update"] = table["ap_update"][:4] + (lms3,) + table["ap_update"][5:]
    ms = cuda_ms(lambda: cycle(lambda lim: ap_update(az, saps, betas, lim % S, lim, r=r))) / S
    pms = cuda_ms(lambda: cycle(lambda lim: ap_update_plain(az, saps, betas, lim % S, lim, r=r)),
                  reps=5, warmup=1) / S
    nbytes = mean(lambda lim: (lim + 3) * fb)
    variants["ap_update"] = {"r": {"ms": ms, "plain_ms": pms,
                                   "bound_ms": bound(nbytes, mean(
                                       lambda lim: n_sites * 12 * (8 * lim + 12)))[0],
                                   "library_ms": lms3}}
    del sps, saps
    return extra


def new_kernel_parity(mesh, canon, variants, psi, kt, gen, note) -> dict:
    """B12 at the MG paths' three shapes (f32 and bf16 blocks; the duplicate
    slots of 2-extent grids hold zero blocks, as the Galerkin assembly
    leaves them), B13 against its plain version and against K1 on 3-row
    t-major links with the in-kernel sign, and B10/B11 at the config of
    record's block 4, ne 20. Returns the inputs the timing phase reuses."""
    import math

    import torch

    from mgpgcr_tpu_torch import CudaWilsonDirac, cplx
    from mgpgcr_tpu_torch.kernels.dslash import dslash_mu, dslash_mu_plain
    from mgpgcr_tpu_torch.kernels.spmv import stencil_spmv, stencil_spmv_plain
    from mgpgcr_tpu_torch.kernels.transfer import prolong, prolong_plain, restrict, restrict_plain

    dev = psi.device
    spmv = {}
    for name, (dims, ne) in SPMV_SHAPES.items():
        nb = math.prod(dims)
        blocks = cplx.random(gen, (nb, 2 * len(dims) + 1, ne, ne), torch.float32, dev)
        for d, ext in enumerate(dims):
            if ext <= 2:
                blocks[:, 2 + 2 * d] = cplx.zeros_like(blocks[:, 2 + 2 * d])
        x = cplx.random(gen, (nb * ne,), torch.float32, dev)
        spmv[name] = (dims, blocks, x)
        for bname, bl in (("f32", blocks), ("bf16", blocks.astype(torch.bfloat16))):
            note("stencil_spmv", f"{name}/{bname}",
                 rel_err(stencil_spmv(bl, x, dims), stencil_spmv_plain(bl, x, dims)), FIELD_TOL)

    mu = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev, tb=2, zb=8)
    check(not mu.t_major, "build(tb=2, zb=8) stores mu-major links")
    k1 = CudaWilsonDirac(variants[(3, "f32")], mesh, anti_t=True)
    for kk in (None, kt):
        got = dslash_mu(mu.links, psi, mesh, kk)
        note("dslash_mu", f"plain/k={kk is not None}",
             rel_err(got, dslash_mu_plain(mu.links, psi, mesh, kk)), FIELD_TOL)
        ref = k1.apply(psi) if kk is None else k1.apply_dirac(psi, kk)
        note("dslash_mu", f"K1-3row-anti_t/k={kk is not None}", rel_err(got, ref), FIELD_TOL)

    bm = mesh.blocking(REC_BLOCK)
    ne = 2 * REC_NULLVECS
    q = cplx.random(gen, (ne,) + psi.shape, torch.float32, dev)
    xc = cplx.random(gen, (bm.n_blocks * ne,), torch.float32, dev)
    for qname, qf in (("f32", q), ("bf16", q.astype(torch.bfloat16))):
        note("restrict", f"block4/ne20/{qname}",
             rel_err(restrict(qf, bm, psi), restrict_plain(qf, bm, psi)), FIELD_TOL)
        note("prolong", f"block4/ne20/{qname}/base",
             rel_err(prolong(qf, bm, xc, psi, 0.7), prolong_plain(qf, bm, xc, psi, 0.7)),
             FIELD_TOL)
    return dict(spmv=spmv, mu=mu, q=q, xc=xc, bm=bm)


def new_kernel_timing(mesh, inp, psi, kt, table: dict) -> dict:
    """CUDA-event times of B12 (at the config of record's coarse level, and
    its other shapes and bf16 blocks on the side) and B13, their plain
    versions and bounds; B12's library yardstick is the block-ELL einsum
    on the same blocks, over x gathered outside the timed region. B10/B11
    at block 4, ne 20 on the side."""
    import math

    import torch

    from mgpgcr_tpu_torch.kernels.dslash import dslash_mu, dslash_mu_plain
    from mgpgcr_tpu_torch.kernels.spmv import (
        stencil_neighbor_table, stencil_spmv, stencil_spmv_plain,
    )
    from mgpgcr_tpu_torch.kernels.transfer import prolong, restrict

    extra = {}

    def spmv_cost(dims, ne, bsize):
        nb = math.prod(dims)
        nbytes = nb * (2 * len(dims) + 1) * ne * ne * 2 * bsize + 2 * nb * ne * 8
        return nbytes, nb * (2 * len(dims) + 1) * ne * ne * 8

    for name, (dims, blocks, x) in inp["spmv"].items():
        ne = blocks.shape[-1]
        for bname, bl in (("f32", blocks), ("bf16", blocks.astype(torch.bfloat16))):
            ms = cuda_ms(lambda: stencil_spmv(bl, x, dims), reps=50)
            gms = graph_ms(lambda: stencil_spmv(bl, x, dims), launches=50)
            extra[f"stencil_spmv_{name}_{bname}_graph_ms"] = gms
            nbytes, flops = spmv_cost(dims, ne, bl.re.element_size())
            if name == "record" and bname == "f32":
                pms = cuda_ms(lambda: stencil_spmv_plain(bl, x, dims), reps=5, warmup=1)
                nb = math.prod(dims)
                tab = torch.as_tensor(stencil_neighbor_table(dims), dtype=torch.long,
                                      device=x.device)
                bc = torch.complex(blocks.re, blocks.im)
                xg = torch.complex(x.re, x.im).reshape(nb, ne)[tab]
                lms = cuda_ms(lambda: torch.einsum("rkij,rkj->ri", bc, xg), reps=50)
                lib = torch.einsum("rkij,rkj->ri", bc, xg).reshape(-1)
                want = stencil_spmv_plain(blocks, x, dims)
                check(rel_err(lib, torch.complex(want.re, want.im))[0] <= FIELD_TOL,
                      "stencil_spmv's block-ELL einsum yardstick")
                del bc, xg, lib
                table["stencil_spmv"] = (ms, pms, *bound(nbytes, flops), lms, nbytes)
                HOST_FREE["stencil_spmv"] = gms
            else:
                extra[f"stencil_spmv_{name}_{bname}_ms"] = ms
                extra[f"stencil_spmv_{name}_{bname}_bound_ms"] = bound(nbytes, flops)[0]

    n_sites = mesh.n_sites
    links = inp["mu"].links
    ms = cuda_ms(lambda: dslash_mu(links, psi, mesh, kt))
    HOST_FREE["dslash_mu"] = graph_ms(lambda: dslash_mu(links, psi, mesh, kt))
    pms = cuda_ms(lambda: dslash_mu_plain(links, psi, mesh, kt), reps=5, warmup=1)
    nbytes = n_sites * (LINK_B[(3, "f32")] + 2 * FIELD_B)
    table["dslash_mu"] = (ms, pms, *bound(nbytes, n_sites * (DSLASH_FLOPS_PER_SITE + K_FLOPS)),
                          None, nbytes)

    q, xc, bm = inp["q"], inp["xc"], inp["bm"]
    ne = q.shape[0]
    qbytes = ne * 12 * n_sites * 8
    nc = bm.n_blocks * ne
    extra["restrict_block4_ne20_ms"] = cuda_ms(lambda: restrict(q, bm, psi))
    extra["restrict_block4_ne20_bound_ms"] = bound(qbytes + n_sites * FIELD_B + nc * 8, 0)[0]
    extra["prolong_block4_ne20_ms"] = cuda_ms(lambda: prolong(q, bm, xc, psi, 0.7))
    extra["prolong_block4_ne20_bound_ms"] = bound(qbytes + 2 * n_sites * FIELD_B + nc * 8, 0)[0]
    return extra


def mg_path(canon, mesh, dev, card: str, independent_relres, profile: bool) -> dict:
    """MG setup and the MG-preconditioned restart-5 solve of the second
    slice, fused and generic, with the V-cycle breakdown. Returns the fused
    solve's launch counts, its outer iterations and what the loop path
    reuses: the operator, the right-hand side and the hierarchy."""
    import torch

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, MGParams, cplx, gcr_solve, kernels,
        setup_mg, with_link_dtype,
    )

    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    a_smooth = DiracOperator(with_link_dtype(op, torch.bfloat16), K)
    params = MGParams(block=MG_BLOCK, n_nullvecs=MG_NULLVECS)
    timings = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    mgp = setup_mg(torch.Generator(device=dev).manual_seed(3), a, mesh, params,
                   smoother_operator=a_smooth, timings=timings)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s0
    setup_counts = kernels.launch_counts()
    check(setup_counts["restrict"] > 0, "the Galerkin probes ran the restrict kernel")
    # properties: P^H P = I per block; P^H A P = C on random coarse vectors
    qb = mgp.block_map.to_blocked_tpu(mgp.q_field)
    qc = torch.complex(qb.re, qb.im)
    gram = torch.einsum("ebk,fbk->bef", qc.conj(), qc)
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=dev)
    orth = float((gram - eye).abs().amax())
    del qb, qc, gram
    check(orth <= 1e-4, f"P^H P = I per block: {orth}")
    nc = mgp.coarse.shape[0]
    gen = torch.Generator(device=dev).manual_seed(13)
    galerkin = []
    for _ in range(3):
        vc = cplx.random(gen, (nc,), torch.float32, dev)
        lhs = mgp.restrict(a.apply(mgp.prolong(vc)))
        galerkin.append(rel_err(lhs, mgp.coarse.apply(vc))[0])
    check(max(galerkin) <= GALERKIN_TOL, f"Galerkin P^H A P = C: {galerkin}")
    emit("mg_setup", t1, card=card, lattice=list(mesh.dims), block=MG_BLOCK,
         n_nullvecs=MG_NULLVECS, ne=2 * MG_NULLVECS, n_blocks=mgp.block_map.n_blocks,
         coarse_dim=nc, setup_seconds=setup_s, phase_seconds=timings,
         launches=setup_counts, orthonormality_err=orth, galerkin_rel_err=galerkin,
         galerkin_tol=GALERKIN_TOL, peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    t1 = time.perf_counter()
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    forms = {"fused": True, "generic": False}
    solves = {}
    for form, fused in forms.items():  # warm-up: first-call costs stay out of the time
        gcr_solve(a, b, GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=fused,
                                  unroll="cycles"), precond=mgp.apply)
    # two timed runs of each form, in turns: fused, generic, generic, fused
    for form in ("fused", "generic", "generic", "fused"):
        outer = GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=forms[form],
                          unroll="cycles")
        torch.cuda.synchronize()
        kernels.reset_launches()
        s0 = time.perf_counter()
        res = gcr_solve(a, b, outer, precond=mgp.apply)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        counts = kernels.launch_counts()
        check(res.converged, f"MG {form} solve converged")
        check(res.x.shape == op.field_shape and bool(torch.isfinite(res.x.re).all())
              and bool(torch.isfinite(res.x.im).all()), f"MG {form} solution finite")
        rel = independent_relres(res.x)
        check(rel <= 2e-6, f"MG {form} independent residual {rel} <= 2e-6")
        if form in solves:
            solves[form]["seconds"].append(wall)
            check(solves[form]["launches"] == counts and solves[form]["outer_iters"] == res.n_iters,
                  f"MG {form} runs repeat")
            continue
        solves[form] = {"outer_iters": res.n_iters, "relres": res.final_relres,
                        "independent_relres_f64": rel, "seconds": [wall],
                        "history": res.history_list(), "launches": counts}
    for v in solves.values():
        v["ms_per_outer_iter"] = [1e3 * w / max(v["outer_iters"], 1) for w in v["seconds"]]
    check(abs(solves["fused"]["outer_iters"] - solves["generic"]["outer_iters"]) <= 1,
          "MG fused and generic outer iteration counts within 1")
    mg_counts = solves["fused"]["launches"]
    check(all(mg_counts[k] > 0 for k in MG_KERNELS),
          f"every kernel of the MG path launched {mg_counts}")

    # the V-cycle's pieces on the right-hand side, as apply runs them
    sp, cp = params.smoother_gcr, params.coarse_gcr
    x_pre = gcr_solve(a_smooth, b, sp).x
    res_f = b - a.apply(x_pre)
    rc = mgp.restrict(res_f)
    coarse = gcr_solve(mgp.coarse, rc, cp)
    x_mid = mgp.prolong(coarse.x, base=x_pre, damping=params.correction_damping)
    vcycle = {
        "pre_smooth": host_ms(lambda: gcr_solve(a_smooth, b, sp)),
        "residual": host_ms(lambda: b - a.apply(x_pre)),
        "restrict": host_ms(lambda: mgp.restrict(res_f)),
        "coarse_solve": host_ms(lambda: gcr_solve(mgp.coarse, rc, cp)),
        "prolong": host_ms(lambda: mgp.prolong(coarse.x, base=x_pre)),
        "post_smooth": host_ms(lambda: gcr_solve(a_smooth, b, sp, x0=x_mid)),
        "apply": host_ms(lambda: mgp.apply(b)),
    }
    emit("mg_solve", t1, card=card, k=K, tol=1e-6, restart=RESTART, unroll="cycles",
         vcycle_ms=vcycle, coarse_iters=coarse.n_iters, **solves)
    if profile:
        profile_solve(a, b, GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=True,
                                      unroll="cycles"), card, mgp.apply, "mg_profile")
    return dict(counts=mg_counts, outer_iters=solves["fused"]["outer_iters"], a=a, b=b, mgp=mgp)


def loop_path(a, b, mgp, card: str, independent_relres, cycles_iters: dict,
              profile: bool) -> dict:
    """The fused loop form on direction stacks (restart with unroll="loop",
    truncation, residual refresh; MG under unroll="auto", the loop form with
    the z-step) and the fused eager MG loop checking every 4th iteration,
    on the plain path's operator and right-hand side. Each form runs once
    to warm up and twice timed; then the loop form and the cycles form run
    in turns, plain and MG. Returns the launch counts of each form's first
    timed run, summed, and the MG "auto" form's outer iterations."""
    import torch

    from mgpgcr_tpu_torch import GCRParams, gcr_solve, gcr_solve_eager, kernels

    t1 = time.perf_counter()
    plain = dict(tol=1e-6, max_iter=500)
    mg = dict(tol=1e-6, max_iter=200, restart=RESTART, fused=True)
    # truncation is another algorithm than restart: its count is held to
    # the generic solve with the same truncation
    trunc_generic = gcr_solve(a, b, GCRParams(truncation=RESTART, **plain)).n_iters
    forms = {
        "restart_loop": (lambda: gcr_solve(a, b, GCRParams(restart=RESTART, fused=True,
                                                           unroll="loop", **plain)),
                         cycles_iters["plain"], 2, ("update_xr", "beta_dots", "dir_update")),
        "truncation": (lambda: gcr_solve(a, b, GCRParams(truncation=RESTART, fused=True,
                                                         **plain)),
                       trunc_generic, 2, ("update_xr", "beta_dots", "dir_update")),
        "refresh": (lambda: gcr_solve(a, b, GCRParams(restart=RESTART, residual_refresh=10,
                                                      fused=True, **plain)),
                    cycles_iters["plain"], 2, ("update_xr", "beta_dots", "dir_update")),
        "mg_auto": (lambda: gcr_solve(a, b, GCRParams(**mg), precond=mgp.apply),
                    cycles_iters["mg"], 1, ("update_xr", "gcr_z_step", "dir_update")),
        "mg_eager": (lambda: gcr_solve_eager(a, b, GCRParams(**mg), precond=mgp.apply,
                                             check_every=4),
                     cycles_iters["mg"], 1, ("update_xr", "beta_dots", "dir_update")),
    }
    out, total = {}, {}
    for name, (run, want, slack, need) in forms.items():
        run()  # warm-up
        for _ in range(2):
            torch.cuda.synchronize()
            kernels.reset_launches()
            s0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
            counts = kernels.launch_counts()
            check(res.converged, f"{name} solve converged")
            check(res.x.shape == b.shape and bool(torch.isfinite(res.x.re).all())
                  and bool(torch.isfinite(res.x.im).all()), f"{name} solution finite")
            rel = independent_relres(res.x)
            check(rel <= 2e-6, f"{name} independent residual {rel} <= 2e-6")
            if name in out:
                out[name]["seconds"].append(wall)
                check(out[name]["launches"] == counts and out[name]["iters"] == res.n_iters,
                      f"{name} runs repeat")
                continue
            hist = res.history_list()
            # the eager loop reads the norm every 4th iteration and may run
            # up to 3 past the iteration that reached the tolerance
            reached = next(i for i, h in enumerate(hist) if h <= 1e-6)
            check(abs(reached - want) <= slack,
                  f"{name} reaches the tolerance at {reached}, against {want} +- {slack}")
            check(reached <= res.n_iters <= reached + (3 if name == "mg_eager" else 0),
                  f"{name} stops {res.n_iters} after reaching the tolerance at {reached}")
            check(all(counts[k] > 0 for k in need), f"{name} launched {need}: {counts}")
            out[name] = {"iters": res.n_iters, "reached_tol_at": reached, "compare_to": want,
                         "relres": res.final_relres, "independent_relres_f64": rel,
                         "seconds": [wall], "launches": counts}
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    for v in out.values():
        v["ms_per_iter"] = [1e3 * w / max(v["iters"], 1) for w in v["seconds"]]
    # the loop form against the cycles form on the host clock, in turns
    # (cycles, loop, loop, cycles per round), ms per iteration
    cycles = {"plain": lambda: gcr_solve(a, b, GCRParams(restart=RESTART, fused=True, **plain)),
              "mg": lambda: gcr_solve(a, b, GCRParams(unroll="cycles", **mg), precond=mgp.apply)}
    loops = {"plain": forms["restart_loop"][0], "mg": forms["mg_auto"][0]}
    turns = {}
    for key in cycles:
        ms = {"cycles": [], "loop": []}
        for form in ("cycles", "loop", "loop", "cycles") * TURN_ROUNDS:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            res = (cycles if form == "cycles" else loops)[key]()
            torch.cuda.synchronize()
            ms[form].append(1e3 * (time.perf_counter() - s0) / res.n_iters)
        turns[key] = {**ms, **{f"{f}_median": statistics.median(v) for f, v in ms.items()}}
    emit("loop_solve", t1, card=card, k=K, tol=1e-6, ring=RESTART, residual_refresh=10,
         eager_check_every=4, truncation_generic_iters=trunc_generic, forms=out,
         cycles_vs_loop_ms_per_iter=turns)
    if profile:
        profile_solve(a, b, GCRParams(restart=RESTART, fused=True, unroll="loop", **plain), card,
                      label="loop_profile")
        profile_solve(a, b, GCRParams(**mg), card, mgp.apply, "mg_loop_profile")
    return total, out["mg_auto"]["iters"]


def _timed_solve(run, b, independent_relres, what: str) -> dict:
    """One solve with the launch counts set to 0 just before and read just
    after; checks convergence, a finite solution of b's shape and the
    independent f64 residual."""
    import torch

    from mgpgcr_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    counts = kernels.launch_counts()
    check(res.converged, f"{what} solve converged")
    check(res.x.shape == b.shape and bool(torch.isfinite(res.x.re).all())
          and bool(torch.isfinite(res.x.im).all()), f"{what} solution finite")
    rel = independent_relres(res.x)
    check(rel <= 2e-6, f"{what} independent residual {rel} <= 2e-6")
    return {"iters": res.n_iters, "relres": res.final_relres, "independent_relres_f64": rel,
            "seconds": wall, "ms_per_iter": 1e3 * wall / max(res.n_iters, 1),
            "launches": counts}


def record_path(canon, mesh, dev, card: str, independent_relres, profile: bool) -> dict:
    """The reference's MG config of record (MGParams() defaults: block 4^4,
    10 null vectors, coarse GCR restart 10 / 50 iterations / tol 1e-2) with
    the smoother off and the block-stencil coarse operator; the block-ELL
    operator from the same blocks beside it. Returns the launch counts of
    the setup and the first stencil solve, summed."""
    import torch

    from mgpgcr_tpu_torch import (
        BlockSparseOperator, CudaWilsonDirac, DiracOperator, GCRParams, MGParams,
        StencilBlockOperator, cplx, gcr_solve, kernels, setup_mg,
    )

    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    params = MGParams(smoother_gcr=None, coarse_format="stencil")
    check((params.block, params.n_nullvecs) == (REC_BLOCK, REC_NULLVECS), "record defaults")
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    s0 = time.perf_counter()
    mgp = setup_mg(torch.Generator(device=dev).manual_seed(3), a, mesh, params, timings=timings)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s0
    setup_counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    nc = mgp.coarse.shape[0]
    check(isinstance(mgp.coarse, StencilBlockOperator) and nc == 81920,
          f"block-stencil coarse operator of 81920 unknowns: {nc}")
    check(setup_counts["restrict"] > 0, "the Galerkin probes ran the restrict kernel")
    qb = mgp.block_map.to_blocked_tpu(mgp.q_field)
    qc = torch.complex(qb.re, qb.im)
    del qb
    gram = torch.einsum("ebk,fbk->bef", qc.conj(), qc)
    del qc
    orth = float((gram - torch.eye(gram.shape[-1], dtype=gram.dtype, device=dev)).abs().amax())
    check(orth <= 1e-4, f"P^H P = I per block: {orth}")
    gen = torch.Generator(device=dev).manual_seed(13)
    blocks = mgp.coarse.blocks
    bsr = BlockSparseOperator(blocks, mgp.block_map.neighbor_table())
    galerkin, ell = [], []
    kernels.reset_launches()
    for _ in range(3):
        vc = cplx.random(gen, (nc,), torch.float32, dev)
        cv = mgp.coarse.apply(vc)
        galerkin.append(rel_err(mgp.restrict(a.apply(mgp.prolong(vc))), cv)[0])
        ell.append(rel_err(bsr.apply(vc), cv)[0])
    check(kernels.launch_counts()["stencil_spmv"] == 3, "C v went through the stencil kernel")
    check(max(galerkin) <= GALERKIN_TOL, f"Galerkin P^H A P = C: {galerkin}")
    check(max(ell) <= FIELD_TOL, f"block-ELL apply against the stencil kernel: {ell}")
    emit("mg_record_setup", t1, card=card, lattice=list(mesh.dims), block=REC_BLOCK,
         n_nullvecs=REC_NULLVECS, ne=2 * REC_NULLVECS, n_blocks=mgp.block_map.n_blocks,
         coarse_dim=nc, coarse_format="stencil", smoother=None, setup_seconds=setup_s,
         phase_seconds=timings, peak_gib=peak, launches=setup_counts,
         orthonormality_err=orth, galerkin_rel_err=galerkin, galerkin_tol=GALERKIN_TOL,
         bsr_vs_stencil_rel_err=ell,
         dense="not built: 81920^2 complex64 is 53.7 GB, and its assembly needs two more "
               "f32 planes of that size")

    t1 = time.perf_counter()
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    outer = GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=True)
    ell_mgp = dataclasses.replace(mgp, coarse=bsr)
    runs = {"stencil": [], "bsr": []}
    for fmt in ("stencil", "bsr", "stencil"):
        pre = mgp if fmt == "stencil" else ell_mgp
        runs[fmt].append(_timed_solve(lambda: gcr_solve(a, b, outer, precond=pre.apply), b,
                                      independent_relres, f"MG record {fmt}"))
    st, bs = runs["stencil"], runs["bsr"]
    check(st[0]["iters"] == st[1]["iters"] and st[0]["launches"] == st[1]["launches"],
          "MG record stencil runs repeat")
    check(abs(st[0]["iters"] - bs[0]["iters"]) <= 1, "block-ELL outer iterations within 1")
    counts = st[0]["launches"]
    check(all(counts[k] > 0 for k in ("stencil_spmv", "restrict", "prolong", "gcr_z_step",
                                      "update_xr", "dir_update")),
          f"the config of record launched B12, B10, B11, B9, B6 and B7: {counts}")
    check(bs[0]["launches"]["stencil_spmv"] == 0, "the block-ELL solve ran no B12")
    rc = mgp.restrict(b)
    coarse = gcr_solve(mgp.coarse, rc, params.coarse_gcr)
    coarse_ms = host_ms(lambda: gcr_solve(mgp.coarse, rc, params.coarse_gcr))
    bsr_coarse_ms = host_ms(lambda: gcr_solve(bsr, rc, params.coarse_gcr))
    emit("mg_record_solve", t1, card=card, k=K, tol=1e-6, restart=RESTART, unroll="auto",
         stencil=st, bsr=bs, coarse_iters_on_b=coarse.n_iters,
         coarse_solve_ms={"stencil": coarse_ms, "bsr": bsr_coarse_ms},
         vcycle_ms=host_ms(lambda: mgp.apply(b)))
    if profile:
        profile_solve(a, b, outer, card, mgp.apply, "mg_record_profile")
    return {k: setup_counts[k] + counts[k] for k in counts}


def three_level_path(canon, mesh, dev, card: str, independent_relres, two_level_iters: dict,
                     profile: bool) -> dict:
    """The MG cell (block 8, 6 null vectors, GCR(4) smoother on bf16 links)
    with n_level=3, coarse_block=2 and block-stencil coarse operators:
    3072 unknowns on (4,4,4,4) blocks at level 2, 192 on (2,2,2,2) at level
    3. Returns the launch counts of the setup and the solve, summed."""
    import torch

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, MGParams, cplx, gcr_solve, kernels,
        setup_mg, with_link_dtype,
    )

    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    a_smooth = DiracOperator(with_link_dtype(op, torch.bfloat16), K)
    params = MGParams(block=MG_BLOCK, n_nullvecs=MG_NULLVECS, n_level=3, coarse_block=2,
                      coarse_format="stencil")
    timings = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    mgp = setup_mg(torch.Generator(device=dev).manual_seed(3), a, mesh, params,
                   smoother_operator=a_smooth, timings=timings)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s0
    setup_counts = kernels.launch_counts()
    lv2 = mgp.coarse_precond
    check(lv2 is not None and lv2.coarse_precond is None, "three levels were built")
    dims = [mgp.coarse.dims, lv2.coarse.dims]
    check(dims == [(4, 4, 4, 4), (2, 2, 2, 2)] and lv2.coarse.shape[0] == 192
          and mgp.coarse.shape[0] == 3072, f"level grids {dims}")
    check(setup_counts["stencil_spmv"] > 0, "the level-2 setup ran the stencil kernel")
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    outer = GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=True)
    gcr_solve(a, b, outer, precond=mgp.apply)  # warm-up
    runs = [_timed_solve(lambda: gcr_solve(a, b, outer, precond=mgp.apply), b, independent_relres,
                         "three-level MG") for _ in range(2)]
    check(runs[0]["iters"] == runs[1]["iters"], "three-level runs repeat")
    counts = runs[0]["launches"]
    check(counts["stencil_spmv"] > 0 and counts["gcr_z_step"] > 0,
          f"the three-level solve launched B12 and B9: {counts}")
    emit("mg_three_level", t1, card=card, k=K, tol=1e-6, restart=RESTART, unroll="auto",
         levels=[{"unknowns": mgp.coarse.shape[0], "grid": list(dims[0]), "ne": mgp.coarse.ne},
                 {"unknowns": lv2.coarse.shape[0], "grid": list(dims[1]), "ne": lv2.coarse.ne}],
         setup_seconds=setup_s, phase_seconds=timings, setup_launches=setup_counts, runs=runs,
         two_level_outer_iters=two_level_iters)
    if profile:
        profile_solve(a, b, outer, card, mgp.apply, "mg_three_level_profile")
    return {k: setup_counts[k] + counts[k] for k in counts}


def mu_major_path(canon, mesh, dev, card: str, independent_relres, plain_iters: int) -> dict:
    """The plain fused restart-5 solve on mu-major 3-row f32 links
    (``build(..., tb=2, zb=8)``, the anti-periodic sign folded into the
    links): B13 and the cycles form's algebra without a one-pass step.
    Returns the first timed run's launch counts."""
    import torch

    from mgpgcr_tpu_torch import CudaWilsonDirac, DiracOperator, GCRParams, cplx, gcr_solve

    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev, tb=2, zb=8)
    check(not op.t_major, "mu-major links")
    a = DiracOperator(op, K)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    gcr_solve(a, b, params)  # warm-up
    runs = [_timed_solve(lambda: gcr_solve(a, b, params), b, independent_relres, "mu-major")
            for _ in range(2)]
    counts = runs[0]["launches"]
    check(runs[0]["iters"] == runs[1]["iters"] and counts == runs[1]["launches"],
          "mu-major runs repeat")
    check(abs(runs[0]["iters"] - plain_iters) <= 2,
          f"mu-major iterations {runs[0]['iters']} within 2 of the t-major {plain_iters}")
    check(counts["dslash_mu"] > 0 and counts["gcr_stream_step"] == 0
          and counts["dslash_apply"] == 0,
          f"B13 launched, and no K1 or one-pass step on mu-major links: {counts}")
    emit("mu_major", t1, card=card, k=K, tol=1e-6, restart=RESTART, tb=2, zb=8,
         t_major_iters=plain_iters, runs=runs)
    return counts


def dist_kernel_phase(canon, mesh, dev, card: str, table: dict) -> list:
    """B14 and B15 on every rank of each grid in DIST_KERNEL_GRIDS, so at
    every shard shape the dist solves launch them, each against its plain
    version with the ghosts received from the real neighbours (B14: 2- and
    3-row, f32 and bf16 links, with and without k; B15: lim 1 and 5, alpha
    != 0); on each grid the gathered outputs against K1 and K2 on the
    global lattice (B15's partials summed over the ranks); the host time of
    one exchange of faces on each grid; then CUDA-event times of both on
    rank 0's shard of the DIST_SHARD grid. Fills ``table`` and returns the
    (kernel, case, (rel, abs), tol) errors for the parity record."""
    import torch

    from mgpgcr_tpu_torch import ShardLocalWilsonDirac, cplx, links_from_numpy
    from mgpgcr_tpu_torch.kernels.dslash import dslash_apply
    from mgpgcr_tpu_torch.kernels.dslash_dist import dslash_dist, dslash_dist_plain, psi_ghosts
    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step
    from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import (
        gcr_stream_step_dist, gcr_stream_step_dist_plain, step_ghosts,
    )
    from mgpgcr_tpu_torch.parallel import gather_field, make_shard_grid, run_spmd, shard_field

    t1 = time.perf_counter()
    S = RESTART
    t, z, y, xx = mesh.spacetime_dims
    fshape = (4, 3, t, z, y * xx)
    gen = torch.Generator(device=dev).manual_seed(21)
    psi = cplx.random(gen, fshape, torch.float32, dev)
    r = cplx.random(gen, fshape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    kt = torch.tensor(K, dtype=torch.complex64, device=dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    variants = [(rows, lname, ldt) for rows in (3, 2)
                for lname, ldt in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    main_links = links_from_numpy(canon, mesh, dev, compress=True)
    k1 = dslash_apply(main_links, psi, mesh, kt, True)
    k2 = gcr_stream_step(main_links, r, aps, alpha, kt, S, mesh, anti_t=True)
    del main_links

    def rank(comm, grid, axis_z, timed: bool):
        errs, keep = [], {}
        sf = lambda f: shard_field(f, grid, comm.rank, "t", axis_z)  # noqa: E731
        x, rl, al = sf(psi), sf(r), sf(aps)
        for rows, lname, ldt in variants:
            d = ShardLocalWilsonDirac.build(canon, mesh, comm, "t", axis_z, compress=rows == 2,
                                            antiperiodic_t=True, link_dtype=ldt)
            g = psi_ghosts(x, comm, "t", axis_z, True, d.ghost_links)
            for kk in (None, kt):
                got = dslash_dist(d.links, x, d.local_mesh, g, kk)
                want = dslash_dist_plain(d.links, x, d.local_mesh, g, kk)
                errs.append(("dslash_dist", f"{lname}/{rows}row/k={kk is not None}",
                             rel_err(got, want), FIELD_TOL))
            if (rows, lname) == (2, "f32"):
                keep.update(op=d, ghosts=g, a_psi=got)
        d = keep["op"]
        lm = d.local_mesh
        steps = {}
        for lim in range(1, S + 1):  # every lim's ghosts, for the timing
            if not timed and lim not in (1, S):
                continue
            gs = step_ghosts(rl, al, alpha, lim, comm, "t", axis_z, True, d.ghost_links)
            steps[lim] = gs
            if lim not in (1, S):
                continue
            out = gcr_stream_step_dist(d.links, rl, al, alpha, kt, lim, lm, gs)
            pl = gcr_stream_step_dist_plain(d.links, rl, al, alpha, kt, lim, lm, gs)
            g64 = step_ghosts(f64(rl), f64(al), f64(alpha), lim, comm, "t", axis_z, True,
                              d.ghost_links)
            p64 = gcr_stream_step_dist_plain(d.links, f64(rl), f64(al), f64(alpha), f64(kt),
                                             lim, lm, g64)
            errs += [("gcr_stream_step_dist", f"r'/lim={lim}", rel_err(out[0], pl[0]), FIELD_TOL),
                     ("gcr_stream_step_dist", f"az/lim={lim}", rel_err(out[1], pl[1]), FIELD_TOL),
                     ("gcr_stream_step_dist", f"r2/lim={lim}", rel_err(out[2], p64[2]), DOT_TOL),
                     ("gcr_stream_step_dist", f"raw/lim={lim}",
                      rel_err(out[3][:lim], p64[3][:lim]), DOT_TOL),
                     ("gcr_stream_step_dist", f"apr/lim={lim}",
                      rel_err(out[4][:lim], p64[4][:lim]), DOT_TOL),
                     ("gcr_stream_step_dist", f"azr/lim={lim}", rel_err(out[4][S:], p64[4][S:]),
                      DOT_TOL)]
            if lim == S:
                keep["step"] = (out[0], out[1], comm.allsum(out[2]), comm.allsum(out[3]),
                                comm.allsum(out[4]))
        # host time of one iteration's exchange of faces (B15's, all ranks at once)
        torch.cuda.synchronize()
        comm.barrier()
        s0 = time.perf_counter()
        for _ in range(EXCHANGE_REPS):
            step_ghosts(rl, al, alpha, S, comm, "t", axis_z, True, d.ghost_links)
        torch.cuda.synchronize()
        exchange_ms = 1e3 * (time.perf_counter() - s0) / EXCHANGE_REPS
        keep.update(errs=errs, exchange_ms=exchange_ms)
        if timed:
            keep.update(steps=steps, x=x, r=rl, aps=al)
        else:
            del keep["op"], keep["ghosts"]
        return keep

    errs, per_grid, timing_rank = [], {}, None
    for sizes, names in DIST_KERNEL_GRIDS:
        grid = make_shard_grid(sizes, names, device=dev)
        axis_z = "z" if "z" in names else None
        timed = sizes == DIST_SHARD
        ranks = run_spmd(grid, lambda comm: rank(comm, grid, axis_z, timed))
        tag = "x".join(map(str, sizes))
        errs += [(kname, f"{tag}/rank{i}/{what}", err, tol)
                 for i, rk in enumerate(ranks) for kname, what, err, tol in rk["errs"]]
        # the gathered outputs against K1 and K2 on the global lattice
        got = gather_field([rk["a_psi"] for rk in ranks], grid, "t", axis_z)
        errs.append(("dslash_dist", f"{tag}/gathered vs K1", rel_err(got, k1), FIELD_TOL))
        step = ranks[0]["step"]
        for i, what in ((0, "r'"), (1, "az")):
            got = gather_field([rk["step"][i] for rk in ranks], grid, "t", axis_z)
            errs.append(("gcr_stream_step_dist", f"{tag}/gathered {what} vs K2",
                         rel_err(got, k2[i]), FIELD_TOL))
        errs += [("gcr_stream_step_dist", f"{tag}/summed {what} vs K2", rel_err(step[i], k2[i]),
                  DOT_TOL) for i, what in ((2, "r2"), (3, "raw"), (4, "apr"))]
        per_grid[tag] = {"shard_tz": list(ranks[0]["a_psi"].shape[2:4]),
                         "exchange_host_ms": [rk["exchange_ms"] for rk in ranks]}
        if timed:
            timing_rank = ranks[0]
        del ranks, got, step
    for kname, what, err, tol in errs:
        check(err[0] <= tol, f"{kname} {what}: {err[0]} > {tol}")
    del k1, k2

    # timing on rank 0's shard of the DIST_SHARD grid, two-row f32 links, ghosts as received
    r0 = timing_rank
    d, g, x = r0["op"], r0["ghosts"], r0["x"]
    lm = d.local_mesh
    tl, zl = lm.spacetime_dims[:2]
    v = y * xx
    n_loc = lm.n_sites
    link_b = LINK_B[(2, "f32")]
    # ghosts read once: two psi planes and a U_t plane; two psi columns and a U_z column
    ghost_b = (2 * FIELD_B + link_b // 4) * (zl * v + tl * v)
    b14_bytes = n_loc * (link_b + 2 * FIELD_B) + ghost_b
    b14_flops = n_loc * (DSLASH_FLOPS_PER_SITE + RECON_FLOPS + K_FLOPS)
    windows = {}  # ms per call over short and long windows, in turns

    def in_turns(name, fn, calls):
        """cuda_ms's default window (20 calls of fn after 3) and a long one
        (DIST_LONG_CALLS kernel calls after a quarter as many), in the
        turns short, long, long, short; the long ones' mean is the row's."""
        n = max(DIST_LONG_CALLS // calls, 1)
        short = lambda: cuda_ms(fn) / calls  # noqa: E731
        long = lambda: cuda_ms(fn, reps=n, warmup=max(n // 4, 1)) / calls  # noqa: E731
        w = [short(), long(), long(), short()]
        windows[name] = {"short_ms": [w[0], w[3]], "long_ms": [w[1], w[2]]}
        return (w[1] + w[2]) / 2

    ms = in_turns("dslash_dist", lambda: dslash_dist(d.links, x, lm, g, kt), 1)
    HOST_FREE["dslash_dist"] = graph_ms(lambda: dslash_dist(d.links, x, lm, g, kt), launches=50)
    pms = cuda_ms(lambda: dslash_dist_plain(d.links, x, lm, g, kt), reps=5, warmup=1)
    table["dslash_dist"] = (ms, pms, *bound(b14_bytes, b14_flops), None, b14_bytes)
    rl, al, steps = r0["r"], r0["aps"], r0["steps"]

    def cycle(fn):
        for lim in range(1, S + 1):
            fn(d.links, rl, al, alpha, kt, lim, lm, steps[lim])

    ms = in_turns("gcr_stream_step_dist", lambda: cycle(gcr_stream_step_dist), S)
    HOST_FREE["gcr_stream_step_dist"] = graph_ms(lambda: cycle(gcr_stream_step_dist), calls=S)
    pms = cuda_ms(lambda: cycle(gcr_stream_step_dist_plain), reps=3, warmup=1) / S
    b15_bytes = sum(n_loc * (link_b + (3 + lim) * FIELD_B) for lim in range(1, S + 1)) / S \
        + ghost_b
    b15_flops = sum(n_loc * (DSLASH_FLOPS_PER_SITE + RECON_FLOPS + K_FLOPS + 96
                             + (2 * lim + 1) * 96 + 48) for lim in range(1, S + 1)) / S
    table["gcr_stream_step_dist"] = (ms, pms, *bound(b15_bytes, b15_flops), None, b15_bytes)
    torch.cuda.synchronize()
    worst = {}
    for kname, what, err, _ in errs:
        key = f"{kname}/{what.split('/')[0]}"
        worst[key] = max(worst.get(key, 0.0), err[0])
    emit("dist_kernels", t1, card=card, timing_grid=list(DIST_SHARD), timing_shard=list(lm.dims),
         cases=len(errs), field_tol=FIELD_TOL, dot_tol=DOT_TOL, worst_rel=worst,
         ghost_bytes=ghost_b, grids=per_grid, windows=windows,
         kernels={k: {"ms": table[k][0], "graph_ms": HOST_FREE[k], "plain_ms": table[k][1],
                      "bound_ms": table[k][2], "bound_by": table[k][3], "bytes": table[k][5]}
                  for k in ("dslash_dist", "gcr_stream_step_dist")})
    return errs


def dist_solve_phase(canon, mesh, dev, card: str, b, independent_relres, plain_iters: int,
                     x_plain) -> list:
    """The domain-decomposed fused restart-5 solve of the plain cell: on the
    (2, 2) and (4, 1) ThreadComm grids of ranks sharing the card, timed in
    turns at each of SWITCH_INTERVALS (the ranks hand the interpreter lock
    to each other at every exchange and sum), and on a world-size-1 NCCL
    group (TorchDistComm). Iterations against the single-device fused
    solve, host ms per iteration, launches per solve, the independent f64
    residual of the gathered x. Returns each path's launch counts (the
    first timed run of each grid; the others must repeat them)."""
    import tempfile

    import torch

    from mgpgcr_tpu_torch import (
        DiracOperator, GCRParams, ShardLocalWilsonDirac, gcr_solve_sharded, kernels,
    )
    from mgpgcr_tpu_torch.parallel import (
        TorchDistComm, gather_field, init_distributed, make_shard_grid, run_spmd, shard_field,
    )

    t1 = time.perf_counter()
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    out, all_counts = {}, []

    def checked(what, res, x, counts, walls):
        check(res.converged, f"{what} converged")
        check(x.shape == b.shape and bool(torch.isfinite(x.re).all())
              and bool(torch.isfinite(x.im).all()), f"{what} solution finite")
        rel = independent_relres(x)
        check(rel <= 2e-6, f"{what} independent residual {rel} <= 2e-6")
        check(abs(res.n_iters - plain_iters) <= 2,
              f"{what} iterations {res.n_iters} within 2 of the single-device {plain_iters}")
        check(counts["gcr_stream_step_dist"] > 0 and counts["dslash_dist"] > 0
              and counts["gcr_stream_step"] == 0 and counts["dslash_apply"] == 0,
              f"{what}: B14 and B15 launched, K1 and K2 not: {counts}")
        all_counts.append(counts)
        return {"iters": res.n_iters, "relres": res.final_relres,
                "independent_relres_f64": rel, "seconds": walls,
                "ms_per_iter": [1e3 * w / max(res.n_iters, 1) for w in walls],
                "launches": counts}

    old_interval = sys.getswitchinterval()
    for sizes in DIST_GRIDS:
        grid = make_shard_grid(sizes, ("t", "z"), device=dev)

        def rank(comm):
            d = ShardLocalWilsonDirac.build(canon, mesh, comm, "t", "z", compress=True,
                                            antiperiodic_t=True)
            a = DiracOperator(d, K)
            bl = shard_field(b, grid, comm.rank, "t", "z")
            gcr_solve_sharded(a, bl, params, comm)  # warm-up
            runs = []
            for interval in SWITCH_INTERVALS:
                torch.cuda.synchronize()
                comm.barrier()
                if comm.rank == 0:
                    sys.setswitchinterval(interval)
                    kernels.reset_launches()
                comm.barrier()
                s0 = time.perf_counter()
                res = gcr_solve_sharded(a, bl, params, comm)
                torch.cuda.synchronize()
                wall = time.perf_counter() - s0
                comm.barrier()
                runs.append((res, wall, kernels.launch_counts()))
            return runs

        try:
            ranks = run_spmd(grid, rank)
        finally:
            sys.setswitchinterval(old_interval)
        first = [rk[0] for rk in ranks]
        res = first[0][0]
        x = gather_field([rk[0].x for rk in first], grid, "t", "z")
        check(all(rk[0].n_iters == res.n_iters for rk in first), f"{sizes}: ranks agree")
        for i in range(1, len(SWITCH_INTERVALS)):
            check(all(rk[i][0].n_iters == res.n_iters and rk[i][2] == first[0][2]
                      and torch.equal(rk[i][0].x.re, rk[0][0].x.re) for rk in ranks),
                  f"{sizes}: timed runs repeat (iterations, launches, x)")
        tag = f"thread_{sizes[0]}x{sizes[1]}"
        out[tag] = checked(f"ThreadComm {sizes}", res, x, first[0][2],
                           [rk[0][1] for rk in ranks])
        # host ms per iteration on rank 0's clock, one entry per timed run in turns
        out[tag]["switch_runs"] = [
            {"switch_interval_s": iv, "ms_per_iter": 1e3 * ranks[0][i][1] / max(res.n_iters, 1)}
            for i, iv in enumerate(SWITCH_INTERVALS)]
        del ranks, first, x

    # one process, world size 1, NCCL: the same per-rank code over torch.distributed
    with tempfile.TemporaryDirectory() as tmp:
        cfg = init_distributed(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            comm = TorchDistComm(make_shard_grid((1,), ("t",), device=dev), device=dev)
            d = ShardLocalWilsonDirac.build(canon, mesh, comm, "t", None, compress=True,
                                            antiperiodic_t=True)
            a = DiracOperator(d, K)
            gcr_solve_sharded(a, b, params, comm)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launches()
            s0 = time.perf_counter()
            res = gcr_solve_sharded(a, b, params, comm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
            counts = kernels.launch_counts()
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    check(backend == "nccl" and cfg.num_processes == 1, f"world-1 group on {backend}")
    check(res.n_iters == plain_iters,
          f"NCCL world-1 iterations {res.n_iters} == single-device {plain_iters}")
    xerr = rel_err(res.x, x_plain)[0]
    check(xerr <= 1e-6, f"NCCL world-1 x within 1e-6 of the single-device x: {xerr}")
    out["nccl_world1"] = checked("NCCL world-1", res, res.x, counts, [wall])
    out["nccl_world1"]["x_rel_diff_vs_single_device"] = xerr
    emit("dist_solve", t1, card=card, k=K, tol=1e-6, restart=RESTART,
         single_device_iters=plain_iters, **out)
    return all_counts


def independent_residual(canon, mesh, b):
    """The independent check of a solve: x -> ||b - A x|| / ||b|| in f64,
    A = I - K D with the in-kernel anti-periodic sign on the canonical
    links ``canon``, through K1's plain version on f64 links."""
    import torch

    from mgpgcr_tpu_torch import cplx, links_from_numpy
    from mgpgcr_tpu_torch.kernels.dslash import dslash_plain

    links64 = links_from_numpy(canon, mesh, b.device, link_dtype=torch.float64)
    k64 = torch.tensor(K, dtype=torch.complex128, device=b.device)
    b64 = b.astype(torch.float64)

    def relres(x) -> float:
        rr = b64 - dslash_plain(links64, x.astype(torch.float64), mesh, k64, anti_t=True)
        return float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b64)))

    return relres


def algebra_parity(fshape, gen, note, S: int, tag: str) -> None:
    """B2, B3, K3 (both forms) and K4 against their plain versions on fields
    of ``fshape``, the shapes of the slice-7 solves (the Schur solves' half
    fields, the ingested operator's 8^4 fields): field outputs against the
    f32 plain versions, reductions against f64."""
    import torch

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.kernels.gcr_kernels import (
        ap_update, ap_update_plain, basis_flush, basis_flush_plain, beta_dots, beta_dots_plain,
        update_r, update_r_plain,
    )

    dev = gen.device
    r, az = (cplx.random(gen, fshape, torch.float32, dev) for _ in range(2))
    aps = cplx.random(gen, (S,) + tuple(fshape), torch.float32, dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    betas = torch.complex(torch.rand(S, generator=gen, device=dev),
                          torch.rand(S, generator=gen, device=dev)) - (0.5 + 0.5j)
    r64, az64, aps64, b64 = f64(r), f64(az), f64(aps), f64(betas)
    for slot in range(S):
        got = update_r(r, aps, slot, alpha)
        note("update_r", f"{tag}/r'/slot={slot}",
             rel_err(got[0], update_r_plain(r, aps, slot, alpha)[0]), FIELD_TOL)
        note("update_r", f"{tag}/r2/slot={slot}",
             rel_err(got[1], update_r_plain(r64, aps64, slot, f64(alpha))[1]), DOT_TOL)
    for lim in range(1, S + 1):
        got = beta_dots(aps, az, lim)
        note("beta_dots", f"{tag}/lim={lim}",
             rel_err(got[:lim], beta_dots_plain(aps64, az64, lim)[:lim]), DOT_TOL)
        slot = lim % S
        for rr, rr64, form in ((None, None, "r=None"), (r, r64, "r")):
            got = ap_update(az, aps.clone(), betas, slot, lim, r=rr)
            pl = ap_update_plain(az, aps.clone(), betas, slot, lim, r=rr)
            p64 = ap_update_plain(az64, aps64.clone(), b64, slot, lim, r=rr64)
            what = f"{tag}/{form}/lim={lim}"
            note("ap_update", f"ap/{what}", rel_err(got[0][slot], pl[0][slot]), FIELD_TOL)
            note("ap_update", f"norm/{what}", rel_err(got[1], p64[1]), DOT_TOL)
            if rr is not None:
                note("ap_update", f"apr/{what}", rel_err(got[2], p64[2]), DOT_TOL)
        basis = [aps[m] for m in range(lim)] + [r]
        w = torch.complex(torch.rand(2, lim + 1, generator=gen, device=dev),
                          torch.rand(2, lim + 1, generator=gen, device=dev))
        got = basis_flush(az, basis, w[0], w[1])
        ref = basis_flush_plain(az, basis, w[0], w[1])
        note("basis_flush", f"{tag}/x/nb={lim + 1}", rel_err(got[0], ref[0]), FIELD_TOL)
        note("basis_flush", f"{tag}/p0/nb={lim + 1}", rel_err(got[1], ref[1]), FIELD_TOL)


def dslash_step_parity(links, mesh, gen, note, S: int, tag: str, anti_t: bool) -> None:
    """K1 and K2 against their plain versions on ``links`` at ``mesh``: the
    ingested operator's 3-row f32 links at 8^4."""
    import torch

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.kernels.dslash import dslash_apply, dslash_plain
    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_stream_step_plain

    dev = links.device
    t, z, y, xx = mesh.spacetime_dims
    fshape = (4, 3, t, z, y * xx)
    psi, r = (cplx.random(gen, fshape, torch.float32, dev) for _ in range(2))
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    kt = torch.tensor(K, dtype=torch.complex64, device=dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    for kk in (None, kt):
        note("dslash_apply", f"{tag}/k={kk is not None}",
             rel_err(dslash_apply(links, psi, mesh, kk, anti_t),
                     dslash_plain(links, psi, mesh, kk, anti_t)), FIELD_TOL)
    r64, aps64 = f64(r), f64(aps)
    for lim in range(1, S + 1):
        out = gcr_stream_step(links, r, aps, alpha, kt, lim, mesh, anti_t=anti_t)
        pl = gcr_stream_step_plain(links, r, aps, alpha, kt, lim, mesh, anti_t=anti_t)
        p64 = gcr_stream_step_plain(links, r64, aps64, f64(alpha), f64(kt), lim, mesh, anti_t)
        note("gcr_stream_step", f"{tag}/r'/lim={lim}", rel_err(out[0], pl[0]), FIELD_TOL)
        note("gcr_stream_step", f"{tag}/az/lim={lim}", rel_err(out[1], pl[1]), FIELD_TOL)
        note("gcr_stream_step", f"{tag}/r2/lim={lim}", rel_err(out[2], p64[2]), DOT_TOL)
        note("gcr_stream_step", f"{tag}/raw/lim={lim}", rel_err(out[3][:lim], p64[3][:lim]),
             DOT_TOL)
        note("gcr_stream_step", f"{tag}/apr/lim={lim}", rel_err(out[4][:lim], p64[4][:lim]),
             DOT_TOL)


def half_transfer_parity(mh, gen, note, x) -> None:
    """B10 and B11 against their plain versions on the half mesh ``mh`` with
    the eo MG cell's (8, 8, 8, 4) blocks and ne 12; f32 and bf16 basis."""
    import torch

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.kernels.transfer import prolong, prolong_plain, restrict, restrict_plain

    dims = "x".join(map(str, mh.spacetime_dims))
    bm = mh.blocking((MG_BLOCK, MG_BLOCK, MG_BLOCK, MG_BLOCK // 2))
    ne = 2 * MG_NULLVECS
    q = cplx.random(gen, (ne,) + x.shape, torch.float32, x.device)
    xc = cplx.random(gen, (bm.n_blocks * ne,), torch.float32, x.device)
    for qname, qf in (("f32", q), ("bf16", q.astype(torch.bfloat16))):
        what = f"half-mesh {dims}/block 8x8x8x4/{qname}"
        note("restrict", what, rel_err(restrict(qf, bm, x), restrict_plain(qf, bm, x)), FIELD_TOL)
        note("prolong", what, rel_err(prolong(qf, bm, xc), prolong_plain(qf, bm, xc)), FIELD_TOL)
        note("prolong", f"{what}/base/damping=0.7",
             rel_err(prolong(qf, bm, xc, x, 0.7), prolong_plain(qf, bm, xc, x, 0.7)), FIELD_TOL)


def refine_phase(canon, mesh, dev, card: str, b, independent_relres) -> dict:
    """Mixed-precision refinement of the plain cell: the fused restart-5
    solve to 1e-6 on two-row f32 links as the inner solve, the residual in
    complex128 on the card (``SlabWilsonDirac`` with f64 links, the
    anti-periodic sign folded in), refined to 1e-10. Returns the launch
    counts of the refined solve."""
    import torch

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, cplx, kernels, wilson_apply_hi,
        wilson_refined_solve,
    )
    from mgpgcr_tpu_torch.ops.wilson_slab import field_from_slab, field_to_slab

    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    apply_hi = wilson_apply_hi(canon, mesh, K, antiperiodic=True, device=dev)
    rhs = field_from_slab(torch.complex(b.re, b.im).to(torch.complex128), mesh)
    inner = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    res = wilson_refined_solve(a, mesh, rhs, inner, apply_hi, tol=REFINE_TOL, max_refine=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    counts = kernels.launch_counts()
    check(res.converged and res.final_relres <= REFINE_TOL,
          f"refinement reached {res.final_relres} <= {REFINE_TOL}: {res.history}")
    x = field_to_slab(torch.as_tensor(res.x).to(dev), mesh)
    check(bool(torch.isfinite(x.real).all()) and bool(torch.isfinite(x.imag).all()),
          "refined solution finite")
    rel = independent_relres(cplx.CF(x.real.contiguous(), x.imag.contiguous()))
    check(rel <= REFINE_TOL, f"refined independent residual {rel} <= {REFINE_TOL}")
    check(counts["gcr_stream_step"] > 0 and counts["ap_update"] > 0, f"refine launches {counts}")
    emit("refine", t1, card=card, k=K, tol=REFINE_TOL, inner_tol=1e-6, restart=RESTART,
         rounds=res.n_refine, inner_iters=res.inner_iters, history=res.history,
         independent_relres_f64=rel, seconds=wall, ms_per_round=1e3 * wall / res.n_refine,
         launches=counts)
    return counts


def eigen_phase(canon, mesh, dev, card: str) -> dict:
    """``smallest_eigenpairs(n=4)`` of the plain operator (the generic GCR
    inverse, K1): Rayleigh values, residuals, orthonormality. Returns the
    launch counts."""
    import numpy as np
    import torch

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, cplx, kernels, smallest_eigenpairs,
    )

    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    b0 = cplx.random(torch.Generator(device=dev).manual_seed(17), op.field_shape,
                     torch.float32, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    res = smallest_eigenpairs(None, a, 4, b0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    counts = kernels.launch_counts()
    v = res.vectors
    gram = torch.stack([torch.stack([cplx.vdot(v[i], v[j]) for j in range(4)]) for i in range(4)])
    orth = float((gram - torch.eye(4, dtype=gram.dtype, device=dev)).abs().max())
    check(bool(np.isfinite(res.values).all()) and bool(np.isfinite(res.residuals).all()),
          "eigenpairs finite")
    check(orth <= 1e-4, f"eigenvectors orthonormal: {orth}")
    check(float(res.values.real.min()) > 0, f"Re lambda > 0 below the critical k: {res.values}")
    check(counts["dslash_apply"] > 0, f"eigen launches {counts}")
    emit("eigen", t1, card=card, k=K, n=4, values=[[z.real, z.imag] for z in res.values],
         residuals=res.residuals.tolist(), orthonormality_err=orth, seconds=wall,
         launches=counts)
    return counts


def _eo_lattice(canon, mesh, dev):
    """The operator pieces of an even-odd phase on ``mesh``: 3-row t-major
    f32 links with the in-kernel anti-periodic sign, the parity split, the
    seeded right-hand side and the independent f64 residual against the
    full operator."""
    import torch

    from mgpgcr_tpu_torch import CudaWilsonDirac, EvenOddWilson, cplx

    d = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev)
    check(d.t_major and d.anti_t and d.links.shape[2] == 3, "3-row t-major links, in-kernel sign")
    eo = EvenOddWilson.from_dirac(d)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), d.field_shape, torch.float32,
                    dev)
    return d, eo, b, independent_residual(canon, mesh, b)


def eo_solve_phase(canon, mesh, dev, card: str, plain_iters: int) -> tuple[dict, dict]:
    """The plain cell through the even-odd Schur complement: ``from_dirac``
    on 3-row t-major f32 links with the in-kernel sign, the fused
    restart-5 Schur solve to 1e-6 (B2, B3, K3, K4 on half-size fields; the
    Schur apply is plain PyTorch), x reconstructed and checked against the
    full operator in f64. Returns (launch counts, what eo_mg reuses)."""
    import torch

    from mgpgcr_tpu_torch import GCRParams, cplx, eo_solve, make_schur

    t1 = time.perf_counter()
    _, eo, b, independent_relres = _eo_lattice(canon, mesh, dev)
    s = make_schur(eo, K)
    xe = cplx.random(torch.Generator(device=dev).manual_seed(19), eo.field_shape,
                     torch.float32, dev)
    schur_ms = host_ms(lambda: s.apply(xe))
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    eo_solve(eo, K, b, params)  # warm-up
    runs = [_timed_solve(lambda: eo_solve(eo, K, b, params), b, independent_relres, "eo")
            for _ in range(2)]
    counts = runs[0]["launches"]
    check(runs[0]["iters"] == runs[1]["iters"] and counts == runs[1]["launches"],
          "eo runs repeat")
    check(runs[0]["iters"] < plain_iters,
          f"Schur iterations {runs[0]['iters']} < the full solve's {plain_iters}")
    check(all(counts[k] > 0 for k in ("update_r", "beta_dots", "ap_update", "basis_flush"))
          and counts["dslash_apply"] == 0 and counts["gcr_stream_step"] == 0,
          f"the Schur solve ran B2, B3, K3, K4 and no Dslash kernel: {counts}")
    emit("eo_solve", t1, card=card, k=K, tol=1e-6, restart=RESTART, lattice=list(mesh.dims),
         half_field=list(eo.field_shape), full_iters=plain_iters, schur_apply_host_ms=schur_ms,
         runs=runs)
    return counts, schur_ms


def eo_mg_phase(dev, card: str, note, schur_ms_32: float) -> dict:
    """MG over the Schur system (``setup_eo_mg``, the MG cell's block 8 and
    6 null vectors: (8, 8, 8, 4) blocks of the half mesh, column assembly,
    dense coarse operator, GCR(4) smoother on the Schur operator) and the
    fused MG-preconditioned restart-5 Schur solve in restart cycles (B2, K3,
    K4, B10, B11 on the half mesh), on the untiled 16^4 field: the column
    assembly costs nb * ne Schur applies, which at 32^4 and the Schur
    apply's host time (``schur_ms_32``, from the eo_solve phase) is past a
    minute; the phase prints that estimate. Returns the launch counts of
    setup and solve, summed."""
    import numpy as np
    import torch

    from mgpgcr_tpu_torch import (
        GCRParams, LatticeMesh, MGParams, cplx, eo_half_mesh, eo_solve, kernels, setup_eo_mg,
    )

    t1 = time.perf_counter()
    blocks = (MG_BLOCK, MG_BLOCK, MG_BLOCK, MG_BLOCK // 2)
    columns_32 = eo_half_mesh(LatticeMesh((32, 32, 32, 32, 4, 3))).blocking(blocks).n_blocks \
        * 2 * MG_NULLVECS
    estimate_32_s = columns_32 * schur_ms_32 / 1e3
    print(f"eo_mg runs on the untiled 16^4 field; at 32^4 the column assembly would take "
          f"{columns_32} Schur applies at {schur_ms_32:.1f} host ms each, ~{estimate_32_s:.0f} s",
          flush=True)
    with np.load(ROOT / "data" / "links_16_b6.0_s0.npz") as f:
        canon = (f["re"], f["im"])
    mesh = LatticeMesh((16, 16, 16, 16, 4, 3))
    mh = eo_half_mesh(mesh)
    _, eo, b, independent_relres = _eo_lattice(canon, mesh, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    # the kernels at the 16^4 half field and half mesh
    algebra_parity(eo.field_shape, gen, note, RESTART, "half 16^4")
    half_transfer_parity(mh, gen, note, cplx.random(gen, eo.field_shape, torch.float32, dev))
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    plain_iters = _timed_solve(lambda: eo_solve(eo, K, b, params), b, independent_relres,
                               "eo 16^4")["iters"]

    timings = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    s, mgp = setup_eo_mg(torch.Generator(device=dev).manual_seed(3), eo, K,
                         MGParams(block=MG_BLOCK, n_nullvecs=MG_NULLVECS), timings=timings)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s0
    setup_counts = kernels.launch_counts()
    check(mgp.block_map.block_dims == (MG_BLOCK, MG_BLOCK, MG_BLOCK, MG_BLOCK // 2)
          and mgp.params.assembly == "columns" and mgp.params.coarse_format == "dense",
          "half-mesh blocks, column assembly, dense coarse operator")
    check(setup_counts["restrict"] > 0, f"the column assembly ran B10: {setup_counts}")
    nc = mgp.coarse.shape[0]
    galerkin = []
    for _ in range(3):
        vc = cplx.random(gen, (nc,), torch.float32, dev)
        galerkin.append(rel_err(mgp.restrict(s.apply(mgp.prolong(vc))), mgp.coarse.apply(vc))[0])
    check(max(galerkin) <= GALERKIN_TOL, f"eo Galerkin P^H S P = C: {galerkin}")

    outer = GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=True, unroll="cycles")
    eo_solve(eo, K, b, outer, precond=mgp.apply)  # warm-up
    runs = [_timed_solve(lambda: eo_solve(eo, K, b, outer, precond=mgp.apply), b,
                         independent_relres, "eo MG") for _ in range(2)]
    counts = runs[0]["launches"]
    check(runs[0]["iters"] == runs[1]["iters"], "eo MG runs repeat")
    check(runs[0]["iters"] < plain_iters,
          f"eo MG outer iterations {runs[0]['iters']} < the Schur solve's {plain_iters}")
    check(all(counts[k] > 0 for k in ("update_r", "ap_update", "basis_flush", "restrict",
                                      "prolong")),
          f"the eo MG solve ran B2, K3, K4, B10, B11: {counts}")
    emit("eo_mg", t1, card=card, k=K, tol=1e-6, restart=RESTART, unroll="cycles",
         lattice=list(mesh.dims), column_estimate_32_s=estimate_32_s,
         half_mesh=list(mh.spacetime_dims), block=list(mgp.block_map.block_dims),
         n_nullvecs=MG_NULLVECS, coarse_dim=nc, setup_seconds=setup_s, phase_seconds=timings,
         setup_launches=setup_counts, galerkin_rel_err=galerkin, schur_iters=plain_iters,
         runs=runs)
    return {k: setup_counts[k] + counts[k] for k in counts}


def gauge_phase(dev, card: str, hot_dims=(32, 32, 32, 32)) -> dict:
    """The heat bath on the card: two combined sweeps (heat bath and 3
    overrelaxation sweeps) at 32^4 from a hot start, complex64; 20 at 8^4
    from a cold start, the plaquette in the band of tests/test_gauge.py;
    then the plain fused solve on the generated 32^4 links. Returns the
    solve's launch counts."""
    import torch

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, LatticeMesh, cplx, gauge, gcr_solve,
        thermalized_links,
    )

    t1 = time.perf_counter()
    mesh = LatticeMesh((*hot_dims, 4, 3))
    marks = [time.perf_counter()]

    def mark(s, p):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    links, hist = thermalized_links(5, mesh, n_sweeps=2, n_or=3, measure_every=1, device=dev,
                                    on_progress=mark)
    uni, det = gauge.unitarity_error(links)
    check(uni <= 1e-5 and det <= 1e-5, f"32^4 links SU(3): {uni}, {det}")
    check(0.0 < hist[-1] < 1.0, f"32^4 plaquette {hist}")
    t8 = time.perf_counter()
    links8, hist8 = thermalized_links(6, LatticeMesh((8, 8, 8, 8, 4, 3)), n_sweeps=20, n_or=3,
                                      start="cold", measure_every=5, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t8
    uni8, det8 = gauge.unitarity_error(links8)
    check(uni8 <= 1e-5 and det8 <= 1e-5, f"8^4 links SU(3): {uni8}, {det8}")
    check(abs(hist8[-1] - PLAQ_B6) < PLAQ_BAND,
          f"8^4 cold-start plaquette {hist8[-1]} within {PLAQ_BAND} of {PLAQ_B6}")

    cf = cplx.CF(links.real.contiguous(), links.imag.contiguous())
    del links
    op = CudaWilsonDirac.build(cf, mesh, compress=True, antiperiodic_t=True, device=dev)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    independent_relres = independent_residual(cf, mesh, b)
    del cf
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    run = _timed_solve(lambda: gcr_solve(DiracOperator(op, K), b, params), b, independent_relres,
                       "generated links")
    emit("gauge", t1, card=card, beta=6.0, n_or=3, dtype="complex64",
         hot=dict(lattice=list(hot_dims), sweeps=2, plaquette=hist, unitarity_err=uni, det_err=det,
                     first_call_seconds=marks[1] - marks[0],
                     sweep_seconds=marks[2] - marks[1]),
         cold_8=dict(sweeps=20, plaquette=hist8, unitarity_err=uni8, det_err=det8,
                     seconds=cold_s, seconds_per_sweep=cold_s / 20, band=[PLAQ_B6, PLAQ_BAND]),
         solve=run)
    return run["launches"]


def ingest_phase(dev, card: str, note) -> dict:
    """Matrix ingestion at 8^4 (the size of the reference's conf5_4-8x8; the
    CSR of 32^4 would hold 491 million non-zeros on the host): the
    beta = 6.0 8^4 field materialised as a CSR hopping matrix, round-tripped
    through parsed.txt (native and numpy) and the ELL .npz cache, detected
    as Wilson, routed to K1, and solved; the block-stencil operator of the
    same matrix (``from_csr``, B12). Returns the launch counts of the routed
    operator's apply and solve and the stencil apply."""
    import tempfile

    import numpy as np
    import torch

    from mgpgcr_tpu_torch import (
        CSRMatrix, CudaWilsonDirac, DiracOperator, GCRParams, LatticeMesh,
        StencilBlockOperator, cplx, detect_wilson, gcr_solve, kernels, materialize_csr,
        materialize_ell, wilson_operator_from_csr,
    )
    from mgpgcr_tpu_torch.io import load_ell_npz, native_parse, parsed_txt, save_ell_npz
    from mgpgcr_tpu_torch.kernels.spmv import stencil_spmv, stencil_spmv_plain

    t1 = time.perf_counter()
    dims = (8, 8, 8, 8)
    mesh = LatticeMesh((*dims, 4, 3))
    with np.load(ROOT / "data" / "links_8x8_b6.0_s0.npz") as f:
        links = f["re"].astype(np.float64) + 1j * f["im"]
    secs = {}

    def timed(name, fn):
        s0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - s0
        return out

    csr = timed("materialize_csr", lambda: materialize_csr(links, mesh))
    build = ROOT / "mgpgcr_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        check(native_parse.available(), "the native parser builds from native/parse.cpp")

        def write_native(p, m):
            check(native_parse.write_parsed_txt_native(str(p), m.indptr, m.indices, m.data,
                                                       m.shape), "native parsed.txt writer")

        def read_native(p):
            fast = native_parse.read_parsed_txt_native(str(p))
            check(fast is not None, "native parsed.txt reader")
            return CSRMatrix(*fast)

        ways = {"native": (write_native, read_native),
                "numpy": (parsed_txt._write_numpy, parsed_txt._read_numpy)}
        for tag, (write, read) in ways.items():
            p = Path(tmp) / f"parsed_{tag}.txt"
            timed(f"write_{tag}", lambda: write(p, csr))
            back = timed(f"read_{tag}", lambda: read(p))
            check(np.array_equal(back.indptr, csr.indptr)
                  and np.array_equal(back.indices, csr.indices), f"{tag} parsed.txt structure")
            err = float(np.abs(back.data - csr.data).max())
            # the numpy writer keeps 6 significant digits (the reference's %g)
            check(err == 0.0 if tag == "native" else err <= 1e-5,
                  f"{tag} parsed.txt values: {err}")
            other = ways["numpy" if tag == "native" else "native"][1](p)
            check(np.array_equal(other.data, back.data), f"{tag} file read both ways")
        ell = timed("materialize_ell", lambda: materialize_ell(links, mesh, device=dev))
        p = Path(tmp) / "ell.npz"
        timed("save_ell_npz", lambda: save_ell_npz(p, ell))
        ell2 = timed("load_ell_npz", lambda: load_ell_npz(p, device=dev))
        check(bool(torch.equal(ell.vals, ell2.vals)) and bool(torch.equal(ell.cols, ell2.cols))
              and ell.n_cols == ell2.n_cols, "ELL .npz round trip")
    det = timed("detect_wilson", lambda: detect_wilson(csr, dims))
    check(det is not None and det.signs == (1, 1, 1, 1) and det.max_error < 1e-12,
          "the materialised matrix is detected as Wilson")
    a = timed("wilson_operator_from_csr",
              lambda: wilson_operator_from_csr(csr, dims, K, device=dev))
    check(isinstance(a.d, CudaWilsonDirac) and a.d.t_major, "routed to K1")
    direct = DiracOperator(CudaWilsonDirac.build(links, mesh, device=dev), K)
    sb = StencilBlockOperator.from_csr(csr, dims, 12, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    psi = cplx.random(gen, a.d.field_shape, torch.float32, dev)
    xf = cplx.random(gen, (mesh.size,), torch.float32, dev)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), a.d.field_shape, torch.float32,
                    dev)
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)

    torch.cuda.synchronize()
    kernels.reset_launches()
    y = a.apply(psi)
    res = gcr_solve(a, b, params)
    ys = sb.apply(xf)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts["dslash_apply"] > 0 and counts["gcr_stream_step"] > 0
          and counts["stencil_spmv"] > 0, f"ingest launches {counts}")

    apply_err = rel_err(y, direct.apply(psi))[0]
    check(apply_err <= 1e-6, f"routed apply against the direct operator: {apply_err}")
    direct_res = gcr_solve(direct, b, params)
    check(res.converged and res.n_iters == direct_res.n_iters,
          f"routed solve {res.n_iters} iterations, direct {direct_res.n_iters}")
    x_err = rel_err(res.x, direct_res.x)[0]
    # the kernels the routed operator's solve launched, at its 8^4 shapes
    dslash_step_parity(a.d.links, mesh, gen, note, RESTART, "ingested 8^4", a.d.anti_t)
    algebra_parity(a.d.field_shape, gen, note, RESTART, "8^4")
    note("stencil_spmv", "ingested 8^4/ne12",
         rel_err(stencil_spmv(sb.blocks, xf, dims), stencil_spmv_plain(sb.blocks, xf, dims)),
         FIELD_TOL)
    ref = csr.spmv_torch(torch.complex(xf.re, xf.im).to(torch.complex128))
    spmv_err = rel_err(torch.complex(ys.re, ys.im), ref)[0]
    check(spmv_err <= FIELD_TOL, f"B12 on the ingested stencil against the CSR SpMV: {spmv_err}")
    emit("ingest", t1, card=card, lattice=list(mesh.dims), nnz=csr.nnz, k=K,
         host_seconds=secs, detect_max_error=det.max_error, routed_apply_rel_err=apply_err,
         routed_iters=res.n_iters, direct_iters=direct_res.n_iters, x_rel_err=x_err,
         stencil_vs_csr_rel_err=spmv_err, launches=counts)
    return counts


# ---------------------------------------------------------------------------
# the eighth slice: the command line, checkpoints, sharded MG and even-odd,
# the driver's entry points
# ---------------------------------------------------------------------------
CLI_SOLVE = ["solve", "--platform", "cuda", "--dtype", "cf32", "--lattice", "32", "32", "32", "32",
             "--k", str(K), "--tol", "1e-6", "--restart", str(RESTART), "--fused",
             "--antiperiodic"]
# the CLI's runs: (name, argv, kernels each must launch)
CLI_RUNS = (
    ("plain", CLI_SOLVE, PLAIN_KERNELS),
    ("mg", CLI_SOLVE + ["--mg", "--block", str(MG_BLOCK), "--nullvecs", str(MG_NULLVECS)],
     ("dslash_apply", "gcr_stream_step", "ap_update", "basis_flush", "gcr_z_step", "update_xr",
      "dir_update", "restrict", "prolong")),
    ("mg_record", CLI_SOLVE + ["--mg", "--coarse-format", "stencil", "--block", str(REC_BLOCK),
                               "--nullvecs", str(REC_NULLVECS), "--no-smoother"],
     ("dslash_apply", "gcr_z_step", "restrict", "prolong", "stencil_spmv")),
    ("eo", CLI_SOLVE + ["--eo"], ("update_r", "beta_dots", "ap_update", "basis_flush")),
    ("ksweep", ["ksweep", "--platform", "cuda", "--dtype", "cf32", "--lattice", "16", "16", "16",
                "16", "--kmin", "0.1", "--kmax", str(K), "--n", "3", "--tol", "1e-6",
                "--restart", str(RESTART), "--fused", "--antiperiodic"], PLAIN_KERNELS),
)
MG_DIST_BLOCK = 4  # the 16^4 thread grids' block: 8 does not divide the (4, 1) grid's T = 4 shards
MG_DIST_GRIDS = ((2, 2), (4, 1))


def _cli(argv) -> tuple[int, list, float, dict]:
    """``cli.main(argv)`` in this process with the launch counts set to 0
    just before and read just after: (exit code, the JSON lines it printed,
    wall seconds, launch counts)."""
    import contextlib
    import io

    import torch

    from mgpgcr_tpu_torch import cli, kernels

    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    out = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    return rc, out, wall, kernels.launch_counts()


def cli_phase(card: str) -> list:
    """The command line in this process (``mgpgcr_tpu_torch.cli.main``): the
    32^4 solves of CLI_RUNS (the CLI's own Haar-random links, seed 0, and
    right-hand side), a 3-point ksweep at 16^4, and ``generate`` at 8^4
    followed by ``solve --matrix`` on the file (Wilson detection, the Dslash
    kernel on 3-row links); each run converged, its independent residual
    (the CLI's own, in f32) <= 2e-6, and its kernels launched; then one
    ``python -m mgpgcr_tpu_torch info`` subprocess. Returns the runs'
    launch counts."""
    import tempfile

    t1 = time.perf_counter()
    runs, all_counts = {}, []

    def drive(name, argv, expect):
        rc, out, wall, counts = _cli(argv)
        check(rc == 0 and out, f"cli {name}: exit {rc}")
        for o in out:
            check(o["converged"] and o["indep_relres"] <= 2e-6,
                  f"cli {name}: converged, independent residual {o['indep_relres']} <= 2e-6")
        missing = [k for k in expect if counts[k] == 0]
        check(not missing, f"cli {name}: {missing} not launched: {counts}")
        runs[name] = {"argv": " ".join(argv), "results": out, "wall_s": wall,
                      "launches": {k: v for k, v in counts.items() if v}}
        all_counts.append(counts)

    for name, argv, expect in CLI_RUNS:
        drive(name, argv, expect)
    check(runs["eo"]["results"][0]["iters"] < runs["plain"]["results"][0]["iters"],
          "cli: the Schur solve takes fewer iterations than the full one")
    check(runs["mg"]["results"][0]["iters"] < runs["plain"]["results"][0]["iters"],
          "cli: MG takes fewer outer iterations than the plain solve")
    with tempfile.TemporaryDirectory() as tmp:
        fixture = f"{tmp}/w8.txt"
        rc, out, wall, _ = _cli(["generate", fixture, "--lattice", "8", "8", "8", "8",
                                 "--seed", "1"])
        check(rc == 0 and out[0]["rows"] == 12 * 8**4, f"cli generate: {out}")
        runs["generate"] = {"results": out, "wall_s": wall}
        drive("matrix", ["solve", "--platform", "cuda", "--dtype", "cf32", "--matrix", fixture,
                         "--k", str(K), "--tol", "1e-6", "--restart", str(RESTART), "--fused"],
              PLAIN_KERNELS)
    check(runs["matrix"]["results"][0].get("detected_wilson") is True,
          "cli: the generated matrix was detected as Wilson and routed to the Dslash kernel")
    s0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mgpgcr_tpu_torch", "info"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"python -m mgpgcr_tpu_torch info: {proc.stderr[-2000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    check(info["backend"] == "cuda" and info["device_kind"], f"info: {info}")
    emit("cli", t1, card=card, info=info, info_s=time.perf_counter() - s0, **runs)
    return all_counts


def _mg16(dev):
    """The untiled 16^4 field: (canonical links, mesh, operator, rhs,
    independent f64 residual)."""
    import numpy as np
    import torch

    from mgpgcr_tpu_torch import CudaWilsonDirac, DiracOperator, LatticeMesh, cplx

    with np.load(ROOT / "data" / "links_16_b6.0_s0.npz") as f:
        canon = (f["re"], f["im"])
    mesh = LatticeMesh((16, 16, 16, 16, 4, 3))
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape, torch.float32,
                    dev)
    return canon, mesh, DiracOperator(op, K), b, independent_residual(canon, mesh, b)


def checkpoint_phase(dev, card: str) -> dict:
    """``save_mg_setup`` / ``load_mg_setup`` of the MG cell's hierarchy
    (block 8, 6 null vectors, dense coarse, GCR(4) smoother on bf16 links)
    on the untiled 16^4 field: at 32^4 the basis alone is 1.2 GB before
    compression, so the phase prints the 32^4 estimate (16x the volume)
    from the measured times. The loaded V-cycle is bit-equal to the
    original on the card, and the MG solve with it takes the same outer
    iterations. Returns the launch counts of the solve with the loaded
    hierarchy."""
    import os
    import tempfile

    import torch

    from mgpgcr_tpu_torch import (
        GCRParams, MGParams, load_mg_setup, save_mg_setup, setup_mg, with_link_dtype,
    )

    t1 = time.perf_counter()
    _, mesh, a, b, independent_relres = _mg16(dev)
    a_smooth = type(a)(with_link_dtype(a.d, torch.bfloat16), K)
    mgp = setup_mg(torch.Generator(device=dev).manual_seed(3), a, mesh,
                   MGParams(block=MG_BLOCK, n_nullvecs=MG_NULLVECS), smoother_operator=a_smooth)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mg16.npz")
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        save_mg_setup(path, mgp)
        save_s = time.perf_counter() - s0
        nbytes = os.path.getsize(path)
        s0 = time.perf_counter()
        loaded = load_mg_setup(path, a, smoother_operator=a_smooth)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - s0
    y0, y1 = mgp.apply(b), loaded.apply(b)
    check(torch.equal(y0.re, y1.re) and torch.equal(y0.im, y1.im),
          "the loaded V-cycle is bit-equal to the original")
    outer = GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=True, unroll="cycles")
    from mgpgcr_tpu_torch import gcr_solve

    runs = {}
    for what, m in (("original", mgp), ("loaded", loaded)):
        runs[what] = _timed_solve(lambda: gcr_solve(a, b, outer, precond=m.apply), b,
                                  independent_relres, f"checkpoint {what}")
    check(runs["original"]["iters"] == runs["loaded"]["iters"],
          "the loaded hierarchy takes the original's outer iterations")
    basis_gb = 2 * 4 * mgp.q_field.re.numel() / 1e9
    emit("checkpoint", t1, card=card, lattice=list(mesh.dims), block=MG_BLOCK,
         n_nullvecs=MG_NULLVECS, file_mb=nbytes / 1e6, basis_gb=basis_gb, save_s=save_s,
         load_s=load_s, estimate_32_save_s=16 * save_s, estimate_32_load_s=16 * load_s,
         estimate_32_basis_gb=16 * basis_gb, runs=runs)
    return runs["loaded"]["launches"]


class _World1:
    """A one-process NCCL group (world size 1) for the duration of a block;
    ``comm`` is its ``TorchDistComm`` on a one-rank ``t`` grid."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import tempfile

        from mgpgcr_tpu_torch.parallel import TorchDistComm, init_distributed, make_shard_grid

        self._tmp = tempfile.TemporaryDirectory()
        init_distributed(f"file://{self._tmp.name}/rendezvous", 1, 0, device=self.dev)
        self.comm = TorchDistComm(make_shard_grid((1,), ("t",), device=self.dev), device=self.dev)
        return self

    def __exit__(self, *exc):
        import torch

        backend = torch.distributed.get_backend()
        torch.distributed.destroy_process_group()
        self._tmp.cleanup()
        check(backend == "nccl", f"world-1 group on {backend}")


def shard_kernel_parity(comm, mgp, gen, axis_z) -> list:
    """B10, B11, B14 and B15 on this rank's shard of a sharded MG (the shard
    shapes the mg_dist paths give them), each against its plain version;
    returns (kernel, case, (rel, abs), tol) for the parity record."""
    import torch

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.kernels import transfer
    from mgpgcr_tpu_torch.kernels.dslash_dist import dslash_dist, dslash_dist_plain, psi_ghosts
    from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import (
        gcr_stream_step_dist, gcr_stream_step_dist_plain, step_ghosts,
    )

    d = mgp.a.d
    lm, dev = d.local_mesh, d.device
    tag = f"shard {lm.spacetime_dims}"
    fshape = d.field_shape
    x = cplx.random(gen, fshape, torch.float32, dev)
    lbm = mgp.geom.local_block_map()
    nc = mgp.q_field.shape[0] * lbm.n_blocks
    xc = cplx.random(gen, (nc,), torch.float32, dev)
    errs = [("restrict", tag, rel_err(transfer.restrict(mgp.q_field, lbm, x),
                                      transfer.restrict_plain(mgp.q_field, lbm, x)), FIELD_TOL),
            ("prolong", tag, rel_err(transfer.prolong(mgp.q_field, lbm, xc, x, 0.7),
                                     transfer.prolong_plain(mgp.q_field, lbm, xc, x, 0.7)),
             FIELD_TOL)]
    kt = torch.tensor(K, dtype=torch.complex64, device=dev)
    g = psi_ghosts(x, comm, "t", axis_z, True, d.ghost_links)
    errs.append(("dslash_dist", tag, rel_err(dslash_dist(d.links, x, lm, g, kt),
                                             dslash_dist_plain(d.links, x, lm, g, kt)), FIELD_TOL))
    S = RESTART
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    for lim in (1, S):
        gs = step_ghosts(x, aps, alpha, lim, comm, "t", axis_z, True, d.ghost_links)
        out = gcr_stream_step_dist(d.links, x, aps, alpha, kt, lim, lm, gs)
        pl = gcr_stream_step_dist_plain(d.links, x, aps, alpha, kt, lim, lm, gs)
        errs += [("gcr_stream_step_dist", f"{tag} r'/lim={lim}", rel_err(out[0], pl[0]),
                  FIELD_TOL),
                 ("gcr_stream_step_dist", f"{tag} az/lim={lim}", rel_err(out[1], pl[1]),
                  FIELD_TOL),
                 ("gcr_stream_step_dist", f"{tag} r2/lim={lim}", rel_err(out[2], pl[2]),
                  DOT_TOL)]
    return errs


def _mg_dist_rank(comm, canon, mesh, b, params, outer, axis_z, parity: bool):
    """One rank of a sharded MG run: the setup (phase seconds), a warm-up
    solve and a timed one with the launch counts set to 0 just before and
    read just after (reset and read by rank 0 between barriers, so that no
    rank launches while they are read), and, with
    ``parity``, the shard kernels against their plain versions."""
    import torch

    from mgpgcr_tpu_torch import (
        DiracOperator, ShardLocalWilsonDirac, kernels, mg_gcr_solve_sharded, setup_mg_sharded,
        shard_field,
    )

    d = ShardLocalWilsonDirac.build(canon, mesh, comm, "t", axis_z, compress=True,
                                    antiperiodic_t=True)
    a = DiracOperator(d, K)
    timings = {}
    torch.cuda.synchronize()
    comm.barrier()
    if comm.rank == 0:
        kernels.reset_launches()
    comm.barrier()
    s0 = time.perf_counter()
    mgp = setup_mg_sharded(torch.Generator(device=comm.device).manual_seed(3), a, params,
                           timings=timings)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s0
    comm.barrier()
    setup_counts = kernels.launch_counts() if comm.rank == 0 else None
    comm.barrier()
    bl = shard_field(b, comm.grid, comm.rank, "t", axis_z)
    mg_gcr_solve_sharded(bl, outer, mgp)  # warm-up
    torch.cuda.synchronize()
    comm.barrier()
    if comm.rank == 0:
        kernels.reset_launches()
    comm.barrier()
    s0 = time.perf_counter()
    res = mg_gcr_solve_sharded(bl, outer, mgp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    comm.barrier()
    counts = kernels.launch_counts() if comm.rank == 0 else None
    comm.barrier()
    errs = shard_kernel_parity(comm, mgp, torch.Generator(device=comm.device).manual_seed(
        40 + comm.rank), axis_z) if parity else []
    return dict(res=res, wall=wall, setup_s=setup_s, timings=timings, counts=counts,
                setup_counts=setup_counts, errs=errs)


def mg_dist_phase(canon, mesh, dev, card: str, mg_iters: int) -> tuple[list, list]:
    """The sharded MG setup and the distributed MG-preconditioned solve
    (``setup_mg_sharded``, ``mg_gcr_solve_sharded``; outer restart-5 fused
    GCR in restart cycles, GCR(4) fused smoother on the shards):

    - a world-size-1 NCCL group at 32^4 with the MG cell's block 8 and 6
      null vectors, within 1 outer iteration of the single-device MG cell
      (``mg_iters``, whose smoother runs on bf16 links; this one's on the
      f32 links: the JAX package's sharded cycle has no cheaper smoother);
    - the (2, 2) and (4, 1) grids of thread ranks on the untiled 16^4 field
      with block 4 and 6 null vectors (8 does not divide the (4, 1) grid's
      T = 4 shards), each within 1 outer iteration of the single-device
      16^4 MG solve with the same parameters and start vector.

    Setup seconds by phase, host ms per outer iteration (rank 0's clock),
    launches, the independent f64 residual of the gathered x; B10, B11,
    B14 and B15 against their plain versions at every shard shape. Returns
    (launch counts of setups and solves, parity errors)."""
    import torch

    from mgpgcr_tpu_torch import (
        GCRParams, MGParams, gather_field, gcr_solve, make_shard_grid, run_spmd, setup_mg,
    )

    t1 = time.perf_counter()
    outer = GCRParams(tol=1e-6, max_iter=200, restart=RESTART, fused=True, unroll="cycles")
    out, all_counts, errs = {}, [], []
    solve_kernels = ("dslash_dist", "gcr_stream_step_dist", "update_r", "ap_update",
                     "basis_flush", "restrict", "prolong")

    def record(tag, ranks, x, independent_relres, single_iters):
        r0 = ranks[0]
        res = r0["res"]
        check(all(rk["res"].n_iters == res.n_iters for rk in ranks), f"{tag}: ranks agree")
        check(res.converged, f"{tag} converged")
        rel = independent_relres(x)
        check(rel <= 2e-6, f"{tag} independent residual {rel} <= 2e-6")
        check(abs(res.n_iters - single_iters) <= 1,
              f"{tag}: outer iterations {res.n_iters} within 1 of the single-device "
              f"{single_iters}")
        counts = r0["counts"]
        missing = [k for k in solve_kernels if counts[k] == 0]
        check(not missing and counts["dslash_apply"] == 0 and counts["gcr_stream_step"] == 0,
              f"{tag}: {missing} not launched, or K1/K2 launched: {counts}")
        check(r0["setup_counts"]["dslash_dist"] > 0 and r0["setup_counts"]["restrict"] > 0,
              f"{tag}: the setup ran B14 and B10")
        all_counts.extend([counts, r0["setup_counts"]])
        for rk in ranks:
            errs.extend(rk["errs"])
        out[tag] = {"outer_iters": res.n_iters, "single_device_outer_iters": single_iters,
                    "relres": res.final_relres, "independent_relres_f64": rel,
                    "setup_seconds": r0["setup_s"], "setup_phase_seconds": r0["timings"],
                    "seconds": r0["wall"], "ms_per_outer_iter": 1e3 * r0["wall"] / res.n_iters,
                    "launches": {k: v for k, v in counts.items() if v},
                    "setup_launches": {k: v for k, v in r0["setup_counts"].items() if v}}

    # world-1 NCCL at 32^4, the MG cell's parameters
    t, z, y, xx = mesh.spacetime_dims
    b = cplx_random(dev, (4, 3, t, z, y * xx), 7)
    independent_relres = independent_residual(canon, mesh, b)
    params = MGParams(block=MG_BLOCK, n_nullvecs=MG_NULLVECS)
    with _World1(dev) as w:
        rk = _mg_dist_rank(w.comm, canon, mesh, b, params, outer, None, True)
    record("nccl_world1_32", [rk], rk["res"].x, independent_relres, mg_iters)
    del rk

    # thread grids at 16^4 against the single-device 16^4 solve
    canon16, mesh16, a16, b16, indep16 = _mg16(dev)
    params16 = MGParams(block=MG_DIST_BLOCK, n_nullvecs=MG_NULLVECS)
    single = setup_mg(torch.Generator(device=dev).manual_seed(3), a16, mesh16, params16)
    ref = _timed_solve(lambda: gcr_solve(a16, b16, outer, precond=single.apply), b16, indep16,
                       "single-device 16^4 MG")
    del single
    for sizes in MG_DIST_GRIDS:
        grid = make_shard_grid(sizes, ("t", "z"), device=dev)
        ranks = run_spmd(grid, lambda comm: _mg_dist_rank(comm, canon16, mesh16, b16, params16,
                                                          outer, "z", True))
        x = gather_field([rk["res"].x for rk in ranks], grid, "t", "z")
        record(f"thread_{sizes[0]}x{sizes[1]}_16", ranks, x, indep16, ref["iters"])
        del ranks
    emit("mg_dist", t1, card=card, k=K, tol=1e-6, restart=RESTART, unroll="cycles",
         block_32=MG_BLOCK, block_16=MG_DIST_BLOCK, n_nullvecs=MG_NULLVECS,
         single_device_16=ref, **out)
    return all_counts, errs


def cplx_random(dev, shape, seed: int):
    """A seeded f32 random CF on ``dev``."""
    import torch

    from mgpgcr_tpu_torch import cplx

    return cplx.random(torch.Generator(device=dev).manual_seed(seed), shape, torch.float32, dev)


def eo_dist_phase(canon, mesh, dev, card: str) -> list:
    """The even-odd Schur solve on (t, z) shards (``eo_sharded``, the t and z
    hops exchanging planes through the communicator, the Schur GCR's dots
    summed over ranks): a (2, 2) grid of thread ranks on the untiled 16^4
    field and a world-size-1 NCCL group at 32^4, each against ``eo_solve``
    on one device (iterations equal, x within 1e-5 of scale), x checked
    against the full operator in f64. Returns the launch counts."""
    import torch

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, EvenOddWilson, GCRParams, LatticeMesh, eo_sharded, eo_solve,
        eo_solve_grid, make_shard_grid,
    )

    t1 = time.perf_counter()
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    out, all_counts = {}, []
    import numpy as np

    with np.load(ROOT / "data" / "links_16_b6.0_s0.npz") as f:
        canon16 = (f["re"], f["im"])
    cases = (("thread_2x2_16", canon16, LatticeMesh((16, 16, 16, 16, 4, 3))),
             ("nccl_world1_32", canon, mesh))
    for tag, cn, m in cases:
        d = CudaWilsonDirac.build(cn, m, antiperiodic_t=True, device=dev)
        eo = EvenOddWilson.from_dirac(d)
        b = cplx_random(dev, d.field_shape, 7)
        indep = independent_residual(cn, m, b)
        got = {}

        def kept(key, fn):
            def run():
                got[key] = fn()
                return got[key]
            return run

        ref = _timed_solve(kept("ref", lambda: eo_solve(eo, K, b, params)), b, indep,
                           f"eo {tag} single")
        if tag.startswith("thread"):
            grid = make_shard_grid((2, 2), ("t", "z"), device=dev)
            run = _timed_solve(kept("sharded", lambda: eo_solve_grid(eo, K, b, params, grid)), b,
                               indep, f"eo {tag}")
        else:
            with _World1(dev) as w:
                local = eo_sharded(eo, w.comm, "t", None)
                run = _timed_solve(kept("sharded", lambda: eo_solve(local, K, b, params)), b,
                                   indep, f"eo {tag}")
        xerr = rel_err(got["sharded"].x, got["ref"].x)[0]
        check(run["iters"] == ref["iters"],
              f"eo {tag}: Schur iterations {run['iters']} == eo_solve's {ref['iters']}")
        check(xerr <= 1e-5, f"eo {tag}: x within 1e-5 of the single-device x: {xerr}")
        check(all(run["launches"][k] > 0 for k in ("update_r", "beta_dots", "ap_update",
                                                   "basis_flush")),
              f"eo {tag}: B2, B3, K3, K4 launched: {run['launches']}")
        all_counts.append(run["launches"])
        out[tag] = {"sharded": run, "single_device": ref, "x_rel_diff": xerr}
        del d, eo
    emit("eo_dist", t1, card=card, k=K, tol=1e-6, restart=RESTART, **out)
    return all_counts


def graft_phase(dev, card: str) -> dict:
    """``__graft_entry_cuda__``: ``entry()``'s solve step on the card (8^4,
    K1), then ``dryrun_multichip(4)``: the fused sharded solve against the
    single-device one, the sharded MG, the sharded even-odd solve, the
    canonical operator over (t, z, y) and stacked right-hand sides over a
    data-parallel axis, four thread ranks sharing the card. Returns the
    launch counts of the entry step and the dry run."""
    import importlib

    import torch

    from mgpgcr_tpu_torch import kernels

    t1 = time.perf_counter()
    graft = importlib.import_module("__graft_entry_cuda__")
    fn, args = graft.entry()
    torch.cuda.synchronize()
    kernels.reset_launches()
    x, relres = fn(*args)
    torch.cuda.synchronize()
    entry_counts = kernels.launch_counts()
    check(x.re.is_cuda and bool(torch.isfinite(x.re).all()) and relres < 1.0,
          f"entry step on the card: relres {relres}")
    check(entry_counts["dslash_apply"] > 0, f"entry ran K1: {entry_counts}")
    kernels.reset_launches()
    s0 = time.perf_counter()
    graft.dryrun_multichip(4)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - s0
    dry_counts = kernels.launch_counts()
    check(dry_counts["gcr_stream_step_dist"] > 0 and dry_counts["dslash_dist"] > 0,
          f"the dry run ran B14 and B15: {dry_counts}")
    emit("graft", t1, card=card, entry_relres=relres, dryrun_seconds=dry_s,
         entry_launches={k: v for k, v in entry_counts.items() if v},
         dryrun_launches={k: v for k, v in dry_counts.items() if v})
    return {k: entry_counts[k] + dry_counts[k] for k in entry_counts}



def main() -> int:
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, LatticeMesh, cplx, eo_half_mesh, gcr_solve,
        links_from_numpy,
    )
    from mgpgcr_tpu_torch import kernels
    from mgpgcr_tpu_torch.kernels import _lib
    from mgpgcr_tpu_torch.kernels.dslash import dslash_apply, dslash_plain
    from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_stream_step_plain
    from mgpgcr_tpu_torch.kernels.gcr_kernels import (
        ap_update, ap_update_plain, basis_flush, basis_flush_plain,
    )
    from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t, dirac_apply_np, random_links_np
    from mgpgcr_tpu_torch.ops.wilson_slab import field_from_slab, field_to_slab

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_lib.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit("device", t0, nvidia_smi=card, torch_name=name, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         count=torch.cuda.device_count())

    # ---- build -----------------------------------------------------------
    t1 = time.perf_counter()
    path, ptxas = _lib.build_library(verbose=True)
    _lib.library()
    print(ptxas, file=sys.stderr)
    emit("build", t1, library=str(path.relative_to(ROOT)))
    emit("registers", t1, kernels=ptxas_report(ptxas))

    # ---- oracle: a small lattice against the numpy oracle ----------------
    t1 = time.perf_counter()
    small = LatticeMesh((4, 4, 4, 4, 4, 3))
    lk = random_links_np(5, small)
    rng = np.random.default_rng(6)
    xs = rng.standard_normal(small.size) + 1j * rng.standard_normal(small.size)
    op = CudaWilsonDirac.build(lk, small, compress=True, antiperiodic_t=True, device=dev)
    psi = cplx.from_numpy(field_to_slab(torch.as_tensor(xs), small).numpy(), device=dev)
    got = field_from_slab(torch.as_tensor(cplx.to_numpy(op.apply_dirac(psi, K))), small).numpy()
    ref = dirac_apply_np(antiperiodic_t(lk), small, xs, K)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(err <= FIELD_TOL, f"4^4 kernel vs numpy oracle {err}")
    emit("oracle", t1, lattice=list(small.dims), rel_err=err, tol=FIELD_TOL)

    # ---- the 32^4 inputs ---------------------------------------------------
    t1 = time.perf_counter()
    mesh = LatticeMesh((32, 32, 32, 32, 4, 3))
    with np.load(ROOT / "data" / "links_16_b6.0_s0.npz") as f:
        reps = (1, 2, 2, 2, 2, 1, 1)
        canon = (np.tile(f["re"], reps), np.tile(f["im"], reps))
    variants = {
        (rows, lname): links_from_numpy(canon, mesh, dev, compress=rows == 2, link_dtype=ldt)
        for rows in (3, 2)
        for lname, ldt in (("f32", torch.float32), ("bf16", torch.bfloat16))
    }
    main_links = variants[(2, "f32")]
    fshape = (4, 3, 32, 32, 32 * 32)
    gen = torch.Generator(device=dev).manual_seed(11)
    psi = cplx.random(gen, fshape, torch.float32, dev)
    kt = torch.tensor(K, dtype=torch.complex64, device=dev)
    emit("inputs", t1, lattice=list(mesh.dims), source="data/links_16_b6.0_s0.npz tiled x2 in t,z,y,x")

    # ---- parity: every kernel against its plain version at 32^4 ----------
    t1 = time.perf_counter()
    max_abs = {k: 0.0 for k in REPLACES}  # field outputs against the f32 plain version
    max_abs_dot = {k: 0.0 for k in REPLACES}  # reductions against the f64 one
    worst = {}

    def note(kname, what, err, tol):
        rel, ab = err
        check(rel <= tol, f"{kname} {what}: {rel} > {tol}")
        held = max_abs if tol == FIELD_TOL else max_abs_dot
        held[kname] = max(held[kname], ab)
        worst[f"{kname}:{what}"] = rel

    for (rows, lname), lt in variants.items():
        for kk in (None, kt):
            for anti in (False, True):
                what = f"{lname}/{rows}row/k={kk is not None}/anti_t={anti}"
                got = dslash_apply(lt, psi, mesh, kk, anti)
                note("dslash_apply", what, rel_err(got, dslash_plain(lt, psi, mesh, kk, anti)),
                     FIELD_TOL)

    S = RESTART
    aps = cplx.random(gen, (S,) + fshape, torch.float32, dev)
    r = cplx.random(gen, fshape, torch.float32, dev)
    alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
    aps64, r64 = f64(aps), f64(r)
    for lim in range(1, S + 1):
        out = gcr_stream_step(main_links, r, aps, alpha, kt, lim, mesh, anti_t=True)
        pl = gcr_stream_step_plain(main_links, r, aps, alpha, kt, lim, mesh, anti_t=True)
        p64 = gcr_stream_step_plain(main_links, r64, aps64, f64(alpha), f64(kt), lim, mesh, True)
        note("gcr_stream_step", f"r'/lim={lim}", rel_err(out[0], pl[0]), FIELD_TOL)
        note("gcr_stream_step", f"az/lim={lim}", rel_err(out[1], pl[1]), FIELD_TOL)
        note("gcr_stream_step", f"r2/lim={lim}", rel_err(out[2], p64[2]), DOT_TOL)
        note("gcr_stream_step", f"raw/lim={lim}", rel_err(out[3][:lim], p64[3][:lim]), DOT_TOL)
        note("gcr_stream_step", f"apr/lim={lim}", rel_err(out[4][:lim], p64[4][:lim]), DOT_TOL)
        note("gcr_stream_step", f"azr/lim={lim}", rel_err(out[4][S:], p64[4][S:]), DOT_TOL)
        check(bool((out[3][lim:] == 0).all()) and bool((out[4][lim:S] == 0).all()),
              f"gcr_stream_step rows from lim={lim} are zero")
    del aps64, r64

    betas = torch.complex(torch.rand(S, generator=gen, device=dev),
                          torch.rand(S, generator=gen, device=dev)) - (0.5 + 0.5j)
    for lim in range(1, S + 1):
        slot = lim % S
        got_aps, got_n = ap_update(r, aps.clone(), betas, slot, lim)
        ref_aps, _ = ap_update_plain(r, aps.clone(), betas, slot, lim)
        _, ref_n = ap_update_plain(f64(r), f64(aps), f64(betas), slot, lim)
        note("ap_update", f"ap/lim={lim}", rel_err(got_aps[slot], ref_aps[slot]), FIELD_TOL)
        note("ap_update", f"norm/lim={lim}", rel_err(got_n, ref_n), DOT_TOL)

    basis_all = [aps[m] for m in range(S)] + [r]
    for lim in range(1, S + 1):
        nb = lim + 1
        w = torch.complex(torch.rand(2, nb, generator=gen, device=dev),
                          torch.rand(2, nb, generator=gen, device=dev))
        got = basis_flush(psi, basis_all[:nb], w[0], w[1])
        ref = basis_flush_plain(psi, basis_all[:nb], w[0], w[1])
        note("basis_flush", f"x/nb={nb}", rel_err(got[0], ref[0]), FIELD_TOL)
        note("basis_flush", f"p0/nb={nb}", rel_err(got[1], ref[1]), FIELD_TOL)
    mg_inputs = mg_kernel_parity(mesh, variants, gen, note, S)
    loop_inputs = loop_kernel_parity(fshape, dev, gen, note, S)
    new_inputs = new_kernel_parity(mesh, canon, variants, psi, kt, gen, note)
    hshape = (4, 3, 32, 32, 32 * 16)  # the even-odd paths' half fields and half mesh
    algebra_parity(hshape, gen, note, S, "half 32^4")
    half_transfer_parity(eo_half_mesh(mesh), gen, note,
                         cplx.random(gen, hshape, torch.float32, dev))
    torch.cuda.synchronize()
    emit("parity", t1, cases=len(worst), field_tol=FIELD_TOL, dot_tol=DOT_TOL,
         worst={k: max(v for kk, v in worst.items() if kk.startswith(k + ":")) for k in max_abs
                if any(kk.startswith(k + ":") for kk in worst)},
         max_abs_err=max_abs, max_abs_err_reductions=max_abs_dot)

    # ---- timing ------------------------------------------------------------
    t1 = time.perf_counter()
    n_sites = mesh.n_sites

    variant_ms = {}
    for (rows, lname), lt in variants.items():
        variant_ms[f"{lname}/{rows}row"] = cuda_ms(lambda: dslash_apply(lt, psi, mesh, kt, True))
    d_bytes = n_sites * (LINK_B[(2, "f32")] + 2 * FIELD_B)
    d_flops = n_sites * (DSLASH_FLOPS_PER_SITE + RECON_FLOPS + K_FLOPS)
    table = {}
    ms = cuda_ms(lambda: dslash_apply(main_links, psi, mesh, kt, True))
    HOST_FREE["dslash_apply"] = graph_ms(lambda: dslash_apply(main_links, psi, mesh, kt, True))
    pms = cuda_ms(lambda: dslash_plain(main_links, psi, mesh, kt, True), reps=5, warmup=1)
    table["dslash_apply"] = (ms, pms, *bound(d_bytes, d_flops), None, d_bytes)

    def cycle(fn):
        for lim in range(1, S + 1):
            fn(lim)

    ms = cuda_ms(lambda: cycle(lambda lim: gcr_stream_step(
        main_links, r, aps, alpha, kt, lim, mesh, anti_t=True))) / S
    HOST_FREE["gcr_stream_step"] = graph_ms(lambda: cycle(lambda lim: gcr_stream_step(
        main_links, r, aps, alpha, kt, lim, mesh, anti_t=True)), calls=S, launches=8)
    pms = cuda_ms(lambda: cycle(lambda lim: gcr_stream_step_plain(
        main_links, r, aps, alpha, kt, lim, mesh, anti_t=True)), reps=3, warmup=1) / S
    # per call, averaged over one cycle's lim = 1..S
    g_bytes = sum(n_sites * (LINK_B[(2, "f32")] + (1 + lim) * FIELD_B + 2 * FIELD_B)
                  for lim in range(1, S + 1)) / S
    g_flops = sum(n_sites * (DSLASH_FLOPS_PER_SITE + RECON_FLOPS + K_FLOPS + 96
                             + (2 * lim + 1) * 96 + 48) for lim in range(1, S + 1)) / S
    table["gcr_stream_step"] = (ms, pms, *bound(g_bytes, g_flops), None, g_bytes)

    scratch = aps.clone()
    ms = cuda_ms(lambda: cycle(lambda lim: ap_update(r, scratch, betas, lim % S, lim))) / S
    pms = cuda_ms(lambda: cycle(lambda lim: ap_update_plain(r, scratch, betas, lim % S, lim)),
                  reps=5, warmup=1) / S
    a_bytes = sum(n_sites * ((lim + 1) * FIELD_B + FIELD_B) for lim in range(1, S + 1)) / S
    a_flops = sum(n_sites * 12 * (8 * lim + 4) for lim in range(1, S + 1)) / S
    table["ap_update"] = (ms, pms, *bound(a_bytes, a_flops), None, a_bytes)
    del scratch

    nb = S + 1
    basis = basis_all[:nb]
    w = torch.complex(torch.rand(2, nb, generator=gen, device=dev),
                      torch.rand(2, nb, generator=gen, device=dev))
    ms = cuda_ms(lambda: basis_flush(psi, basis, w[0], w[1]))
    pms = cuda_ms(lambda: basis_flush_plain(psi, basis, w[0], w[1]), reps=5, warmup=1)
    # the library yardstick: one einsum over the stacked complex basis with x
    # as one more basis vector of weight (1, 0)
    stacked = torch.stack([torch.complex(psi.re, psi.im).reshape(-1)]
                          + [torch.complex(b.re, b.im).reshape(-1) for b in basis])
    wl = torch.cat([torch.tensor([[1, 0]], dtype=torch.complex64, device=dev), w.T])
    lms = cuda_ms(lambda: torch.einsum("mk,mn->kn", wl, stacked))
    lib = torch.einsum("mk,mn->kn", wl, stacked)
    del stacked
    want = basis_flush_plain(psi, basis, w[0], w[1])
    for got, ref in zip(lib, want):
        check(rel_err(got, torch.complex(ref.re, ref.im).reshape(-1))[0] <= FIELD_TOL,
              "basis_flush's einsum yardstick")
    del lib, want
    f_bytes = n_sites * ((1 + nb) * FIELD_B + 2 * FIELD_B)
    f_flops = n_sites * 12 * 16 * nb
    table["basis_flush"] = (ms, pms, *bound(f_bytes, f_flops), lms, f_bytes)
    extra = mg_kernel_timing(mesh, variants, mg_inputs, S, table)
    kernel_variants = {}  # the r forms of K3 and B7
    extra.update(loop_kernel_timing(loop_inputs, n_sites, S, table, kernel_variants))
    extra.update(new_kernel_timing(mesh, new_inputs, psi, kt, table))
    torch.cuda.synchronize()
    emit("timing", t1, card=card, dslash_variants_ms=variant_ms, **extra,
         kernels={k: {"ms": v[0], "graph_ms": HOST_FREE.get(k), "plain_ms": v[1],
                      "bound_ms": v[2], "bound_by": v[3], "library_ms": v[4], "bytes": v[5]}
                  for k, v in table.items()},
         variants=kernel_variants)
    del aps, r, psi, variants, mg_inputs, loop_inputs, new_inputs, basis, basis_all

    # ---- solve: the plain path --------------------------------------------
    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape,
                    torch.float32, dev)
    independent_relres = independent_residual(canon, mesh, b)

    forms = {"fused": True, "generic": False}
    solves = {}
    for fused in forms.values():  # warm-up: first-call costs stay out of the time
        gcr_solve(a, b, GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=fused))
    # two timed runs of each form, in turns: fused, generic, generic, fused
    for form in ("fused", "generic", "generic", "fused"):
        params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=forms[form])
        torch.cuda.synchronize()
        kernels.reset_launches()
        s0 = time.perf_counter()
        res = gcr_solve(a, b, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        counts = kernels.launch_counts()
        check(res.converged, f"{form} solve converged")
        x = res.x
        check(x.shape == op.field_shape and bool(torch.isfinite(x.re).all())
              and bool(torch.isfinite(x.im).all()), f"{form} solution finite, shape {x.shape}")
        rel = independent_relres(x)
        check(rel <= 2e-6, f"{form} independent residual {rel} <= 2e-6")
        if form in solves:
            solves[form]["seconds"].append(wall)
            check(solves[form]["launches"] == counts and solves[form]["iters"] == res.n_iters,
                  f"{form} runs repeat")
            continue
        if form == "fused":
            x_plain = x
        solves[form] = {"iters": res.n_iters, "relres": res.final_relres,
                        "independent_relres_f64": rel, "seconds": [wall], "launches": counts}
    for v in solves.values():
        v["ms_per_iter"] = [1e3 * w / max(v["iters"], 1) for w in v["seconds"]]
    check(abs(solves["fused"]["iters"] - solves["generic"]["iters"]) <= 2,
          "fused and generic iteration counts within 2")
    plain_counts = solves["fused"]["launches"]
    check(all(plain_counts[k] > 0 for k in PLAIN_KERNELS),
          f"every kernel of the plain path launched {plain_counts}")
    # device time of the four kernels per fused iteration, from the timing
    # phase: one K2 and one K3 per iteration, one K4 per cycle
    kernel_ms = table["gcr_stream_step"][0] + table["ap_update"][0] + table["basis_flush"][0] / S
    emit("solve", t1, card=card, k=K, tol=1e-6, restart=RESTART,
         fused_kernel_ms_per_iter=kernel_ms, **solves)
    if profile:
        profile_solve(a, b, GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True), card)
    del op, a

    # ---- the MG path -------------------------------------------------------
    mg = mg_path(canon, mesh, dev, card, independent_relres, profile)

    # ---- the loop-form and eager paths ---------------------------------------
    loop_counts, loop_iters = loop_path(mg["a"], mg["b"], mg["mgp"], card, independent_relres,
                                        {"plain": solves["fused"]["iters"],
                                         "mg": mg["outer_iters"]}, profile)
    mg_counts, mg_iters = mg["counts"], mg["outer_iters"]
    del mg

    # ---- the config of record, three levels, mu-major links -----------------
    record_counts = record_path(canon, mesh, dev, card, independent_relres, profile)
    three_counts = three_level_path(canon, mesh, dev, card, independent_relres,
                                    {"cycles": mg_iters, "auto": loop_iters}, profile)
    mu_counts = mu_major_path(canon, mesh, dev, card, independent_relres,
                              solves["fused"]["iters"])

    # ---- the domain-decomposed solve: B14 and B15 --------------------------
    for kname, what, err, tol in dist_kernel_phase(canon, mesh, dev, card, table):
        note(kname, what, err, tol)
    dist_counts = dist_solve_phase(canon, mesh, dev, card, b, independent_relres,
                                   solves["fused"]["iters"], x_plain)

    # ---- refinement, eigenpairs, even-odd, heat bath, ingestion ------------
    refine_counts = refine_phase(canon, mesh, dev, card, b, independent_relres)
    eigen_counts = eigen_phase(canon, mesh, dev, card)
    eo_counts, schur_ms = eo_solve_phase(canon, mesh, dev, card, solves["fused"]["iters"])
    eo_mg_counts = eo_mg_phase(dev, card, note, schur_ms)
    gauge_counts = gauge_phase(dev, card)
    ingest_counts = ingest_phase(dev, card, note)

    # ---- the command line, checkpoints, sharded MG and even-odd, entry --------
    cli_counts = cli_phase(card)
    checkpoint_counts = checkpoint_phase(dev, card)
    mg_dist_counts, shard_errs = mg_dist_phase(canon, mesh, dev, card, mg_iters)
    for kname, what, err, tol in shard_errs:
        note(kname, what, err, tol)
    eo_dist_counts = eo_dist_phase(canon, mesh, dev, card)
    graft_counts = graft_phase(dev, card)
    path_counts = (plain_counts, mg_counts, loop_counts, record_counts, three_counts, mu_counts,
                   *dist_counts, refine_counts, eigen_counts, eo_counts, eo_mg_counts,
                   gauge_counts, ingest_counts, *cli_counts, checkpoint_counts,
                   *mg_dist_counts, *eo_dist_counts, graft_counts)

    rows = []
    for kname, (short, replaces, source) in REPLACES.items():
        ms, pms, bms, by, lms, _ = table[kname]
        launches = sum(c[kname] for c in path_counts)
        check(launches > 0, f"{kname} launched on the main paths")
        # beta_dots has no field output: its error is that of its dots
        err = max_abs_dot[kname] if kname == "beta_dots" else max_abs[kname]
        row = {"name": short, "route": "cuda", "source": f"mgpgcr_tpu_torch/{source}",
               "replaces": replaces, "launches": launches, "max_abs_err": err,
               "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms}
        if kname in HOST_FREE:
            row["graph_ms"] = HOST_FREE[kname]
        if kname in kernel_variants:
            row["variants"] = kernel_variants[kname]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(f"total_seconds {time.perf_counter() - t0:.1f}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
