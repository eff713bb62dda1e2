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
unroll="auto") and the fused eager MG loop.

Phases, each printed as one JSON line with its wall seconds:
  device    the card's name and power limit (nvidia-smi);
  build     the one nvcc call that builds csrc/*.cu;
  oracle    the Dslash kernel against the numpy oracle on a 4^4 lattice;
  parity    every kernel against its plain PyTorch version at 32^4;
  timing    CUDA-event times of each kernel, its plain version, its bound,
            and one PyTorch call computing the same function where there is
            one (an einsum or a matrix product for K3, K4, B2, B3, B6, B7,
            B10 and B11, each checked against the plain version);
  solve     the plain path: both solve forms (two runs each, in turns),
            iteration counts, ms per iteration, the independent f64
            residual, launch counts;
  mg_setup  the MG setup's seconds per phase and its property checks;
  mg_solve  the MG path: both solve forms, outer iterations, ms per outer
            iteration, the V-cycle breakdown, the independent f64
            residual, launch counts;
  loop_solve  the loop-form and eager paths: iterations (and where the
            history first reaches the tolerance), ms per iteration, the
            independent f64 residual, launch counts.
Then the kernel table, the card line and the result line. Any failed
check raises, and the script exits non-zero. Run: ``python3 chip_smoke.py``
(``--profile`` adds a torch.profiler breakdown of the fused solves).
"""

from __future__ import annotations

import json
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
}
BIG_LIM = 20  # beta_dots past one chunk of 8 rows, lim past the cycles form's 16
TURN_ROUNDS = 5  # rounds of cycles, loop, loop, cycles in the loop/cycles comparison


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
    timed run, summed."""
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
    return total


def main() -> int:
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mgpgcr_tpu_torch import (
        CudaWilsonDirac, DiracOperator, GCRParams, LatticeMesh, cplx, gcr_solve,
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
    emit("build", t1, library=str(path.relative_to(ROOT)),
         spills=[ln.strip() for ln in ptxas.splitlines() if "spill" in ln and " 0 bytes spill" not in ln])

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
    torch.cuda.synchronize()
    emit("parity", t1, cases=len(worst), field_tol=FIELD_TOL, dot_tol=DOT_TOL,
         worst={k: max(v for kk, v in worst.items() if kk.startswith(k + ":")) for k in max_abs},
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
    pms = cuda_ms(lambda: dslash_plain(main_links, psi, mesh, kt, True), reps=5, warmup=1)
    table["dslash_apply"] = (ms, pms, *bound(d_bytes, d_flops), None, d_bytes)

    def cycle(fn):
        for lim in range(1, S + 1):
            fn(lim)

    ms = cuda_ms(lambda: cycle(lambda lim: gcr_stream_step(
        main_links, r, aps, alpha, kt, lim, mesh, anti_t=True))) / S
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
    torch.cuda.synchronize()
    emit("timing", t1, card=card, dslash_variants_ms=variant_ms, **extra,
         kernels={k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2], "bound_by": v[3],
                      "library_ms": v[4], "bytes": v[5]} for k, v in table.items()},
         variants=kernel_variants)
    del aps, r, psi, variants, mg_inputs, loop_inputs, basis, basis_all

    # ---- solve: the plain path --------------------------------------------
    t1 = time.perf_counter()
    op = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(op, K)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), op.field_shape,
                    torch.float32, dev)
    links64 = links_from_numpy(canon, mesh, dev, link_dtype=torch.float64)
    k64 = torch.tensor(K, dtype=torch.complex128, device=dev)
    b64 = b.astype(torch.float64)

    def independent_relres(x) -> float:
        rr = b64 - dslash_plain(links64, x.astype(torch.float64), mesh, k64, anti_t=True)
        return float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b64)))

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
    loop_counts = loop_path(mg["a"], mg["b"], mg["mgp"], card, independent_relres,
                            {"plain": solves["fused"]["iters"], "mg": mg["outer_iters"]}, profile)

    rows = []
    for kname, (short, replaces, source) in REPLACES.items():
        ms, pms, bms, by, lms, _ = table[kname]
        launches = plain_counts[kname] + mg["counts"][kname] + loop_counts[kname]
        check(launches > 0, f"{kname} launched on the main paths")
        # beta_dots has no field output: its error is that of its dots
        err = max_abs_dot[kname] if kname == "beta_dots" else max_abs[kname]
        row = {"name": short, "route": "cuda", "source": f"mgpgcr_tpu_torch/{source}",
               "replaces": replaces, "launches": launches, "max_abs_err": err,
               "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms}
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
