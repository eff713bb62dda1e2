#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mgpgcr_tpu_torch``) on one GPU.

Drives the port's main path at the flagship 32^4 size: the 16^4 beta = 6.0
gauge field of ``data/links_16_b6.0_s0.npz`` tiled twice along t, z, y
and x, the Wilson-Dirac operator with two-row f32 links and the in-kernel
anti-periodic t boundary, A = I - 0.125 D, and restart-5 GCR to 1e-6, in
the fused form (the four hand-written kernels) and the generic form.

Phases, each printed as one JSON line with its wall seconds:
  device  the card's name and power limit (nvidia-smi);
  build   the one nvcc call that builds csrc/*.cu;
  oracle  the Dslash kernel against the numpy oracle on a 4^4 lattice;
  parity  every kernel against its plain PyTorch version at 32^4;
  timing  CUDA-event times of each kernel, its plain version, its bound;
  solve   both solve forms, iteration counts, ms per iteration, the
          independent f64 residual and the kernels' launch counts.
Then the kernel table, the card line and the result line. Any failed
check raises, and the script exits non-zero. Run: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
FIELD_TOL = 1e-5  # max |kernel - plain| / max |plain| for fields
DOT_TOL = 1e-4  # relative error of reductions against the f64 plain version
K = 0.125
RESTART = 5
DSLASH_FLOPS_PER_SITE = 1320  # 8 hops: projection, SU(3) x half spinor, reconstruction


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


def profile_solve(a, b, card: str) -> None:
    """torch.profiler over one fused solve: device time by kernel and the
    device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mgpgcr_tpu_torch import GCRParams, gcr_solve

    t1 = time.perf_counter()
    params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        res = gcr_solve(a, b, params)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - s0)
    kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kern.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    emit("profile", t1, card=card, iters=res.n_iters, wall_ms=wall_ms, device_ms=device_ms,
         idle_share=1 - device_ms / wall_ms, launches=sum(e.count for e in kern),
         top=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in kern[:12]])


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

    def rel_err(got, ref) -> tuple[float, float]:
        """(max |got - ref| / max |ref|, max |got - ref|) over a CF or tensor."""
        if cplx.is_cf(got):
            d = max(float((got.re - ref.re).abs().max()), float((got.im - ref.im).abs().max()))
            s = max(float(ref.re.abs().max()), float(ref.im.abs().max()))
        else:
            d = float((got.to(ref.dtype) - ref).abs().max())
            s = float(ref.abs().max())
        return d / s, d

    def f64(x):
        return x.astype(torch.float64) if cplx.is_cf(x) else x.to(torch.complex128)

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
    max_abs = {"dslash": 0.0, "gcr_stream_step": 0.0, "ap_update": 0.0, "basis_flush": 0.0}
    worst = {}

    def note(kname, what, err, tol):
        rel, ab = err
        check(rel <= tol, f"{kname} {what}: {rel} > {tol}")
        if tol == FIELD_TOL:  # field outputs; reductions are held against f64
            max_abs[kname] = max(max_abs[kname], ab)
        worst[f"{kname}:{what}"] = rel

    for (rows, lname), lt in variants.items():
        for kk in (None, kt):
            for anti in (False, True):
                what = f"{lname}/{rows}row/k={kk is not None}/anti_t={anti}"
                got = dslash_apply(lt, psi, mesh, kk, anti)
                note("dslash", what, rel_err(got, dslash_plain(lt, psi, mesh, kk, anti)), FIELD_TOL)

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
    torch.cuda.synchronize()
    emit("parity", t1, cases=len(worst), field_tol=FIELD_TOL, dot_tol=DOT_TOL,
         worst={k: max(v for kk, v in worst.items() if kk.startswith(k + ":")) for k in max_abs},
         max_abs_err=max_abs)

    # ---- timing ------------------------------------------------------------
    t1 = time.perf_counter()

    def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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

    n_sites = mesh.n_sites
    field_b = 96  # bytes per site of one f32 field
    rows_b = {(3, "f32"): 288, (2, "f32"): 192, (3, "bf16"): 144, (2, "bf16"): 96}

    def bound(nbytes: float, flops: float) -> tuple[float, str]:
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")

    variant_ms = {}
    for (rows, lname), lt in variants.items():
        variant_ms[f"{lname}/{rows}row"] = cuda_ms(lambda: dslash_apply(lt, psi, mesh, kt, True))
    recon_flops = 8 * 3 * 14  # row 2 of each of the 8 links: 6 complex mul + 3 sub
    k_flops = 12 * 8  # psi - k D psi
    d_bytes = n_sites * (rows_b[(2, "f32")] + 2 * field_b)
    d_flops = n_sites * (DSLASH_FLOPS_PER_SITE + recon_flops + k_flops)
    table = {}
    ms = cuda_ms(lambda: dslash_apply(main_links, psi, mesh, kt, True))
    pms = cuda_ms(lambda: dslash_plain(main_links, psi, mesh, kt, True), reps=5, warmup=1)
    table["dslash"] = (ms, pms, *bound(d_bytes, d_flops), None, d_bytes)

    def cycle(fn):
        for lim in range(1, S + 1):
            fn(lim)

    ms = cuda_ms(lambda: cycle(lambda lim: gcr_stream_step(
        main_links, r, aps, alpha, kt, lim, mesh, anti_t=True))) / S
    pms = cuda_ms(lambda: cycle(lambda lim: gcr_stream_step_plain(
        main_links, r, aps, alpha, kt, lim, mesh, anti_t=True)), reps=3, warmup=1) / S
    # per call, averaged over one cycle's lim = 1..S
    g_bytes = sum(n_sites * (rows_b[(2, "f32")] + (1 + lim) * field_b + 2 * field_b)
                  for lim in range(1, S + 1)) / S
    g_flops = sum(n_sites * (DSLASH_FLOPS_PER_SITE + recon_flops + k_flops + 96
                             + (2 * lim + 1) * 96 + 48) for lim in range(1, S + 1)) / S
    table["gcr_stream_step"] = (ms, pms, *bound(g_bytes, g_flops), None, g_bytes)

    scratch = aps.clone()
    ms = cuda_ms(lambda: cycle(lambda lim: ap_update(r, scratch, betas, lim % S, lim))) / S
    pms = cuda_ms(lambda: cycle(lambda lim: ap_update_plain(r, scratch, betas, lim % S, lim)),
                  reps=5, warmup=1) / S
    a_bytes = sum(n_sites * ((lim + 1) * field_b + field_b) for lim in range(1, S + 1)) / S
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
    del stacked
    f_bytes = n_sites * ((1 + nb) * field_b + 2 * field_b)
    f_flops = n_sites * 12 * 16 * nb
    table["basis_flush"] = (ms, pms, *bound(f_bytes, f_flops), lms, f_bytes)
    torch.cuda.synchronize()
    emit("timing", t1, card=card, dslash_variants_ms=variant_ms,
         kernels={k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2], "bound_by": v[3],
                      "library_ms": v[4], "bytes": v[5]} for k, v in table.items()})
    del aps, r, psi, variants

    # ---- solve: the main path ---------------------------------------------
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

    solves = {}
    for form, fused in (("fused", True), ("generic", False)):
        params = GCRParams(tol=1e-6, max_iter=500, restart=RESTART, fused=fused)
        gcr_solve(a, b, params)  # warm-up: first-call costs stay out of the time
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
        solves[form] = {"iters": res.n_iters, "relres": res.final_relres,
                        "independent_relres_f64": rel, "seconds": wall,
                        "ms_per_iter": 1e3 * wall / max(res.n_iters, 1), "launches": counts}
    check(abs(solves["fused"]["iters"] - solves["generic"]["iters"]) <= 2,
          "fused and generic iteration counts within 2")
    main_counts = solves["fused"]["launches"]
    check(all(v > 0 for v in main_counts.values()), f"every kernel launched {main_counts}")
    # device time of the four kernels per fused iteration, from the timing
    # phase: one K2 and one K3 per iteration, one K4 per cycle
    kernel_ms = table["gcr_stream_step"][0] + table["ap_update"][0] + table["basis_flush"][0] / S
    emit("solve", t1, card=card, k=K, tol=1e-6, restart=RESTART,
         fused_kernel_ms_per_iter=kernel_ms, **solves)
    if "--profile" in sys.argv[1:]:
        profile_solve(a, b, card)

    replaces = {
        "dslash": "mgpgcr_tpu/ops/pallas/dslash.py:268",
        "gcr_stream_step": "mgpgcr_tpu/ops/pallas/gcr_dslash.py:57",
        "ap_update": "mgpgcr_tpu/ops/pallas/gcr_kernels.py:342",
        "basis_flush": "mgpgcr_tpu/ops/pallas/gcr_kernels.py:441",
    }
    sources = {
        "dslash": "mgpgcr_tpu_torch/csrc/dslash.cu",
        "gcr_stream_step": "mgpgcr_tpu_torch/csrc/gcr_dslash.cu",
        "ap_update": "mgpgcr_tpu_torch/csrc/gcr_kernels.cu",
        "basis_flush": "mgpgcr_tpu_torch/csrc/gcr_kernels.cu",
    }
    rows = []
    for kname in ("dslash", "gcr_stream_step", "ap_update", "basis_flush"):
        ms, pms, bms, by, lms, _ = table[kname]
        rows.append({"name": kname, "route": "cuda", "source": sources[kname],
                     "replaces": replaces[kname],
                     "launches": main_counts["dslash_apply" if kname == "dslash" else kname],
                     "max_abs_err": max_abs[kname], "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lms})
    print(json.dumps({"kernels": rows}))
    print(f"total_seconds {time.perf_counter() - t0:.1f}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
