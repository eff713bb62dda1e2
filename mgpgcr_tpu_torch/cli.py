"""Command-line driver of the port.

Counterpart of ``mgpgcr_tpu/cli.py`` (the reference is driven by editing
``main()`` and recompiling, main.cpp:29-57), with the same subcommands and
options:

  solve     one system: ingested matrix or synthetic lattice, optional MG
  ksweep    iterations-to-tolerance vs hopping parameter k (the reference's
            ``k_critical_mg_precond`` / ``test_kcritical``, main.cpp:696-741,
            834-875)
  parse     MatrixMarket .mtx -> the reference's CSR cache ("parsed.txt",
            Parse.cpp:10-62)
  generate  synthesise a Wilson-Dirac hopping-matrix fixture
  info      PyTorch / CUDA device report

Run as ``python -m mgpgcr_tpu_torch <cmd> ...``, or with a JSON/TOML config
through ``--config``. ``--platform`` picks the device: ``cuda`` (the
default; raises when there is no card) or ``cpu``. On the card the cf32
lattice operators run the hand-written kernels (the Dslash, the fused GCR
steps, the MG transfers and the block-stencil coarse operator); cf64 and
complex128/complex64 run the plain PyTorch operators in f64/complex
arithmetic, as the JAX driver runs XLA operators off the TPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _device(platform: str | None) -> torch.device:
    """The run's device: CUDA unless ``platform`` names the CPU."""
    from mgpgcr_tpu_torch import cplx

    return cplx.resolve_device(platform or "cuda")


def _infer_mesh(n: int):
    """N = 12 T^4 for the Wilson fixtures (4 spinor x 3 colour)."""
    from mgpgcr_tpu_torch.mesh import LatticeMesh

    sites = n // 12
    t = round(sites ** 0.25)
    if 12 * t**4 == n:
        return LatticeMesh((t, t, t, t, 4, 3))
    return None


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_problem(pc, device):
    """ProblemConfig -> (operator A = I - kD, mesh, rhs, to_host, layout) on
    ``device``.

    ``layout`` names the field representation the returned operator and
    rhs use ("tpu": slab CF fields (4, 3, T, Z, Y*X); "flat": flat CF
    fields (N,), complex dtypes split into their real parts), which MG
    setup must match. A cf32 lattice on the card runs the Dslash
    kernel (``CudaWilsonDirac``, two-row links unless ``compress`` is off,
    the anti-periodic sign in the kernel); any other cf lattice the plain
    ``SlabWilsonDirac``."""
    from mgpgcr_tpu_torch import cplx, fields
    from mgpgcr_tpu_torch.mesh import LatticeMesh
    from mgpgcr_tpu_torch.ops.dirac import DiracOperator

    dev = torch.device(device)
    cf = pc.dtype.startswith("cf")
    rdt = {"cf32": torch.float32, "cf64": torch.float64}.get(pc.dtype)
    cdt = {"complex128": torch.complex128, "complex64": torch.complex64}.get(pc.dtype)
    on_card = dev.type == "cuda" and pc.dtype == "cf32"  # the kernels take f32

    if pc.matrix:
        from mgpgcr_tpu_torch.io import load_ell_npz, read_matrix_market, read_parsed_txt

        csr = None
        if pc.matrix.endswith(".mtx"):
            csr = read_matrix_market(pc.matrix).to_csr()
        elif not pc.matrix.endswith(".npz"):
            csr = read_parsed_txt(pc.matrix)
        n = csr.shape[0] if csr is not None else None
        if csr is None:
            d = load_ell_npz(pc.matrix, device=dev)
            n = d.shape[0]
        mesh = _infer_mesh(n)
        if cf and csr is not None and getattr(pc, "detect", True):
            dims = tuple(pc.lattice) or (mesh.spacetime_dims if mesh is not None else None)
            if dims is not None:
                from mgpgcr_tpu_torch.ops.ingest import wilson_operator_from_csr

                # parsed fixtures carry ~6 significant digits
                a = wilson_operator_from_csr(csr, dims, pc.k, dtype=rdt,
                                             backend="cuda" if on_card else "slab",
                                             tol=1e-5, device=dev)
                if a is not None:
                    mesh = LatticeMesh((*dims, 4, 3))
                    inner = a.a if hasattr(a, "a") else a
                    rhs = cplx.random(_generator(pc.seed, dev), inner.d.field_shape, rdt, dev)
                    return a, mesh, rhs, cplx.to_numpy, "tpu"
        if cf:
            d = (csr.to_ell(dtype=rdt, cf=True, device=dev) if csr is not None
                 else type(d)(cplx.ascf(d.vals).astype(rdt), d.cols, d.n_cols))
            a = DiracOperator(d, pc.k)
            rhs = cplx.random(_generator(pc.seed, dev), (d.shape[0],), rdt, dev)
            return a, mesh, rhs, cplx.to_numpy, "flat"
        d = (csr.to_ell(dtype=cdt, device=dev) if csr is not None
             else type(d)(d.vals.to(cdt), d.cols, d.n_cols))
        a = DiracOperator(d, pc.k)
        rhs = fields.random_field(_generator(pc.seed, dev), d.shape[0], cdt, dev)
        return a, mesh, cplx.ascf(rhs).contiguous(), cplx.to_numpy, "flat"

    dims = tuple(pc.lattice) or (8, 8, 8, 8)
    mesh = LatticeMesh((*dims, 4, 3))
    if cf:
        from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t, random_links_np

        links = random_links_np(pc.seed, mesh)
        if on_card:
            # the card's default: two-row SU(3) links at f32 arithmetic
            # (exact row-2 reconstruction), the anti-periodic sign applied
            # in the kernel so the links stay SU(3); --no-compress opts out
            from mgpgcr_tpu_torch.ops.dslash import CudaWilsonDirac

            d = CudaWilsonDirac.build(links, mesh, compress=getattr(pc, "compress", True),
                                      antiperiodic_t=getattr(pc, "antiperiodic", False),
                                      device=dev)
        else:
            from mgpgcr_tpu_torch.ops.wilson_slab import SlabWilsonDirac

            if getattr(pc, "antiperiodic", False):
                links = antiperiodic_t(links)
            d = SlabWilsonDirac.build(cplx.from_numpy(links, rdt, dev), mesh)
        a = DiracOperator(d, pc.k)
        rhs = cplx.random(_generator(pc.seed + 1, dev), d.field_shape, rdt, dev)
        return a, mesh, rhs, cplx.to_numpy, "tpu"
    from mgpgcr_tpu_torch.ops.wilson import WilsonDiracOperator, antiperiodic_t, random_links

    links = random_links(_generator(pc.seed, dev), mesh, dtype=cdt)
    if getattr(pc, "antiperiodic", False):
        links = antiperiodic_t(links)
    d = WilsonDiracOperator(links, mesh)
    a = DiracOperator(d, pc.k)
    rhs = fields.random_field(_generator(pc.seed + 1, dev), mesh, cdt, dev)
    return a, mesh, cplx.ascf(rhs).contiguous(), cplx.to_numpy, "flat"


def _solve_once(cfg, device, logger):
    import time as _time

    from mgpgcr_tpu_torch import cplx
    from mgpgcr_tpu_torch.solvers.gcr import gcr_solve, gcr_solve_eager
    from mgpgcr_tpu_torch.solvers.mg import setup_mg
    from mgpgcr_tpu_torch.utils.logging import Timer
    from mgpgcr_tpu_torch.utils.profiling import (
        annotate,
        dslash_roofline,
        gcr_iteration_roofline,
    )

    a, mesh, rhs, to_host, layout = build_problem(cfg.problem, device)

    # even-odd (Schur) route: the half-dimension even-site system and the
    # exact odd-site back-substitution (solvers/eo.py)
    eo_op = eo_spin = None
    if getattr(cfg, "eo", False):
        # a Wilson-detected ingested matrix may come wrapped in a spin
        # conjugation A_ing = S A S^-1 (ops/ingest.py SpinConjugatedOperator):
        # Schur-solve the inner A on the rotated rhs and rotate x back
        inner_a = a
        if hasattr(a, "s") and hasattr(a, "a") and not hasattr(a, "d"):
            eo_spin = a.s
            inner_a = a.a
        if layout != "tpu" or not hasattr(inner_a, "d"):
            raise SystemExit(
                "--eo requires a lattice cf problem (synthetic or "
                "Wilson-detected ingested matrix)"
            )
        from mgpgcr_tpu_torch.ops.eo import EvenOddWilson

        try:
            # honours d.anti_t (the in-kernel anti-periodic sign is folded
            # into U_t(T-1) for the split) and refuses two-row links
            eo_op = EvenOddWilson.from_dirac(inner_a.d)
        except ValueError as e:
            raise SystemExit(f"--eo: {e}")

    precond = None
    setup_s = 0.0
    if cfg.mg is not None:
        if mesh is None:
            raise SystemExit("MG requires a lattice mesh (synthetic or inferable)")
        # the layout follows the operator (build_problem): lattice
        # operators take slab fields, the generic ingested formats flat ones
        gen = _generator(cfg.problem.seed + 7, device)

        def _do_mg_setup():
            if eo_op is not None:
                from mgpgcr_tpu_torch.solvers.eo import setup_eo_mg

                _, m = setup_eo_mg(gen, eo_op, cfg.problem.k, cfg.mg)
            else:
                m = setup_mg(gen, a, mesh, cfg.mg, layout=layout)
            Timer.block_on(m.q_field if m.q_field is not None else m.q)
            return m

        with annotate("mg_setup"), Timer(logger, "mg_setup") as t:
            mgp = _do_mg_setup()
        precond = mgp.apply
        setup_s = t.elapsed
    solve_fn = gcr_solve_eager if getattr(cfg, "eager", False) else gcr_solve
    with annotate("solve"), Timer(logger, "solve") as t:
        if eo_op is not None:
            import dataclasses as _dc

            from mgpgcr_tpu_torch.ops.ingest import SpinConjugatedOperator
            from mgpgcr_tpu_torch.solvers.eo import eo_solve

            rhs_eo = rhs
            if eo_spin is not None:
                rhs_eo = SpinConjugatedOperator._spin(eo_spin.T, rhs)  # S^-1 = S^T
            res = eo_solve(eo_op, cfg.problem.k, rhs_eo, cfg.gcr, precond=precond, mesh=mesh)
            if eo_spin is not None:
                res = _dc.replace(res, x=SpinConjugatedOperator._spin(eo_spin, res.x))
        else:
            res = solve_fn(a, rhs, cfg.gcr, precond=precond)
        Timer.block_on(res.x)
    out = {
        "converged": bool(res.converged),
        "iters": int(res.n_iters),
        "relres": float(res.final_relres),
        "solve_s": round(t.elapsed, 4),
        "mg_setup_s": round(setup_s, 4),
    }
    if eo_op is not None:
        out["eo"] = True  # iters/relres are the Schur solve's
    if cfg.problem.matrix and layout == "tpu":
        # Wilson structure was detected and the solve ran on the Dslash
        # operator instead of the ingested format
        out["detected_wilson"] = True
    # independent residual check (never trust the solver's bookkeeping)
    with annotate("refine_check"):
        r = rhs - a.apply(res.x)
        out["indep_relres"] = float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(rhs)))

    # roofline counters: one measured bare operator application (warm,
    # synchronised) and the per-iteration estimate, against the device's
    # memory rate (utils/profiling.py)
    if mesh is not None and (not cfg.problem.matrix or layout == "tpu"):
        Timer.block_on(rhs)
        t0 = _time.perf_counter()
        y = Timer.block_on(a.apply(rhs))
        dt = _time.perf_counter() - t0
        del y
        rdt = np.dtype(str(rhs.dtype).replace("torch.", ""))
        links = getattr(getattr(getattr(a, "a", a), "d", None), "links", None)
        if links is None:
            link_b = rdt.itemsize
        else:
            # itemsize per REAL component (complex dtypes store two)
            link_b = links.dtype.itemsize // (2 if links.dtype.is_complex else 1)
        rl = dslash_roofline(mesh, dt, field_itemsize=rdt.itemsize, link_itemsize=link_b,
                             device=device)
        logger.log("roofline", **rl.asdict())
        if out["iters"] > 0:
            per_it = t.elapsed / out["iters"] - dt
            # skipped when non-positive (tiny launch-bound problems: a warm
            # solve iteration can beat one cold apply); the dslash event
            # above is always archived
            if per_it > 0:
                rl_it = gcr_iteration_roofline(mesh, per_it, cfg.gcr.restart or cfg.gcr.storage_size,
                                               field_itemsize=rdt.itemsize, device=device)
                logger.log("roofline", **rl_it.asdict())
    return out, res


def cmd_solve(args) -> int:
    cfg = _config_from_args(args)
    device = _device(args.platform)
    from mgpgcr_tpu_torch.utils.logging import RunLogger
    from mgpgcr_tpu_torch.utils.trace import save_residual_trace

    with RunLogger(stream=sys.stderr if args.verbose else None, path=cfg.log) as lg:
        lg.log("config", **json.loads(json.dumps(_cfg_dict(cfg))))
        out, res = _solve_once(cfg, device, lg)
        if cfg.trace:
            save_residual_trace(cfg.trace, res.res_history, meta={"k": cfg.problem.k})
        lg.log("result", **out)
    print(json.dumps(out))
    return 0 if out["converged"] else 1


def cmd_ksweep(args) -> int:
    import dataclasses

    cfg = _config_from_args(args)
    device = _device(args.platform)
    from mgpgcr_tpu_torch.utils.logging import RunLogger

    ks = [
        args.kmin + i * (args.kmax - args.kmin) / max(args.n - 1, 1)
        for i in range(args.n)
    ]
    rows = []
    with RunLogger(stream=sys.stderr if args.verbose else None, path=cfg.log) as lg:
        for k in ks:
            c = dataclasses.replace(cfg, problem=dataclasses.replace(cfg.problem, k=float(k)))
            out, _ = _solve_once(c, device, lg)
            row = {"k": round(float(k), 6), **out}
            lg.log("ksweep_point", **row)
            rows.append(row)
            print(json.dumps(row), flush=True)
    ok = all(r["converged"] for r in rows)
    return 0 if ok else 1


def cmd_parse(args) -> int:
    from mgpgcr_tpu_torch.io import read_matrix_market, write_parsed_txt

    m = read_matrix_market(args.mtx).to_csr()
    write_parsed_txt(args.out, m)
    print(json.dumps({"rows": m.shape[0], "cols": m.shape[1], "nnz": int(m.nnz),
                      "out": args.out}))
    return 0


def cmd_generate(args) -> int:
    """Synthesise a Wilson-Dirac hopping matrix fixture: Haar-random SU(3)
    links (the JAX package's numbers for the same seed) -> explicit CSR
    with the fixture's sparsity structure, written in the reference's
    parsed.txt cache format or as an ELL .npz. Built on the host, whatever
    ``--platform`` names."""
    from mgpgcr_tpu_torch.mesh import LatticeMesh
    from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t, materialize_csr, random_links_np

    dims = tuple(args.lattice)
    mesh = LatticeMesh((*dims, 4, 3))
    links = random_links_np(args.seed or 0, mesh)
    if args.antiperiodic:
        links = antiperiodic_t(links)
    m = materialize_csr(links, mesh)
    if args.out.endswith(".npz"):
        from mgpgcr_tpu_torch.io.npz_cache import save_ell_npz

        save_ell_npz(args.out, m.to_ell(device="cpu"))
    else:
        from mgpgcr_tpu_torch.io import write_parsed_txt

        write_parsed_txt(args.out, m)
    print(json.dumps({"lattice": list(dims), "rows": m.shape[0], "nnz": int(m.nnz),
                      "antiperiodic": bool(args.antiperiodic), "out": args.out}))
    return 0


def cmd_info(args) -> int:
    device = _device(args.platform)
    from mgpgcr_tpu_torch.io import native_parse

    cuda = device.type == "cuda"
    print(json.dumps({
        "backend": device.type,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else ["cpu"],
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "native_io": native_parse.available(),
    }))
    return 0


def _cfg_dict(cfg):
    from mgpgcr_tpu_torch.config import config_to_dict

    return config_to_dict(cfg)


def _config_from_args(args):
    import dataclasses

    from mgpgcr_tpu_torch.config import RunConfig, load_config
    from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams

    cfg = load_config(args.config) if getattr(args, "config", None) else RunConfig()
    pc = cfg.problem
    if getattr(args, "matrix", None):
        pc = dataclasses.replace(pc, matrix=args.matrix)
    if getattr(args, "lattice", None):
        pc = dataclasses.replace(pc, lattice=tuple(args.lattice))
    if getattr(args, "k", None) is not None:
        pc = dataclasses.replace(pc, k=args.k)
    if getattr(args, "dtype", None):
        pc = dataclasses.replace(pc, dtype=args.dtype)
    if getattr(args, "seed", None) is not None:
        pc = dataclasses.replace(pc, seed=args.seed)
    if getattr(args, "antiperiodic", False):
        pc = dataclasses.replace(pc, antiperiodic=True)
    if getattr(args, "no_detect", False):
        pc = dataclasses.replace(pc, detect=False)
    # --eo on argv or eo: true in the config file; both need 3-row links
    # (EvenOddWilson has no two-row path)
    eo = bool(getattr(args, "eo", False)) or bool(getattr(cfg, "eo", False))
    if getattr(args, "no_compress", False) or eo:
        pc = dataclasses.replace(pc, compress=False)
    gcr = cfg.gcr
    if getattr(args, "tol", None) is not None:
        gcr = dataclasses.replace(gcr, tol=args.tol)
    if getattr(args, "max_iter", None) is not None:
        gcr = dataclasses.replace(gcr, max_iter=args.max_iter)
    if getattr(args, "restart", None) is not None:
        gcr = dataclasses.replace(gcr, restart=args.restart, truncation=0)
    if getattr(args, "fused", False):
        gcr = dataclasses.replace(gcr, fused=True)
    if getattr(args, "residual_refresh", None) is not None:
        gcr = dataclasses.replace(gcr, residual_refresh=args.residual_refresh)
    mg = cfg.mg
    if getattr(args, "mg", False) and mg is None:
        mg = MGParams()
    if mg is not None:
        if getattr(args, "block", None):
            mg = dataclasses.replace(mg, block=args.block)
        if getattr(args, "nullvecs", None):
            mg = dataclasses.replace(mg, n_nullvecs=args.nullvecs)
        if getattr(args, "n_level", None):
            mg = dataclasses.replace(mg, n_level=args.n_level)
        if getattr(args, "coarse_block", None):
            mg = dataclasses.replace(mg, coarse_block=args.coarse_block)
        if getattr(args, "coarse_format", None):
            mg = dataclasses.replace(mg, coarse_format=args.coarse_format)
        if getattr(args, "assembly", None):
            mg = dataclasses.replace(mg, assembly=args.assembly)
        if getattr(args, "damping", None) is not None:
            mg = dataclasses.replace(mg, correction_damping=args.damping)
        # coarse-solve GCR (the reference's config of record: 50 iterations,
        # tol 1e-2, restart 10, main.cpp:851-856)
        cg = mg.coarse_gcr
        if getattr(args, "coarse_tol", None) is not None:
            cg = dataclasses.replace(cg, tol=args.coarse_tol)
        if getattr(args, "coarse_max_iter", None) is not None:
            cg = dataclasses.replace(cg, max_iter=args.coarse_max_iter)
        if getattr(args, "coarse_restart", None) is not None:
            cg = dataclasses.replace(cg, restart=args.coarse_restart, truncation=0)
        mg = dataclasses.replace(mg, coarse_gcr=cg)
        # smoother: --no-smoother is the reference's smoother-off config
        # (additive coarse deflation); --smoother-iters N sizes the GCR
        # smoother; --smoother-alg neumann the truncated hopping expansion
        if getattr(args, "no_smoother", False):
            mg = dataclasses.replace(mg, smoother_gcr=None)
        elif getattr(args, "smoother_iters", None):
            mg = dataclasses.replace(
                mg,
                smoother_gcr=GCRParams(tol=0.0, max_iter=args.smoother_iters,
                                       truncation=min(args.smoother_iters, 4)),
            )
        if getattr(args, "smoother_alg", None):
            mg = dataclasses.replace(mg, smoother=args.smoother_alg)
        if getattr(args, "smoother_terms", None):
            mg = dataclasses.replace(mg, smoother_terms=args.smoother_terms)
    return dataclasses.replace(
        cfg,
        problem=pc,
        gcr=gcr,
        mg=mg,
        eager=bool(getattr(args, "eager", False)) or cfg.eager,
        eo=eo,
        trace=getattr(args, "trace", None) or cfg.trace,
        log=getattr(args, "log", None) or cfg.log,
    )


_PLATFORM_HELP = "device: cuda (the default) or cpu"


def _add_common(p):
    p.add_argument("--config", help="JSON/TOML run config file")
    p.add_argument("--platform", choices=["cuda", "cpu"], help=_PLATFORM_HELP)
    p.add_argument("--matrix", help="parsed.txt / .mtx / .npz operator")
    p.add_argument("--lattice", type=int, nargs=4, metavar=("T", "Z", "Y", "X"))
    p.add_argument("--k", type=float, help="hopping parameter (A = I - kD)")
    p.add_argument(
        "--dtype",
        choices=["complex128", "complex64", "cf32", "cf64"],
        help="cf* = split re/im slab fields; on the card cf32 runs the "
        "hand-written kernels, cf64 and complex* the plain f64/complex "
        "PyTorch operators",
    )
    p.add_argument("--seed", type=int)
    p.add_argument("--tol", type=float)
    p.add_argument("--max-iter", dest="max_iter", type=int)
    p.add_argument("--restart", type=int)
    p.add_argument("--fused", action="store_true",
                   help="fused GCR: the iteration through the hand-written kernels")
    p.add_argument(
        "--residual-refresh",
        dest="residual_refresh",
        type=int,
        help="recompute true residual every N iterations (f32 deep solves)",
    )
    p.add_argument(
        "--no-detect",
        dest="no_detect",
        action="store_true",
        help="skip Wilson-structure detection for ingested matrices "
        "(keep the generic ELL compute format)",
    )
    p.add_argument(
        "--no-compress",
        dest="no_compress",
        action="store_true",
        help="disable the default two-row SU(3) link storage of the card's Dslash",
    )
    p.add_argument(
        "--eo",
        action="store_true",
        help="even-odd (Schur) reduction: half-dimension even-site solve "
        "+ exact odd back-substitution; with --mg the hierarchy is built "
        "over the Schur operator",
    )
    p.add_argument("--mg", action="store_true", help="enable MG preconditioner")
    p.add_argument(
        "--antiperiodic",
        action="store_true",
        help="anti-periodic temporal BC for synthetic lattice problems",
    )
    p.add_argument(
        "--eager",
        action="store_true",
        help="host-driven outer GCR loop (gcr_solve_eager)",
    )
    p.add_argument("--block", type=int, help="MG spacetime block extent")
    p.add_argument("--nullvecs", type=int, help="MG near-null vectors (pre-doubling)")
    p.add_argument("--n-level", dest="n_level", type=int, help="MG levels (2 = two-level)")
    p.add_argument(
        "--coarse-block", dest="coarse_block", type=int,
        help="block extent at levels >= 2",
    )
    p.add_argument(
        "--coarse-format", dest="coarse_format",
        choices=["dense", "bsr", "stencil"],
        help="coarse operator storage (stencil: the block-stencil kernel on the card)",
    )
    p.add_argument(
        "--assembly", choices=["phased", "columns"],
        help="Galerkin assembly strategy",
    )
    p.add_argument(
        "--coarse-tol", dest="coarse_tol", type=float, help="coarse GCR tol"
    )
    p.add_argument(
        "--coarse-max-iter", dest="coarse_max_iter", type=int,
        help="coarse GCR max iterations",
    )
    p.add_argument(
        "--coarse-restart", dest="coarse_restart", type=int,
        help="coarse GCR restart",
    )
    p.add_argument(
        "--no-smoother", dest="no_smoother", action="store_true",
        help="smoother off (the reference's config of record, main.cpp:840-858)",
    )
    p.add_argument(
        "--smoother-iters", dest="smoother_iters", type=int,
        help="GCR smoother iterations per pre/post pass",
    )
    p.add_argument(
        "--smoother-alg", dest="smoother_alg", choices=["gcr", "neumann"],
        help="neumann: truncated hopping expansion x += sum (kD)^i r, "
        "dot-free, one operator pass per term",
    )
    p.add_argument(
        "--smoother-terms", dest="smoother_terms", type=int,
        help="Neumann series length (default 4)",
    )
    p.add_argument(
        "--damping", type=float,
        help="coarse-correction damping (reference hardcodes 0.1, MG.h:426)",
    )
    p.add_argument("--trace", help="residual trace output (.npz or .txt)")
    p.add_argument("--log", help="JSON-lines run log path")
    p.add_argument("-v", "--verbose", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mgpgcr_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="solve one system")
    _add_common(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("ksweep", help="iterations vs hopping parameter k")
    _add_common(p)
    p.add_argument("--kmin", type=float, default=0.05)
    p.add_argument("--kmax", type=float, default=0.20611)
    p.add_argument("--n", type=int, default=8)
    p.set_defaults(fn=cmd_ksweep)

    p = sub.add_parser("parse", help=".mtx -> parsed.txt CSR cache")
    p.add_argument("mtx")
    p.add_argument("out")
    p.set_defaults(fn=cmd_parse)

    p = sub.add_parser(
        "generate", help="synthesise a Wilson-Dirac fixture (parsed.txt/.npz)"
    )
    p.add_argument("out")
    p.add_argument("--lattice", type=int, nargs=4, default=[8, 8, 8, 8])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--antiperiodic",
        action="store_true",
        help="anti-periodic temporal boundary (QCD fermion convention)",
    )
    p.add_argument("--platform", choices=["cuda", "cpu"], help=_PLATFORM_HELP)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("info", help="PyTorch / CUDA device report")
    p.add_argument("--platform", choices=["cuda", "cpu"], help=_PLATFORM_HELP)
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
