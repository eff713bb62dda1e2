"""Share, in %, of the HBM roofline in one iteration of the V-cycle's
GCR(restart) smoother: the least bytes of an unpreconditioned GCR
iteration (``reference/roofline.py::gcr_iteration_bytes``) at 3.35e12 B/s
over the device seconds per smoother iteration of the kernels only the
smoother runs (K2's unpreconditioned instance ``gcr_step_kernel<..,
false, ..>``, K3 ``ap_update_kernel``, K4 ``basis_flush_kernel`` and the
reductions launched with them; ``portbench/smooth_kernels.py``).
Iterations are reckoned from the work, not from launches: the smoother's
tolerance is 0, so each of its solves runs ``max_iter`` iterations, and
each preconditioner apply runs two solves (one pre- and one post-smooth:
the harness passes neither count, so the ``MGParams`` defaults hold); the
fused outer loop applies the preconditioner once per outer iteration, so
the applies are the traced solves' outer iterations."""

from portbench import smooth_kernels
from portbench.reference import roofline

SWEEPS = 2  # smoother solves per preconditioner apply


def read(run):
    applies = sum(s["iters"] for s in run.traced_solves)
    smoother = run.config.get("mg", {}).get("smoother_gcr")
    if run.trace is None or not applies or not smoother or float(smoother["tol"]) != 0.0:
        return None
    iters = applies * SWEEPS * int(smoother["max_iter"])
    nbytes = roofline.gcr_iteration_bytes(run.dims, int(smoother["restart"]),
                                          int(run.config["link_rows"]), run.config["link_dtype"])
    return roofline.share_percent(nbytes, smooth_kernels.seconds(run.trace) / iters)
