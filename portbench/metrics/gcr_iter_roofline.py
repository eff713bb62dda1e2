"""Share, in %, of the HBM roofline in one GCR(restart) iteration: the
least bytes of the iteration (``reference/roofline.py``) at 3.35e12 B/s
over the device busy time per iteration inside the traced solves. The
work is reckoned from the operation, whatever kernels implement it."""

from portbench.reference import roofline


def read(run):
    iters = sum(s["iters"] for s in run.traced_solves)
    if run.trace is None or not iters:
        return None
    cfg = run.config
    nbytes = roofline.gcr_iteration_bytes(run.dims, int(cfg["gcr"]["restart"]),
                                          int(cfg["link_rows"]), cfg["link_dtype"])
    busy = run.trace.busy_s(within="portbench.solve")
    return roofline.share_percent(nbytes, busy / iters)
