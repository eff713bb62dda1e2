"""Share, in %, of the HBM roofline in one block-stencil coarse apply
(B12, ``csrc/spmv.cu``): its least bytes at 3.35e12 B/s over the mean
device time per apply in the traced segment. Applies are counted by the
program's ``launch_counts()["stencil_spmv"]``."""

import math

from portbench.reference import roofline


def read(run):
    n = run.traced_launches.get("stencil_spmv", 0)
    if run.trace is None or not n:
        return None
    seconds = run.trace.op_seconds("stencil_spmv")
    mg = run.config["mg"]
    n_blocks = math.prod(d // int(mg["block"]) for d in run.dims)
    ne, slots = 2 * int(mg["n_nullvecs"]), 2 * len(run.dims) + 1
    nbytes = roofline.stencil_apply_bytes(n_blocks, ne, slots)
    return roofline.share_percent(nbytes, seconds / n)
