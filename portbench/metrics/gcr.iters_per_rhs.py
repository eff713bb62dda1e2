"""GCR iterations per right-hand side over the window (the refinement's
inner iterations summed, in the refine cell): ``SolveResult.n_iters``,
``RefineResult.total_inner_iters``."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iters"] for s in run.solves) / len(run.solves)
