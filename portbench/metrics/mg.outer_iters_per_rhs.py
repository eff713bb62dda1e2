"""Outer GCR iterations per right-hand side under MG: ``SolveResult.n_iters``."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iters"] for s in run.solves) / len(run.solves)
