"""Refinement rounds per right-hand side: ``RefineResult.n_refine``."""


def read(run):
    rounds = [s["rounds"] for s in run.solves if "rounds" in s]
    return sum(rounds) / len(rounds) if rounds else None
