"""Seconds of one MG setup inside the window: the sum of the phases that
``setup_mg(timings=)`` fills, averaged over the configurations set up."""


def read(run):
    if not run.setups:
        return None
    return sum(sum(t.values()) for t in run.setups) / len(run.setups)
