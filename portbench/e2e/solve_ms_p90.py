"""90th percentile (nearest rank) of the host ms from handing b over to
having x synchronised, over every solve of the window; given only where
the window holds at least 100 solves, so that 10 lie beyond it."""

from portbench.timing import percentile


def read(run):
    ms = [s["ms"] for s in run.solves]
    return percentile(ms, 90) if len(ms) >= 100 else None
