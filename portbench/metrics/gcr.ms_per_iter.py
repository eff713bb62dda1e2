"""Window seconds over all the window's GCR iterations, in ms."""


def read(run):
    iters = sum(s["iters"] for s in run.solves)
    return 1e3 * run.window_s / iters if iters else None
