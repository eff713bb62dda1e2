"""Right-hand sides solved to the cell's tolerance per second of the
window, all its work and all its time counted."""


def read(run):
    return run.solved / run.window_s if run.window_s > 0 else None
