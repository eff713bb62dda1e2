"""Mean ms of one preconditioner apply (``MGPreconditioner.apply``), from
the benchmark's synchronised span around each call in the window."""


def read(run):
    return 1e3 * sum(run.vcycle_s) / len(run.vcycle_s) if run.vcycle_s else None
