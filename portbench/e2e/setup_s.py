"""Seconds from the start of the run to its first timed solve: imports,
the kernel library's load (and build, in a checkout's first run), the
gauge field, the operator, MG setup, the warm-up solve, the pool."""


def read(run):
    return run.setup_s
