"""Settings for every test run of the repository.

Every test's call runs under one time limit, TEST_TIME_LIMIT_S: past it the
test fails with its traceback, so a test that hangs names itself instead of
holding its worker until the whole run is cut.

Under ``-n N --dist loadfile`` the JAX package's two faked-mesh batteries,
tests/test_mg_dist.py and tests/test_parallel.py, go out to the workers in
the groups of COST_GROUPS instead of whole: one worker running either file
alone takes longer than the rest of the suite on all the others.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import time

import pytest

# ~2x the longest test (279-289 s in whole runs with 6 workers on 8 cores)
TEST_TIME_LIMIT_S = 600

# file -> test function -> its group. Summed test time of each group in a
# whole run with --durations=0, 6 workers on 8 cores, in the comments; a
# group is handed out whole, in collection order, and xdist hands out the
# groups with the most tests first.
COST_GROUPS = {
    "tests/test_mg_dist.py": {
        "test_sharded_setup_matches_single_device": "setup",  # 514 s
        "test_distributed_mg_gcr_sharded_stencil_coarse": "setup",
        "test_sharded_setup_rejects_straddling_blocks": "checkpoint",  # 514 s
        "test_sharded_checkpoint_roundtrip": "checkpoint",
        "test_distributed_mg_gcr_solve": "solve",  # 198 s
        "test_three_level_sharded_stencil_coarse": "three_level",  # 243 s
        "test_sharded_precond_apply_matches_single_device": "apply",  # 224 s
        "test_shard_local_coarse_stencil_interior_planes": "apply",
        "test_distributed_mg_gcr_bsr_coarse": "bsr_coarse",  # 141 s
    },
    # the solvers, 376 s; the file's other 10 tests stay together, 103 s
    "tests/test_parallel.py": dict.fromkeys(
        (
            "test_distributed_gcr_matches_single_device",
            "test_distributed_mg_gcr_tpu_layout",
            "test_distributed_fused_gcr_matches_single_device",
            "test_distributed_mega_step_gcr_matches_single_device",
            "test_distributed_mega_step_antiperiodic_compressed",
        ),
        "solvers",
    ),
}

_STDERR_FD = pytest.StashKey[int]()


class TimeLimitExceeded(BaseException):
    """Raised in the main thread when a body outlives its time limit. A
    BaseException, so that no ``except Exception`` on the way swallows it."""


@contextlib.contextmanager
def time_limit(seconds):
    """Raise TimeLimitExceeded in the body once it has run ``seconds``,
    through SIGALRM (so from the main thread only). The SIGALRM handler
    and the real-time timer in place before are restored on exit, the
    timer less the time spent here, so that limits nest."""

    def expire(signum, frame):
        raise TimeLimitExceeded(
            f"ran longer than its time limit of {seconds} s"
        )

    start = time.monotonic()
    old_handler = signal.signal(signal.SIGALRM, expire)
    old_delay, old_interval = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        left = max(old_delay - (time.monotonic() - start), 1e-3)
        signal.setitimer(
            signal.ITIMER_REAL, left if old_delay else 0, old_interval
        )
        signal.signal(signal.SIGALRM, old_handler)


def pytest_configure(config):
    # output capture redirects fd 2 while a test runs; the backstop's
    # dump goes to this copy of the terminal's stderr instead
    config.stash[_STDERR_FD] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    # backstop for a test stuck in native code, where no Python signal
    # handler runs: dump every thread's stack and end the process
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT_S + 60, exit=True, file=item.config.stash[_STDERR_FD]
    )
    try:
        with time_limit(TEST_TIME_LIMIT_S):
            yield
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CostGroupScheduling(LoadFileScheduling):
        """loadfile, with the files of COST_GROUPS cut into their groups,
        and a test that ended its worker reported once, not run again."""

        def _split_scope(self, nodeid):
            path, _, name = nodeid.partition("::")
            group = COST_GROUPS.get(path, {}).get(name.split("[")[0])
            return f"{path}::{group}" if group else path

        def remove_node(self, node):
            # loadfile puts the test that was running when its worker died
            # back in the queue, where a hang in native code (ended by the
            # faulthandler backstop) would end each new worker in turn
            workload = self.assigned_work.pop(node)
            pending = [
                (unit, nodeid)
                for unit in workload.values()
                for nodeid, done in unit.items()
                if not done
            ]
            if not pending:
                return None
            unit, crashitem = pending[0]
            unit[crashitem] = True
            self.workqueue.update(
                (scope, work)
                for scope, work in workload.items()
                if not all(work.values())
            )
            for other in self.assigned_work:
                self._reschedule(other)
            return crashitem

    return CostGroupScheduling(config, log)
