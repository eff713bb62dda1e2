"""The per-test time limit of the repository's root conftest.py: the context
manager that the hook wraps every test's call in, nested inside the hook's
own limit."""

import signal
import time

import pytest


@pytest.fixture
def root(pytestconfig):
    """The root conftest.py as pytest loaded it (tests/conftest.py, too,
    is a module named ``conftest``)."""
    path = pytestconfig.rootpath / "conftest.py"
    return pytestconfig.pluginmanager.get_plugin(str(path))


def test_body_past_the_limit_raises_naming_it(root):
    with pytest.raises(root.TimeLimitExceeded, match="time limit of 1 s"):
        with root.time_limit(1):
            time.sleep(5)


@pytest.mark.parametrize("hooks_alarm", ["armed", "paused"])
def test_body_under_the_limit_returns_and_restores_the_alarm(
    root, hooks_alarm
):
    handler = signal.getsignal(signal.SIGALRM)
    delay, _ = signal.getitimer(signal.ITIMER_REAL)
    if hooks_alarm == "paused":
        signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        with root.time_limit(0.5):
            pass
        time.sleep(0.7)  # past the moment the inner alarm was set for
        assert signal.getsignal(signal.SIGALRM) is handler
        left, _ = signal.getitimer(signal.ITIMER_REAL)
        if hooks_alarm == "armed":
            limit = root.TEST_TIME_LIMIT_S
            assert limit - 10 < left < delay <= limit
        else:
            assert left == 0
    finally:
        if hooks_alarm == "paused":
            signal.setitimer(signal.ITIMER_REAL, delay)
