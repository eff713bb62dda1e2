"""The port's driver entry points (``__graft_entry_cuda__.py``) on the CPU:
``entry()`` returns the one-device solve step and its example arguments,
and the step runs (8^4, the Dslash's plain version, ten GCR iterations);
``dryrun_multichip(4)`` runs the five decomposed dry runs on four thread
ranks: the fused sharded solve against the single-device one, the sharded
MG solve, the sharded even-odd solve against the full operator, the
canonical operator over (t, z, y), and stacked right-hand sides over a
data-parallel axis. On the card the same calls run without ``device``;
``chip_smoke.py`` makes them."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry_cuda__ as graft  # noqa: E402


@pytest.fixture(autouse=True)
def thread_ranks():
    """Ranks as threads of one process: a short switch interval and one
    intra-op thread each, restored after the test."""
    old, old_threads = sys.getswitchinterval(), torch.get_num_threads()
    sys.setswitchinterval(1e-4)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        sys.setswitchinterval(old)
        torch.set_num_threads(old_threads)


def test_entry():
    fn, (a, rhs) = graft.entry(device="cpu")
    assert rhs.shape == (4, 3, 8, 8, 64) and a.d.field_shape == rhs.shape
    x, relres = fn(a, rhs)
    assert x.shape == rhs.shape and np.isfinite(relres) and relres < 1.0


def test_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()


def test_dryrun_multichip_four_ranks():
    graft.dryrun_multichip(4, device="cpu")
