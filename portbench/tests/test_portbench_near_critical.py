"""``correct`` in the two near-critical cells on the CPU at 4^4, as
test_portbench_faults.py holds the first four: true for the program as
configured, false for the bfloat16-link control and for every fault
planted under the timed path, and false once the most outer iterations
of a window pass ``outer_iters_limit``. The smoothed cell's V-cycle is
held to ``reference/vcycle.py`` in tests/test_torch_mg_smoothed.py."""

from __future__ import annotations

import pytest

from portbench import controls
from portbench.tests.helpers import tiny_spec

CELLS = ["mg32_smoothed.near_critical", "mg32.near_critical"]


@pytest.fixture(scope="module", params=CELLS)
def spec(request):
    return tiny_spec(request.param)


def test_the_program_is_correct(spec):
    r = controls.one(spec, 2**31 + 31, 0.5, "cpu")
    assert r["correct"] and r["judged"] >= 1, r


def test_the_control_is_not(spec):
    r = controls.one(spec, 2**31 + 37, 0.5, "cpu", **controls.control_kwargs(spec))
    assert not r["correct"], r


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
def test_a_planted_fault_is_caught(spec, fault):
    r = controls.one(spec, 2**31 + 41, 0.5, "cpu", **controls.FAULTS[fault]())
    assert not r["correct"], r


def test_outer_iterations_over_their_limit_are_not_correct(spec):
    sound = controls.one(spec, 2**31 + 43, 0.0, "cpu")
    assert sound["correct"] and sound["outer_iters_max"] <= spec["traffic"]["outer_iters_limit"]
    spec = dict(spec, traffic=dict(spec["traffic"], outer_iters_limit=sound["outer_iters_max"] - 1))
    over = controls.one(spec, 2**31 + 43, 0.0, "cpu")
    assert over["outer_iters_max"] == sound["outer_iters_max"] and not over["correct"], over
