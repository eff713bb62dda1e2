"""``correct`` on the CPU at 4^4: true for the program as configured, and
false for the lower-precision control and for every fault planted under
the timed path (a solve returning its start unchanged, half the
right-hand sides left unsolved, an answer altered where it is produced).
A one-chip cell has no exchange between chips to leave out. The same
controls run on the chip at the cells' own sizes through
``python3 -m portbench.controls``, with the MG cells' faults (the
preconditioner or its null-vector setup left out): at 4^4, MG without a
smoother saves no outer iterations, so here only the judgement of the
outer-iteration count is tested."""

from __future__ import annotations

import pytest

from portbench import controls
from portbench.tests.helpers import tiny_spec

CELLS = ["gcr32.noise", "mg32.noise", "mg32.propagator", "gcr32.refine"]
SECONDS = {"gcr32.noise": 0.5, "mg32.noise": 0.5, "mg32.propagator": 0.0, "gcr32.refine": 0.5}


@pytest.fixture(scope="module", params=CELLS)
def spec(request):
    return request.param, tiny_spec(request.param)


def test_the_program_is_correct(spec):
    name, s = spec
    r = controls.one(s, 2**31 + 11, SECONDS[name], "cpu")
    assert r["correct"] and r["judged"] >= 1, r


def test_the_control_is_not(spec):
    name, s = spec
    r = controls.one(s, 2**31 + 13, SECONDS[name], "cpu", **controls.control_kwargs(s))
    assert not r["correct"], r


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
def test_a_planted_fault_is_caught(spec, fault):
    name, s = spec
    r = controls.one(s, 2**31 + 17, SECONDS[name], "cpu", **controls.FAULTS[fault]())
    assert not r["correct"], r


@pytest.mark.parametrize("name", ["mg32.noise", "mg32.propagator"])
def test_outer_iterations_over_their_limit_are_not_correct(name):
    s = tiny_spec(name)
    sound = controls.one(s, 2**31 + 19, SECONDS[name], "cpu")
    assert sound["correct"] and sound["outer_iters_max"] <= s["traffic"]["outer_iters_limit"]
    s["traffic"]["outer_iters_limit"] = sound["outer_iters_max"] - 1
    over = controls.one(s, 2**31 + 19, SECONDS[name], "cpu")
    assert over["outer_iters_max"] == sound["outer_iters_max"] and not over["correct"], over


def test_the_mg_faults_reach_the_solve():
    """The preconditioner left out leaves M = I; the null-vector setup left
    out builds the hierarchy on other vectors: each changes the outer solve."""
    s = tiny_spec("mg32.noise")
    sound = controls.one(s, 2**31 + 23, 0.0, "cpu")
    for name, make in controls.MG_FAULTS.items():
        r = controls.one(s, 2**31 + 23, 0.0, "cpu", **make())
        assert r["outer_iters_max"] != sound["outer_iters_max"], (name, r)
