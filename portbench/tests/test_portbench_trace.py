"""The trace arithmetic on a synthetic timeline: busy time as the union of
device intervals, idle gaps by the innermost open span, the percentile."""

from __future__ import annotations

import pytest

from portbench.timing import percentile
from portbench.trace import Trace, short_name


def _trace():
    ops = [("k1", 10, 30), ("k2", 20, 40), ("k1", 60, 70)]  # overlap 20-30
    spans = [("portbench.traced", 0, 100), ("portbench.solve", 5, 80),
             ("portbench.vcycle", 45, 55)]
    return Trace(ops, spans, 0, 100)


def test_busy_is_the_union_of_intervals():
    t = _trace()
    assert t.busy_s() == pytest.approx(40e-9)
    assert t.busy_s(within="portbench.vcycle") == 0.0
    assert t.busy_s(within="portbench.solve") == pytest.approx(40e-9)
    assert t.op_seconds("k1") == pytest.approx(30e-9)
    assert t.device_ops() == [["k1", pytest.approx(30e-9)], ["k2", pytest.approx(20e-9)]]


def test_idle_gaps_go_to_the_innermost_open_span():
    gaps = dict(_trace().idle_gaps())
    # 0-10: traced (solve opens at 5, midpoint 5 -> solve); 40-60: midpoint 50 in vcycle;
    # 70-100: midpoint 85, only traced open
    assert gaps["portbench.vcycle"] == pytest.approx(20e-9)
    assert gaps["portbench.solve"] == pytest.approx(10e-9)
    assert gaps["portbench.traced"] == pytest.approx(30e-9)


def test_percentile_and_names():
    assert percentile(list(range(1, 101)), 90) == 90
    assert percentile([5.0], 90) == 5.0
    assert short_name("void mg::k<2, (x)>(float*, int)") == "void mg::k<2, (x)>"
