"""Reading a ``torch.profiler`` trace: device operations, the benchmark's
own spans (``record_function`` names under ``portbench.``), device busy
time as the union of operation intervals, and the idle gaps by the span
that was open on the host."""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from portbench.timing import busy_seconds, gaps

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_ns, end_ns) of device operations
    spans: list  # (name, start_ns, end_ns) of the benchmark's host spans
    lo: int  # the traced window, ns
    hi: int

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def busy_s(self, within: str | None = None) -> float:
        """Seconds in which a device operation ran, in the whole window or
        inside the spans named ``within``."""
        iv = [(s, e) for _, s, e in self.ops]
        if within is None:
            return busy_seconds(iv, self.lo, self.hi) * 1e-9
        return sum(busy_seconds(iv, s, e) for n, s, e in self.spans if n == within) * 1e-9

    def op_seconds(self, needle: str) -> float:
        """Summed device seconds of the operations whose name holds ``needle``."""
        return sum(e - s for n, s, e in self.ops if needle in n) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(int)
        for n, s, e in self.ops:
            by[short_name(n)] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds summed by the innermost benchmark span open
        at each gap's midpoint ("portbench.harness" where none is)."""
        by = defaultdict(int)
        edges = sorted([(s, 1, i) for i, (_, s, _e) in enumerate(self.spans)]
                       + [(e, 0, i) for i, (_, _s, e) in enumerate(self.spans)])
        open_, j = [], 0  # open span indices, by start
        for s, e in gaps([(a, b) for _, a, b in self.ops], self.lo, self.hi):
            mid = (s + e) / 2
            while j < len(edges) and edges[j][0] <= mid:
                _, starts, i = edges[j]
                if starts:
                    open_.append(i)
                else:
                    open_.remove(i)
                j += 1
            name = (max(open_, key=lambda i: self.spans[i][1]) if open_ else None)
            by[self.spans[name][0] if name is not None else SPAN_PREFIX + "harness"] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_share(run):
    """1 - (union of device-operation intervals / traced wall time) over the
    run's traced solves; None without a trace."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its parameter list, at most ``width`` long."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def collect(prof, window: str = SPAN_PREFIX + "traced") -> Trace:
    """The Trace of a stopped profiler; its window is the span ``window``."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        on_device = e.device_type() == DeviceType.CUDA
        if name.startswith(SPAN_PREFIX):
            if not on_device and kind in (None, "user_annotation"):
                spans.append((name, start, end))
        elif on_device and kind in (None,) + DEVICE_KINDS:
            ops.append((name, start, end))
    outer = [sp for sp in spans if sp[0] == window]
    if not outer:
        raise RuntimeError(f"the trace has no span {window}")
    return Trace(ops, spans, outer[0][1], outer[0][2])
