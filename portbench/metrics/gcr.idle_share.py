"""1 - (union of device-operation intervals / traced wall time) over the
traced solves, from ``torch.profiler``."""

from portbench.trace import idle_share as read  # noqa: F401
