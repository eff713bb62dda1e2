"""``gcr.idle_share`` of the MG cells: 1 - (union of device-operation
intervals / traced wall time) over the traced solves."""

from portbench.trace import idle_share as read  # noqa: F401
