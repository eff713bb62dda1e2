"""The device seconds, in a trace, of the kernels that only the V-cycle's
GCR smoother runs in a smoothed-MG cell. There the outer solve is
preconditioned and takes the fused loop form (B6 ``update_xr``, B9 the
z-step, B7 ``dir_update``), and the coarse GCR is the generic loop, so
only the smoother's unpreconditioned restart cycles run:
- K2, the one-pass step: ``gcr_step_kernel`` with its ``ZSTEP`` template
  flag false (B9 is the same template with the flag true);
- K3, ``ap_update_kernel``;
- K4, ``basis_flush_kernel``;
each with the ``reduce_partials_kernel`` that its launcher runs right
after it (K2's and K3's dots). K1, the plain Dslash, is left out: the
outer solve and the V-cycle's residual run it too."""

from __future__ import annotations

import re

OWN = re.compile(r"gcr_step_kernel<\d+, [^,]+, false\b|ap_update_kernel|basis_flush_kernel")
REDUCE = "reduce_partials_kernel"


def seconds(trace) -> float:
    """Summed device seconds of the smoother's kernels in ``trace`` (a
    ``trace.Trace``): in start order on the one stream, a reduction counts
    when the operation before it does."""
    total, owned = 0, False
    for name, start, end in sorted(trace.ops, key=lambda op: op[1]):
        if REDUCE not in name:
            owned = OWN.search(name) is not None
        if owned:
            total += end - start
    return total * 1e-9
