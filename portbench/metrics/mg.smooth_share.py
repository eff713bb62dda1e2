"""Share of the V-cycle's device busy time that the GCR smoother's own
kernels take: their device seconds (K2's unpreconditioned instance
``gcr_step_kernel<.., false, ..>``, K3 ``ap_update_kernel``, K4
``basis_flush_kernel`` and the reductions launched with them;
``portbench/smooth_kernels.py``) over the union of device-operation
intervals inside the ``portbench.vcycle`` spans of the traced solves."""

from portbench import smooth_kernels


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_s(within="portbench.vcycle")
    if not busy:
        return None
    return smooth_kernels.seconds(run.trace) / busy
