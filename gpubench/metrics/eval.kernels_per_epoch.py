"""Device kernels other than ``sync_epoch``'s in the traced part of the
window, per epoch: the evaluation's launches (and the id draw's).  A trace
in which no launch bears the kernel's name reads nothing, so that a
renamed kernel fails the run rather than counting as evaluation."""

from gpubench.roofline import SYNC_EPOCH_KERNEL


def read(run):
    if run.trace is None or "epoch_seconds" not in run.traced.extra or run.traced.units == 0:
        return None
    if run.trace.kernel_matching(SYNC_EPOCH_KERNEL)[0] == 0:
        return None
    return run.trace.kernels_not_matching(SYNC_EPOCH_KERNEL) / run.traced.units
