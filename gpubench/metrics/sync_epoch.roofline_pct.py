"""The ``sync_epoch`` kernel's share of its roofline, in %: the least
time of the traced launches (bytes and operations counted from shapes,
roofline.py, at the card's published peaks) over their device time."""

from gpubench.roofline import SYNC_EPOCH_KERNEL


def read(run):
    if run.trace is None or run.launch_work is None:
        return None
    launches, seconds = run.trace.kernel_matching(SYNC_EPOCH_KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * run.launch_work.least_seconds() / seconds
