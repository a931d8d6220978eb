"""The whole step's share of the card's peak, in %: the least time of the
traced part's work (every training launch and evaluation in it, counted
from shapes in roofline.py: the larger of the FLOPs at 67 TFLOP/s and the
bytes at 3.35 TB/s) over the traced window."""


def read(run):
    if run.trace is None or run.work is None:
        return None
    return 100.0 * run.work.least_seconds() / run.trace.window_s
