"""The 90th percentile of the times from one epoch's end (its training and
both evaluations) to the next over the untraced part of the window, in ms."""

import statistics


def read(run):
    part = run.host
    if "epoch_seconds" not in part.extra or len(part.ends) < 11:
        return None
    gaps = [b - a for a, b in zip(part.ends, part.ends[1:])]
    return statistics.quantiles(gaps, n=10)[8] * 1e3
