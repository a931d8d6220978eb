"""The share of the traced window, in %, that no kernel, copy or memset
covers on the card (the union of the device's events)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
