"""A local SGD loss check in ms: the untraced part's time outside rounds
(the test split's evaluation, the loss checker and the loop) over its
checks."""


def read(run):
    part = run.host
    if "round_seconds" not in part.extra or not part.extra.get("checks"):
        return None
    return (part.seconds - part.extra["round_seconds"]) / part.extra["checks"] * 1e3
