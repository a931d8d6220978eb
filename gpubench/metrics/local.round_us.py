"""A local SGD round in us: the engine's ``slave.async.round.seconds``
(h steps in one launch, the average and the synchronize), its sum over
its count in the untraced part of the window."""


def read(run):
    part = run.host
    if "round_seconds" not in part.extra or part.units == 0:
        return None
    return part.extra["round_seconds"] / part.units * 1e6
