"""What an epoch spends outside its training launch, in ms, over the
untraced part of the window: the mean time from one epoch's end to the
next, less the mean of the trainer's own epoch seconds
(``FitResult.epoch_seconds``: the launch and its synchronize).  The rest
is the train and test evaluations and the loop."""


def read(run):
    part = run.host
    seconds = part.extra.get("epoch_seconds")
    if not seconds or part.units == 0:
        return None
    return (part.seconds / part.units - sum(seconds) / len(seconds)) * 1e3
