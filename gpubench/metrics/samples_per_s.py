"""Training samples per second: every sample the window's steps drew
(steps x batch x workers) over the whole window, evaluations included."""


def read(run):
    return run.whole.samples / run.whole.seconds
