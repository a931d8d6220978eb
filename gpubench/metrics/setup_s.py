"""Seconds from the process's start to the window's: imports, the rows,
the kernels' build or load, binding and the first steps."""


def read(run):
    return run.setup_s
