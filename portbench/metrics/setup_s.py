"""Seconds from the process's start to the window's: imports, the program's
task (plans, operator norm, kernel builds on a first run), the weights, the
inputs and the warm-up."""


def read(run):
    return run.setup_s
