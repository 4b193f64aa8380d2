"""Slices reconstructed per second: every slice of every request completed
in the window over the window's length (host clock)."""


def read(run):
    if not run.elapsed:
        return None
    return run.units / run.elapsed
