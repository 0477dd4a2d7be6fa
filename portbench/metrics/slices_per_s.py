"""Slices (planes, for a volume) whose masks reached the host inside the
window, over the window's seconds: a whole-window rate."""


def read(run):
    done = run.completed()
    return sum(r.planes for r in done) / run.seconds if done else None
