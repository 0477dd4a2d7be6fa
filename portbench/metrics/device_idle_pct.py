"""Share of the traced pass in which no kernel, copy or memset ran on the
card: one minus the union of the profiler's device intervals over the
pass."""


def read(run):
    t = run.trace
    if t is None or not t.complete or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
