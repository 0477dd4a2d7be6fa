"""Host time from the entry call to its return (the enqueue, and any wait
the entry makes inside it), the mean over every study of the window."""


def read(run):
    if not run.window:
        return None
    return 1e3 * sum(r.dispatch_s for r in run.window) / len(run.window)
