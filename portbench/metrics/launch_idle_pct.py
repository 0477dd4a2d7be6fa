"""Share of the traced pass in which the card ran nothing while the
dispatch thread was inside one of the program's stage spans (the entry's
own time included) other than a ``grow3d.sync``: the card idle behind the
host's launches, each instant put down to the innermost span
(``portbench.program.idle_by_span``)."""

from portbench import program


def read(run):
    t, p = run.trace, getattr(run, "program", None)
    if p is None or not p.idle_s or t is None or not t.complete or t.window_s <= 0:
        return None
    return 100.0 * program.launch_idle_s(p.idle_s) / t.window_s
