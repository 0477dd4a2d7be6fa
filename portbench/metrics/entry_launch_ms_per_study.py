"""Host time a study inside the program's ``entry`` spans that is not a
``grow3d.sync`` wait under them: the entry call launching, over the
traced pass's studies (``portbench.program``)."""


def read(run):
    p = getattr(run, "program", None)
    if p is None or not p.studies or not p.host_ms("entry"):
        return None
    return (p.host_ms("entry") - p.host_ms("grow3d.sync", under="entry")) / p.studies
