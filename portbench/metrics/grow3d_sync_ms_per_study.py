"""Host time a study in the 3D growth's ``grow3d.sync`` spans: the
dispatch thread waiting on the card's popcount, over the traced pass's
studies."""


def read(run):
    p = getattr(run, "program", None)
    if p is None or not p.studies or not any(n == "grow3d.sync" for _, _, n, _ in p.spans):
        return None
    return p.host_ms("grow3d.sync") / p.studies
