"""Dilation steps (jump rounds) of the 3D growth a study: the program's
``grow3d.steps`` counter over the traced pass's studies."""


def read(run):
    p = getattr(run, "program", None)
    if p is None or not p.studies or "grow3d.steps" not in p.counters:
        return None
    return p.counters["grow3d.steps"] / p.studies
