"""Device time a study of every kernel that is neither one of the
program's hand-written kernels nor a copy or memset: PyTorch's own ops
around the kernels (in a volume, mostly the 3D growth)."""


def read(run):
    t = run.trace
    if t is None or not t.complete or not t.studies:
        return None
    spent = sum(s for name, s in t.kernel_s.items() if name not in t.handwritten)
    return 1e3 * spent / t.studies
