"""Process start to the first timed dispatch: loading or building the
kernels, making the data, warming the cell's shapes."""


def read(run):
    return run.setup_s
