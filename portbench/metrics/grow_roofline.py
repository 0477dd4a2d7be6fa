"""The 2D grow kernel's (``cluster`` route) share of its frozen bytes
floor: the traced pass's studies times one study's floor, over the
kernel's summed device time."""

from portbench import floors


def read(run):
    t = run.trace
    spent = t.kernel_s.get("grow_kernel") if t and t.complete else None
    if not spent:
        return None
    return 100.0 * t.studies * floors.grow_floor_s(run.shape)[0] / spent
