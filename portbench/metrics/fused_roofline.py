"""The fused preprocess kernel's share of its frozen floor: the traced
pass's studies times the floor of one study's normalize -> clip -> median
-> sharpen (portbench.floors), over the kernel's summed device time."""

from portbench import floors


def read(run):
    t = run.trace
    spent = t.kernel_s.get("fused_kernel") if t and t.complete else None
    if not spent:
        return None
    return 100.0 * t.studies * floors.fused_floor_s(run.shape, run.pipeline)[0] / spent
