"""The whole chain's frozen floor for one study (portbench.floors) over
the window's seconds a completed study: the share of the card's peak that
the studies completed in the window amount to."""

from portbench import floors


def read(run):
    done = run.completed()
    if not done:
        return None
    floor = floors.chain_floor_s(run.shape, run.pipeline, run.volume)[0]
    return 100.0 * floor * len(done) / run.seconds
