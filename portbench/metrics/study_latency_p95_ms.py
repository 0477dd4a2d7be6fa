"""95th percentile over every study that completed in the window of its
latency: from the moment its staging from pinned host memory began to its
masks in host memory, on the device's clock (CUDA events)."""

import statistics


def read(run):
    lat = sorted(r.latency_ms for r in run.completed())
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
