"""Online serving: the always-warm request path.

The port's counterpart of the JAX package's ``serving/``:

* :mod:`~.queue` — bounded admission with load-shedding backpressure;
* :mod:`~.batcher` — dynamic coalescing into bucket-padded batches;
* :mod:`~.graphs` — one CUDA graph per (lane, bucket) over the pipeline;
* :mod:`~.executor` — the warm graphs behind per-lane supervision;
* :mod:`~.lanes` — the per-lane fault domains;
* :mod:`~.volumes` — the volume gang behind ``POST /v1/segment-volume``;
* :mod:`~.server` — the stdlib HTTP front end:
  ``python -m nm03_capstone_project_tpu_torch.serving.server``;
* :mod:`~.loadgen` — the load generator;
* :mod:`~.top` — ``nm03-top``, the live console view of a server or of a
  fleet (``python -m nm03_capstone_project_tpu_torch.serving.top``).

The package imports nothing at import time: ``serving.top`` and
``serving.metrics`` stay free of torch and numpy, and the volume gang's
names below load on first use.
"""

_VOLUME_NAMES = ("DEFAULT_VOLUME_DEPTH_BUCKETS", "GangUnavailable", "VolumeGang", "VolumeRequest")


def __getattr__(name):
    if name in _VOLUME_NAMES:
        from nm03_capstone_project_tpu_torch.serving import volumes

        return getattr(volumes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
