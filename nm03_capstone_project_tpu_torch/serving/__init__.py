"""Online serving: the always-warm single-slice request path.

The port's counterpart of the JAX package's ``serving/``:

* :mod:`~.queue` — bounded admission with load-shedding backpressure;
* :mod:`~.batcher` — dynamic coalescing into bucket-padded batches;
* :mod:`~.graphs` — one CUDA graph per (lane, bucket) over the pipeline;
* :mod:`~.executor` — the warm graphs behind per-lane supervision;
* :mod:`~.lanes` — the per-lane fault domains;
* :mod:`~.server` — the stdlib HTTP front end:
  ``python -m nm03_capstone_project_tpu_torch.serving.server``.

The load generator, ``nm03-top``, volume serving and the fleet front end
are not ported yet.
"""
