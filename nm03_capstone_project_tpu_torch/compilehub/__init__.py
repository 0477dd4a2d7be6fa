"""compilehub — the compile home of the port's device code.

The JAX package's ``compilehub/`` compiles and caches XLA executables. The
port has two kinds of compiled device code, and this package is the public
surface of the one that persists:

* the nvcc-built kernel libraries (``csrc/{median,fused,grow}.cu``), built
  and loaded by :mod:`..kernels.build`, persisted by
  :class:`~.persist.KernelCache` under :class:`~.persist.PersistKey`
  (``nm03-serve --compile-cache-dir`` / ``$NM03_COMPILE_CACHE_DIR``): a
  second process start loads the libraries, verified, instead of running
  ``nvcc``;
* the per-(lane, bucket) CUDA graphs, captured at the server's warmup
  (:mod:`..serving.graphs`) and reported on ``/readyz``; a graph lives in
  its process's device memory and cannot be persisted.

Each module of the JAX ``compilehub/`` and its counterpart:

* ``persist.py`` -> :mod:`.persist` (``ExecutableCache`` ->
  :class:`~.persist.KernelCache`; ``config_digest`` and ``result_version``
  are in :mod:`..cache.keys`; ``attach_jax_compilation_cache`` and
  ``jax_cache_stats`` have none: eager PyTorch has no compilation cache);
* ``cache_cli.py`` -> :mod:`.cache_cli` (``ls``, ``verify``, ``gc``,
  ``result``);
* ``hub.py`` -> :mod:`..kernels.build` (the build, its key, where each
  library came from and what it cost: :func:`..kernels.build.records`)
  plus :mod:`..serving.graphs` (the capture of each bucket's program);
* ``compat.py`` -> :mod:`..parallel` (``shard_map``/``pjit`` are the
  meshes of :mod:`..parallel.mesh` and the per-shard loops of
  :mod:`..parallel.dp` and :mod:`..parallel.zshard`;
  ``distributed_is_initialized`` is :func:`..parallel.distributed.is_initialized`;
  the CPU collectives are gloo's);
* ``programs.py`` -> the eager entry points: ``slice_*`` and ``batch_*``
  are :mod:`..pipeline.slice_pipeline`, ``volume_*``
  :mod:`..pipeline.volume_pipeline`, ``serve_mask``
  :class:`..serving.graphs.BucketGraph` driven by
  :class:`..serving.executor.WarmExecutor` (which also resolves the lane
  devices, ``lane_devices``), ``serve_volume`` :mod:`..serving.volumes`.

Stdlib only: importing it loads no backend.
"""

from nm03_capstone_project_tpu_torch.compilehub.persist import (
    ENTRY_SUFFIX,
    ENV_CACHE_DIR,
    KernelCache,
    PersistKey,
    cache_dir_from_env,
    gc_entries,
    scan_entries,
)

__all__ = [
    "ENTRY_SUFFIX",
    "ENV_CACHE_DIR",
    "KernelCache",
    "PersistKey",
    "cache_dir_from_env",
    "gc_entries",
    "scan_entries",
]
