"""Multi-device execution: meshes, data parallelism, z-sharded volumes.

The port of the JAX package's ``parallel/``:

* :mod:`.mesh` — :class:`~.mesh.Mesh`, :func:`~.mesh.make_mesh`, batch
  padding and the split/gather helpers;
* :mod:`.dp` — slice data parallelism over a ``data`` axis;
* :mod:`.zshard` — volumes sharded along z with halo exchange, in one
  process or over a ``torch.distributed`` process group;
* :mod:`.distributed` — ``torch.distributed`` init, the global mesh (one
  device a rank) and the drivers' collectives.
"""

from nm03_capstone_project_tpu_torch.parallel import distributed  # noqa: F401
from nm03_capstone_project_tpu_torch.parallel.dp import (  # noqa: F401
    map_batch_sharded,
    process_batch_sharded,
)
from nm03_capstone_project_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_shards,
    gather_shards,
    make_mesh,
    pad_to_multiple,
    replicated,
)
from nm03_capstone_project_tpu_torch.parallel.zshard import (  # noqa: F401
    process_volume_batch_zsharded,
    process_volume_zsharded,
)
