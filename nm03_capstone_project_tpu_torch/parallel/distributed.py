"""Multi-process jobs: ``torch.distributed`` init, the global mesh, collectives.

The port of the JAX package's ``parallel/distributed.py``. There one
process a host joins ``jax.distributed`` and every host's chips form one
global device set. Here :func:`initialize` wraps
``torch.distributed.init_process_group`` and the job follows torchrun's
idiom: **one process a device**. :func:`global_mesh` therefore holds one
device a rank, which is a deliberate difference from the JAX package's
multi-device hosts; a rank's other local devices belong to other ranks.

The backend follows the device the caller names: ``nccl`` for ``cuda``,
``gloo`` for ``cpu``. It is stated in the log and never switched quietly.
NCCL refuses two ranks on one GPU, so a one-card machine runs a world of
1 under NCCL, and several-rank jobs run on the CPU under gloo.

Usage in each process of a job::

    from nm03_capstone_project_tpu_torch.parallel import distributed
    distributed.initialize()          # no-op alone, env-driven under torchrun
    mesh = distributed.global_mesh(("z",))

The coordinator address, process count and process id come from the
explicit arguments, or else from the launcher's environment
(:data:`_CLUSTER_ENV_SIGNALS`: torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``, SLURM's and Open MPI's task variables).

The collectives the drivers need are plain functions here:
:func:`barrier`, :func:`broadcast_one_to_all`, :func:`allgather`, and for
training :func:`all_reduce_sum` (the gradients). The serving volume gang
across processes sends each dispatch with :func:`broadcast_study`: a
fixed-size header (:data:`OP_STUDY`, :data:`OP_KEEPALIVE` or
:data:`OP_STOP`), then the study. The header travels on the host over a
gloo group (:func:`control_group`; the job's own group under gloo, a
side group beside NCCL): gloo raises as soon as a peer's socket closes,
whereas an NCCL collective with a dead peer blocks until the process
group's timeout. So a rank lost between dispatches fails the next header
in rank 0's Python before any NCCL op is queued. The study follows on the
backend's device: the card's under NCCL, the host's under gloo.

A served gang bounds its studies (:func:`open_data_plane`): the study and
every collective of its program go on a **data-plane group** of their own
whose timeout is the server's ``--volume-timeout-s``, while headers and
keepalives keep the job's long timeout. When a study passes that bound,
:func:`abort_data_plane` aborts the data plane's communicator, so a rank
blocked on a lost peer returns instead of waiting out the job's timeout;
:func:`initialize` sets NCCL's asynchronous error handling to abort a
failed communicator without tearing the process down.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("distributed")

# Environment signals that a multi-process launcher surrounds this
# process, with where each names the world size and this process's rank:
# (signal, world-size variable, rank variable). The coordinator address
# comes from MASTER_ADDR/MASTER_PORT (torchrun sets them; under SLURM or
# Open MPI the job script exports them) or from the explicit argument.
_CLUSTER_ENV_SIGNALS = (
    ("MASTER_ADDR", "WORLD_SIZE", "RANK"),  # torchrun / torch.distributed.launch
    ("SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID"),  # SLURM
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),  # Open MPI
)

DEFAULT_TIMEOUT_S = 300.0

# the ops of a gang dispatch header (:func:`broadcast_study`): a study to
# run, a keepalive (an idle gang sends one well inside DEFAULT_TIMEOUT_S,
# so a follower's wait for the next study never times out), and the stop
# that ends the followers' loop
OP_STOP, OP_STUDY, OP_KEEPALIVE = 0, 1, 2
_HEADER_LEN = 6  # op, depth, height, width, true height, true width

# the gloo side group of an NCCL job (:func:`control_group`)
_CONTROL = None
# the study data plane of a served gang (:func:`open_data_plane`)
_DATA = None
# TORCH_NCCL_ASYNC_ERROR_HANDLING=2 (CleanUpOnly): NCCL's watchdog aborts a
# failed or timed-out communicator and leaves the process running; the
# default (3, SkipCleanUp) tears the process down, and with it every slice
# lane of a serving rank
_NCCL_ERROR_HANDLING = ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")


def _cluster_env() -> Optional[Dict[str, object]]:
    """``{'source', 'world', 'rank', 'address'}`` of the first launcher
    whose signal is set, or None. ``address`` is None when the
    environment names no ``MASTER_ADDR``."""
    for signal, world_var, rank_var in _CLUSTER_ENV_SIGNALS:
        if os.environ.get(signal):
            world = os.environ.get(world_var)
            rank = os.environ.get(rank_var)
            addr = os.environ.get("MASTER_ADDR")
            port = os.environ.get("MASTER_PORT")
            return {
                "source": signal,
                "world": int(world) if world else None,
                "world_var": world_var,
                "rank": int(rank) if rank else None,
                "address": f"{addr}:{port}" if addr and port else None,
            }
    return None


def backend_for(device=None) -> str:
    """``nccl`` for a CUDA device (the default), ``gloo`` for the CPU."""
    from nm03_capstone_project_tpu_torch.core.backend import resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process into the job; True if it is in one.

    With no arguments and no launcher environment this is a no-op that
    returns False, so drivers can call it unconditionally. A second call
    is a no-op that returns True. An explicit request, or a detected
    launcher, that fails to join raises: carrying on alone would run
    duplicate work into the same tree. A world size that differs from
    ``num_processes`` raises with both numbers.
    """
    if is_initialized():
        return True
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    env = _cluster_env()
    if not explicit and (env is None or (env["world"] or 1) <= 1):
        return False
    env = env or {}
    if num_processes is not None and env.get("world") not in (None, num_processes):
        raise ValueError(
            f"world size {env['world']} (${env['world_var']}) differs from "
            f"--num-processes {num_processes}"
        )
    address = coordinator_address or env.get("address")
    world = num_processes if num_processes is not None else env.get("world")
    rank = process_id if process_id is not None else env.get("rank")
    missing = [name for name, v in (("coordinator address", address),
                                    ("process count", world),
                                    ("process id", rank)) if v is None]
    if missing:
        raise ValueError(
            "cannot join the distributed job: no " + ", no ".join(missing)
            + " (pass --coordinator-address HOST:PORT --num-processes N "
            "--process-id I, or launch with torchrun)"
        )
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    backend = backend_for(device)
    if backend == "nccl":
        # one process a device: the rank's own card is current before NCCL
        # sees it (batch_isend_irecv hangs otherwise)
        torch.cuda.set_device(_local_cuda_index(rank))
        var, mode = _NCCL_ERROR_HANDLING
        if os.environ.get(var, mode) != mode:
            log.warning("%s=%s replaced by %s: a failed communicator is aborted, "
                        "the process keeps running", var, os.environ[var], mode)
        os.environ[var] = mode
    log.info("joining a %d-process job as rank %d at %s over %s",
             world, rank, address, backend)
    _dist().init_process_group(
        backend,
        init_method=f"tcp://{address}",
        world_size=int(world),
        rank=int(rank),
        timeout=datetime.timedelta(seconds=float(timeout_s)),
    )
    got = _dist().get_world_size()
    if got != world:  # pragma: no cover - the rendezvous enforces it
        shutdown()
        raise ValueError(f"joined a world of {got}, not --num-processes {world}")
    global _CONTROL
    if backend == "nccl":  # every rank creates it, in the same place
        _CONTROL = _dist().new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=float(timeout_s)))
    return True


def shutdown() -> None:
    """Leave the job (destroy the process group); a no-op outside one."""
    global _CONTROL, _DATA
    if is_initialized():
        _dist().destroy_process_group()  # the side groups with it
    _CONTROL = _DATA = None


def open_data_plane(timeout_s: float) -> None:
    """Give the studies of a served gang a group of their own, on the job's
    backend, whose collectives time out after ``timeout_s`` (the server's
    ``--volume-timeout-s``): the study's broadcast and every collective of
    its z-sharded program. Every rank calls it, in the same place; a no-op
    outside a job."""
    global _DATA
    if not is_initialized():
        return
    dist = _dist()
    _DATA = dist.new_group(backend=dist.get_backend(),
                           timeout=datetime.timedelta(seconds=float(timeout_s)))


def data_group():
    """The data-plane group of a served gang, else None (the job's own
    group: the batch drivers, training)."""
    return _DATA


@contextlib.contextmanager
def bounded_study(bound_s: Optional[float], on_passed=None):
    """Run a study's block under its bound: past ``bound_s`` seconds a
    timer calls ``on_passed()`` and then :func:`abort_data_plane`, so the
    block's blocked collectives return. Yields an Event that is set once
    the bound passed: the block's data must then be thrown away. No bound
    for ``bound_s`` None."""
    passed = threading.Event()
    timer = None
    if bound_s is not None:
        def fire():
            passed.set()
            if on_passed is not None:
                on_passed()
            abort_data_plane()

        timer = threading.Timer(bound_s, fire)
        timer.daemon = True
        timer.start()
    try:
        yield passed
    finally:
        if timer is not None:
            timer.cancel()


def abort_data_plane() -> bool:
    """Abort the data plane's communicator, so that a collective blocked on
    a lost peer returns (with an error, or with data that must be
    discarded). Uses ``torch.distributed.distributed_c10d.
    _abort_process_group(group)``, which aborts the group's NCCL
    communicators (``ProcessGroupNCCL::abort``); a gloo group has no abort,
    and its own timeout ends the wait. True if an abort was issued."""
    group = _DATA
    if group is None:
        return False
    from torch.distributed import distributed_c10d

    try:
        distributed_c10d._abort_process_group(group)
    except Exception as e:  # noqa: BLE001 — gloo, or a version without the call
        log.warning("data plane: no abort (%s: %s); its timeout ends the wait",
                    type(e).__name__, e)
        return False
    log.error("data plane: communicator aborted")
    return True


def control_group():
    """The gloo group the gang's dispatch headers travel on: the side
    group of an NCCL job, else None (the job's own gloo group)."""
    return _CONTROL


def _local_cuda_index(rank: int) -> int:
    n = max(torch.cuda.device_count(), 1)
    local = os.environ.get("LOCAL_RANK")
    return int(local) % n if local else rank % n


def local_device(device=None) -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo.

    Outside a job it is ``resolve_device(device)``: the card unless the
    caller asks for the CPU, raising when there is no card.
    """
    if is_initialized():
        if _dist().get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    from nm03_capstone_project_tpu_torch.core.backend import resolve_device

    return resolve_device(device)


def global_mesh(axis_names: Sequence[str] = ("data",), axis_sizes=None, device=None):
    """A mesh over every rank of the job, one device a rank (rank order).

    Only this rank's entry is this process's device; the others name the
    device their rank uses by the same rule (``cuda:LOCAL_RANK`` under
    NCCL, the CPU under gloo). Outside a job it is a one-entry mesh of
    :func:`local_device` of ``device``: the card unless the caller asks
    for the CPU.
    """
    from nm03_capstone_project_tpu_torch.parallel.mesh import Mesh, _device_array

    world, rank = process_count(), process_index()
    here = local_device(device)
    devs = [here if r == rank else
            (torch.device("cuda", r % max(torch.cuda.device_count(), 1))
             if here.type == "cuda" else here)
            for r in range(world)]
    if axis_sizes is None:
        axis_sizes = [world] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != world:
        raise ValueError(f"axis_sizes {list(axis_sizes)} != process count {world}")
    return Mesh(_device_array(devs, axis_sizes), axis_names, process_group=world > 1)


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_info() -> dict:
    """{'process_index', 'process_count', 'local_devices', 'global_devices'}."""
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": 1,
        "global_devices": process_count(),
    }


def barrier() -> None:
    """Every rank waits here for every other (a no-op outside a job)."""
    if process_count() <= 1:
        return
    dist = _dist()
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_one_to_all(value) -> np.ndarray:
    """Rank 0's numeric array (or scalar), on every rank, as numpy."""
    arr = np.asarray(value)
    if process_count() <= 1:
        return arr
    t = torch.as_tensor(arr, device=local_device()).clone()
    _dist().broadcast(t, src=0)
    return t.cpu().numpy()


def allgather(values) -> np.ndarray:
    """Every rank's 1-D int64 counters: a (process_count, n) int64 array.

    The JAX package carries int64 counters as two int32 halves because
    jax narrows int64 when x64 is off; torch carries int64 as it is, so
    the halves go and the contract (exact int64 rows, rank order) stays.
    """
    vals = np.asarray(values, np.int64).reshape(-1)
    if process_count() <= 1:
        return vals[None]
    dist = _dist()
    t = torch.as_tensor(vals, device=local_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank, in place, and returned (``t`` itself
    outside a job; in a world of 1 the reduction still runs, on the card
    under NCCL). ``t`` lies on :func:`local_device`."""
    if is_initialized():
        _dist().all_reduce(t)
    return t


def _broadcast_header(head) -> tuple:
    """Rank 0's dispatch header, on every rank, over :func:`control_group`."""
    header = torch.tensor(head, dtype=torch.int64)
    if is_initialized():
        _dist().broadcast(header, src=0, group=control_group())
    # nm03-lint: disable=NM422 the header's read is part of the broadcast sequence the gang's collective lock serializes; it is a host tensor (the control group is gloo)
    return tuple(int(v) for v in header.tolist())


def broadcast_study(op: int = OP_STUDY, stack=None, dims=None):
    """Rank 0's gang dispatch, on every rank: ``(op, stack, dims)``.

    Rank 0 passes ``op`` and, for :data:`OP_STUDY`, the padded (D, H, W)
    float32 study and its (2,) true in-plane size; every other rank passes
    nothing and receives them. The header goes first, on the host over
    :func:`control_group`, then the study, so a follower learns the shape
    before it allocates. ``stack`` comes back as a float32 tensor on this
    rank's device (None for the other ops) and ``dims`` as a (2,) int32
    array. In a job every op is a broadcast, also in a world of 1; outside
    a job it only hands the inputs back.
    """
    dev = local_device()
    head = [0] * _HEADER_LEN
    if process_index() == 0:
        head[0] = int(op)
        if op == OP_STUDY:
            head[1:4] = [int(n) for n in stack.shape]
            head[4:6] = [int(n) for n in np.asarray(dims).reshape(2)]
    op, d, h, w, dh, dw = _broadcast_header(head)
    if op != OP_STUDY:
        return op, None, None
    if process_index() == 0:
        t = torch.as_tensor(stack).to(dev, torch.float32)
    else:
        t = torch.empty((d, h, w), dtype=torch.float32, device=dev)
    if is_initialized():
        _dist().broadcast(t, src=0, group=data_group())
    return op, t, np.asarray([dh, dw], np.int32)
