"""The follower ranks of a volume gang that spans a ``torch.distributed`` job.

JAX runs one program in every process of a job, so the JAX server's gang
over the global devices needs no follower. ``torch.distributed`` ranks
each run their own program: rank 0 serves HTTP and runs the gang
(:class:`.volumes.VolumeGang`), and every other rank runs :func:`follow`
in place of a server. For each gang dispatch rank 0 broadcasts a header
and the study (:func:`..parallel.distributed.broadcast_study`), and every
rank then runs :func:`.volumes.distributed_gang_program`, which joins the
study's halo exchanges, counts and the mask's gather. A keepalive header
is skipped; the stop header (rank 0's ``app.close()``) ends the loop.

A study is bounded as rank 0 bounds it (``bound_s``, the server's
``--volume-timeout-s``): its collectives run on the data-plane group whose
timeout is that bound, and past it the follower aborts the data plane's
communicator and raises, so the rank exits non-zero rather than wait on a
gang that is gone.
"""

from __future__ import annotations

from typing import Optional

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.parallel import distributed
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("serving")


def follow(cfg: PipelineConfig, bound_s: Optional[float] = None) -> int:
    """Follow rank 0's gang dispatches until its stop; 0 then.

    Raises whatever a collective raises when rank 0 is gone (the process
    group's own error or timeout), and RuntimeError when a study outlasts
    ``bound_s``: a follower never outlives its gang.
    """
    from nm03_capstone_project_tpu_torch.serving.volumes import distributed_gang_program

    rank, world = distributed.process_index(), distributed.process_count()
    log.info("volume gang follower: rank %d of %d on %s", rank, world,
             distributed.local_device())
    studies = 0
    while True:
        op, stack, dims = distributed.broadcast_study()
        if op == distributed.OP_STOP:
            log.info("volume gang follower: rank %d stops after %d studies", rank, studies)
            return 0
        if op == distributed.OP_STUDY:
            with distributed.bounded_study(bound_s, lambda: log.error(
                    "volume gang follower: a study passed its bound of %gs; aborting the "
                    "data plane", bound_s)) as passed:
                distributed_gang_program(stack, dims, cfg)
            if passed.is_set():
                raise RuntimeError(f"a study passed its bound of {bound_s:g}s; the follower "
                                   "leaves the gang")
            studies += 1
