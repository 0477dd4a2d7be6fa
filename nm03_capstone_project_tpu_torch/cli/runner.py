"""Cohort orchestration: the batch-driver layer.

The port of the JAX package's ``cli/runner.py``. The reference implements
its orchestration twice, SequentialImageProcessor (main_sequential.cpp:9-344)
and OptimizedParallelProcessor (main_parallel.cpp:19-387); here one
:class:`CohortProcessor` owns the loop and the two strategies differ only in
how a patient's slices are executed:

* ``sequential`` — one slice at a time through the pipeline, export
  interleaved per image (the reference's sequential contract), with one
  slice in flight: slice N+1 is enqueued on the card before slice N's
  result is fetched.
* ``parallel`` — slices decoded by an IO thread pool (the host C++ batch
  decoder by default), stacked into batches, copied to the card ahead of
  compute (:mod:`..ingest`), run through :func:`..pipeline.process_batch`,
  and rendered + JPEG-encoded by the IO pool while the next batch computes.

Fault tolerance mirrors the reference at both granularities: per-slice
catch-and-continue with success counting (main_sequential.cpp:267-271,
288-294) and per-patient catch-and-continue (main_sequential.cpp:301-305);
plus a manifest and a per-patient journal for ``--resume``.

With ``model`` (``--model``), a trained 2D student replaces the
pipeline's compute in both strategies (:func:`_student_batch_mask`); its
masks go through the same render, export and accounting. Over a ``data``
mesh each distinct device holds one copy of the student (a device the
mesh repeats shares it), and the masks gather on the run's device.

Every dispatch runs under a :class:`..resilience.DispatchSupervisor`:
transient device errors retry under the :class:`..resilience.RetryPolicy`
and, with ``dispatch_timeout_s``, a wall-clock deadline abandons a wedged
dispatch (the result fetch moves inside it). A dispatch whose retries are
exhausted or whose deadline expires fails its slice (sequential) or its
batch's slices (parallel), counted and reported; nothing is recomputed
elsewhere — the JAX package's CPU degradation (``_fallback_call``) is not
ported. A :class:`..resilience.FaultPlan` (the
``fault_plan`` of the :class:`..resilience.ResilienceConfig`, or
``NM03_FAULT_PLAN``) fires at the JAX drivers' sites with their selectors:
``decode`` (patient, stem, slice index), ``dispatch`` (patient, slice or
batch index), ``export`` (patient, stem) and ``ingest`` (the work-item
index); the same plan fails the same slices in both packages.

The pipeline runs on ``device`` (``cuda`` unless the caller asks for the
CPU). With more than one local device (:func:`..parallel.mesh.local_devices`)
the parallel strategy splits each batch over a ``data`` mesh of them
(:func:`..parallel.process_batch_sharded`), as the JAX runner does; one
device keeps the plain batch path. In a multi-process job
(``process_count`` > 1) this process owns ``patients[rank::count]`` and
its own ``manifest.rank{rank}.json``, and runs on its one device (one
process a device, torchrun's idiom). Neither strategy synchronizes the
host between enqueue and fetch: the kernel wrappers never do, so the card
runs ahead of the host.

Observability follows the JAX drivers: the span recorder is the run
context's, so every section feeds the stage latency histograms; a
:class:`..obs.saturation.PhaseAccountant` records the decode, stage,
dispatch, fetch and export busy intervals for the results JSON's
``feed_stall``; each patient ends in one ``patient_outcome`` record, and
a capped region growing in a ``grow_truncated`` one.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig
from nm03_capstone_project_tpu_torch.core.backend import resolve_device
from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom
from nm03_capstone_project_tpu_torch.data.discovery import (
    find_patient_dirs,
    load_dicom_files_for_patient,
)
from nm03_capstone_project_tpu_torch.ingest import IngestFailure, IngestPipeline
from nm03_capstone_project_tpu_torch.ingest.staging import Stager, wait_staged
from nm03_capstone_project_tpu_torch.obs.metrics import RESILIENCE_RETRIES_TOTAL
from nm03_capstone_project_tpu_torch.obs.run import RunContext
from nm03_capstone_project_tpu_torch.obs.saturation import PhaseAccountant
from nm03_capstone_project_tpu_torch.pipeline import process_batch, process_slice
from nm03_capstone_project_tpu_torch.render.export import (
    clean_directory,
    export_pairs,
    render_export_pairs,
)
from nm03_capstone_project_tpu_torch.render.render import render_pair
from nm03_capstone_project_tpu_torch.resilience import (
    DispatchSupervisor,
    FaultPlan,
    InjectedExportError,
    InjectedTransientError,
    ResilienceConfig,
    corrupt_bytes,
    deliver_sigterm,
    execute_hang,
)
from nm03_capstone_project_tpu_torch.resilience.journal import PatientJournal
from nm03_capstone_project_tpu_torch.utils.manifest import (
    STATUS_DONE,
    STATUS_FAILED,
    STATUS_TRUNCATED,
    Manifest,
)
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("runner")

# concurrent JPEG renders + encodes of one patient: the batches of a
# patient share one export pool, so a slow batch's export never doubles the
# host threads encoding at once
EXPORT_WORKERS = 4


def guard_pixels(
    pixels: np.ndarray, name: str, cfg: PipelineConfig
) -> Optional[np.ndarray]:
    """Dimension guards for one decoded slice; None signals rejection.

    The min-dimension guard (main_sequential.cpp:189-192) and the
    canvas-fit guard."""
    h, w = pixels.shape
    if h < cfg.min_dim or w < cfg.min_dim:
        # reference: "Image dimensions too small" (main_sequential.cpp:189-192)
        log.warning("image dimensions too small: %dx%d (%s)", w, h, name)
        return None
    if h > cfg.canvas or w > cfg.canvas:
        log.warning(
            "slice %s (%dx%d) exceeds canvas %d; raise --canvas",
            name, w, h, cfg.canvas,
        )
        return None
    return pixels


def decode_and_guard(path: Path, cfg: PipelineConfig) -> Optional[np.ndarray]:
    """Decode + guard one slice; None signals failure (null-ptr analog).

    The single home of the per-slice containment contract: broad catch on
    decode (the reference skips unreadable images and continues,
    main_sequential.cpp:288-294) plus :func:`guard_pixels`.
    """
    try:
        s = read_dicom(path)
    except Exception as e:  # noqa: BLE001 - per-slice containment
        log.warning("failed to read %s: %s", path.name, e)
        return None
    return guard_pixels(s.pixels, path.name, cfg)


def _student_batch_mask(model, pixels: torch.Tensor, dims: torch.Tensor, cfg: PipelineConfig):
    """The distilled U-Net standing in for everything downstream of
    normalize+clip: (B, H, W) pixels and (B, 2) dims -> (B, H, W) uint8
    mask (or (B, D, H, W) volumes for the 3D student, each volume's planes
    sharing its dims), the canvas padding zeroed (the student's logits
    there are untrained). bf16 on the card and
    f32 on the CPU, as the JAX package deploys bf16 on its accelerator: the
    output is a > 0 threshold."""
    from nm03_capstone_project_tpu_torch.core.image import valid_mask
    from nm03_capstone_project_tpu_torch.models import predict_mask, prepare_student_inputs

    dtype = torch.bfloat16 if pixels.device.type == "cuda" else torch.float32
    mask = predict_mask(model, prepare_student_inputs(pixels, cfg), dtype)
    valid = valid_mask(dims, tuple(pixels.shape[-2:])).to(mask.dtype)
    if mask.dim() == 4:  # (B, H, W) over each volume's depth
        valid = valid[:, None]
    return mask * valid


def _student_process(model, pixels: torch.Tensor, dims: torch.Tensor, cfg: PipelineConfig):
    """``process_batch``'s output contract from the student: the student has
    no growing fixpoint, so ``grow_converged`` is True for every slice."""
    mask = _student_batch_mask(model, pixels, dims, cfg)
    return {"mask": mask,
            "grow_converged": torch.ones(pixels.shape[0], dtype=torch.bool, device=mask.device)}


@dataclass
class PatientResult:
    patient_id: str
    total: int
    succeeded: int
    failed_slices: List[str] = field(default_factory=list)
    # slices whose region-growing fixpoint hit its iteration cap: the pair
    # was exported but the mask under-covers the connected set
    truncated_slices: List[str] = field(default_factory=list)


@dataclass
class RunSummary:
    patients: List[PatientResult] = field(default_factory=list)
    patients_ok: int = 0

    @property
    def total_slices(self) -> int:
        return sum(p.total for p in self.patients)

    @property
    def succeeded_slices(self) -> int:
        return sum(p.succeeded for p in self.patients)

    @property
    def truncated_slices(self) -> int:
        return sum(len(p.truncated_slices) for p in self.patients)

    def as_dict(self) -> dict:
        return {
            "patients_ok": self.patients_ok,
            "patients_total": len(self.patients),
            "slices_ok": self.succeeded_slices,
            "slices_total": self.total_slices,
            "slices_truncated": self.truncated_slices,
            "per_patient": {
                p.patient_id: {
                    "ok": p.succeeded,
                    "total": p.total,
                    "truncated": len(p.truncated_slices),
                }
                for p in self.patients
            },
        }


class CohortProcessor:
    """Drives the full cohort with either execution strategy.

    ``mask_sink(patient_id, stem, mask)`` is called for every slice whose
    mask reaches the host, in both render stages; in parallel mode it fires
    on IO-pool threads, so it must be thread-safe. ``model``, a 2D student
    (:func:`..cli.common.load_model_checkpoint`), replaces the pipeline.
    ``obs`` (a :class:`..obs.RunContext`; a sink-less one by default)
    receives the retry and fault-injection records, ``resilience`` the
    retry, deadline and fault-plan knobs.
    """

    def __init__(
        self,
        base_path,
        out_root,
        cfg: PipelineConfig = PipelineConfig(),
        batch_cfg: BatchConfig = BatchConfig(),
        mode: str = "sequential",
        resume: bool = False,
        mask_sink=None,
        device=None,
        model=None,
        obs: Optional[RunContext] = None,
        resilience: Optional[ResilienceConfig] = None,
        process_rank: int = 0,
        process_count: int = 1,
    ):
        if mode not in ("sequential", "parallel"):
            raise ValueError(f"unknown mode: {mode}")
        if not 0 <= process_rank < process_count:
            raise ValueError(f"process_rank {process_rank} outside [0, {process_count})")
        # multi-process job: this process owns patients[rank::count] and its
        # own manifest file (the output root is a shared file system)
        self.process_rank = process_rank
        self.process_count = process_count
        self.device = resolve_device(device)
        self.model = None if model is None else model.to(self.device)
        self._replicas: Dict[str, object] = {}  # the student's copy a mesh device
        self.base_path = Path(base_path)
        self.out_root = Path(out_root)
        self.cfg = cfg
        self.batch_cfg = batch_cfg
        self.mode = mode
        self.resume = resume
        self.mask_sink = mask_sink
        # one drained stats snapshot per patient pipeline, for the run's
        # ``ingest`` aggregate
        self._ingest_reports: List[dict] = []
        # observability: the driver's flag-configured context, or a
        # sink-less one. ``timer`` is its span recorder, so every section
        # also feeds the per-stage latency histograms
        self.obs = obs if obs is not None else RunContext.create(driver=mode)
        self.timer = self.obs.spans
        # feed-phase accounting: both strategies record decode, stage,
        # dispatch, fetch and export busy intervals. The "dispatch" interval
        # spans enqueue -> fetch complete (an upper bound on device busy,
        # so the reported stall is a lower bound)
        self.feed = PhaseAccountant()
        # resilience: the retry policy, the dispatch deadline and the fault
        # plan (defaults: no deadline, no plan unless NM03_FAULT_PLAN names
        # one, transient device errors retried)
        self.res = resilience if resilience is not None else ResilienceConfig()
        plan = self.res.fault_plan
        self.fault_plan = (
            FaultPlan.from_spec(plan) if plan is not None else FaultPlan.from_env()
        )
        self.retry = self.res.make_retry_policy(
            seed=self.fault_plan.seed if self.fault_plan is not None else 0
        )
        self.retry.obs = self.obs
        self.dispatch = DispatchSupervisor(self.res, retry=self.retry, obs=self.obs)
        self.out_root.mkdir(parents=True, exist_ok=True)
        manifest_name = (
            "manifest.json" if process_count == 1 else f"manifest.rank{process_rank}.json"
        )
        if resume:
            from nm03_capstone_project_tpu_torch.cli.common import warn_resume_topology

            warn_resume_topology(self.out_root, process_count, log.warning)
        self.manifest = (
            Manifest.load_or_create(self.out_root, manifest_name)
            if resume else Manifest(self.out_root, manifest_name)
        )

    # -- patient processing ------------------------------------------------

    def process_patient(self, patient_id: str) -> PatientResult:
        print(f"\n=== Processing Patient: {patient_id} ===\n")
        out_dir = self.out_root / patient_id
        if not self.resume:
            clean_directory(out_dir)
        files = load_dicom_files_for_patient(self.base_path, patient_id)
        print(f"Found {len(files)} DICOM files for patient {patient_id}")

        # slice-grain crash-safe resume: the journal records each completed
        # slice the moment its pair is on disk (the manifest flushes only per
        # patient). On --resume, fold the interrupted patient's journal back
        # into the manifest before computing the todo list.
        journal = PatientJournal(out_dir)
        if self.resume:
            seen = self.manifest.data.get(patient_id, {})
            for stem, status in journal.entries().items():
                if stem not in seen:
                    self.manifest.record(patient_id, stem, status)

        todo = []
        already = 0
        for f in files:
            if self.resume and self.manifest.is_done(patient_id, f.stem):
                already += 1
            else:
                todo.append(f)

        run = self._run_sequential if self.mode == "sequential" else self._run_parallel
        try:
            ok, failed, truncated = run(patient_id, out_dir, todo, journal)
        finally:
            journal.close()

        result = PatientResult(
            patient_id=patient_id,
            total=len(files),
            succeeded=ok + already,
            failed_slices=failed,
            truncated_slices=truncated,
        )
        if truncated:
            log.warning(
                "patient %s: %d slice(s) hit the region-growing iteration "
                "cap; masks under-cover (raise --grow-max-iters): %s",
                patient_id, len(truncated), ", ".join(truncated[:8]),
            )
            try:
                self.obs.grow_truncated(
                    patient_id, count=len(truncated), slices=truncated[:16]
                )
            except Exception as e:  # noqa: BLE001 — telemetry never costs a run
                log.warning("patient %s: truncation telemetry failed: %s", patient_id, e)
        self.manifest.flush()
        print(
            f"\nPatient {patient_id} completed. Successfully processed "
            f"{result.succeeded}/{result.total} images."
        )
        return result

    def _record(self, patient_id: str, journal, stem: str, status: str) -> None:
        self.manifest.record(patient_id, stem, status)
        journal.record(stem, status)

    # -- data loading and the fault plan's hooks ----------------------------

    def _read_slice(
        self, path: Path, patient: Optional[str] = None, index: Optional[int] = None
    ) -> Optional[np.ndarray]:
        """Decode + guard one slice; None signals failure (null-ptr analog).

        The decode-site chaos hook lives here: an ``error`` rule fails the
        slice before decode; a ``corrupt`` rule feeds the REAL parser
        deterministically corrupted file bytes, exercising the actual
        rejection path rather than a mock.
        """
        plan = self.fault_plan
        if plan is not None and plan.has_site("decode"):
            rule = plan.fire("decode", obs=self.obs, patient=patient, stem=path.stem,
                             index=index)
            if rule is not None:
                if rule.kind == "error":
                    log.warning("failed to read %s: injected decode fault", path.name)
                    return None
                from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom_bytes

                try:  # kind == "corrupt"
                    s = read_dicom_bytes(corrupt_bytes(path.read_bytes(), plan.seed, path.stem))
                except Exception as e:  # noqa: BLE001 - per-slice containment
                    log.warning("failed to read %s: %s", path.name, e)
                    return None
                return guard_pixels(s.pixels, path.name, self.cfg)
        return decode_and_guard(path, self.cfg)

    def _dispatch_pre(self, patient_id: str, index: int):
        """Dispatch-site fault hook for the supervisor (None when off)."""
        plan = self.fault_plan
        if plan is None or not plan.has_site("dispatch"):
            return None

        def pre(cancel):
            rule = plan.fire("dispatch", obs=self.obs, patient=patient_id, index=index)
            if rule is None:
                return
            if rule.kind == "hang":
                execute_hang(rule, cancel)
            else:  # transient
                raise InjectedTransientError(
                    f"injected transient device error (patient {patient_id}, dispatch {index})"
                )

        return pre

    def _export_fault_hook(self, patient_id: str):
        """Export-site fault hook threaded into the export layer."""
        plan = self.fault_plan
        if plan is None or not plan.has_site("export"):
            return None

        def hook(stem):
            rule = plan.fire("export", obs=self.obs, patient=patient_id, stem=stem)
            if rule is None:
                return
            if rule.kind == "sigterm":
                deliver_sigterm()
            raise InjectedExportError(f"injected export fault for {stem}")

        return hook

    def _supervised(self, enqueue, patient_id: str, index: int):
        """Run one device dispatch under the supervisor.

        ``enqueue()`` returns the step's device tensors. Unsupervised it
        only enqueues (the fetch stays on the export path, overlapped with
        the next dispatch); with a dispatch deadline the fetch moves inside
        it, since a wedged fetch is the same wedge as a wedged dispatch.
        """
        if self.dispatch.supervised:
            def primary():
                out = enqueue()
                return {k: (v.cpu() if isinstance(v, torch.Tensor) else
                            tuple(t.cpu() for t in v) if isinstance(v, tuple) else v)
                        for k, v in out.items()}
        else:
            primary = enqueue
        return self.dispatch.run(primary, pre=self._dispatch_pre(patient_id, index))

    def _run_sequential(
        self, patient_id: str, out_dir: Path, files: List[Path], journal
    ) -> Tuple[int, List[str], List[str]]:
        host_render = self.batch_cfg.render_stage == "host"
        ok, failed, truncated = 0, [], []
        export_fault = self._export_fault_hook(patient_id)

        # One slice at a time with ONE in flight: slice N+1 is enqueued on
        # the card before slice N's result is fetched and exported.
        # Processing and export stay strictly in slice order with per-slice
        # containment: the reference's sequential contract
        # (main_sequential.cpp:170-272) is about order and interleaving, not
        # about stalling the card between slices. "compute" therefore times
        # the enqueue; the device wait lands in the fetch inside "export".
        def resolve(p) -> None:
            nonlocal ok
            stem = p["stem"]
            try:
                if "error" in p:
                    raise p["error"]
                with self.timer.section("export"):
                    with self.feed.busy("fetch"):
                        mask = p["mask_dev"].cpu().numpy()  # waits for the card
                        if not host_render:
                            gray, seg = (t.cpu().numpy() for t in p["render_dev"])
                    self.feed.record("dispatch", p["t_disp0"], time.monotonic())
                    if self.mask_sink is not None:
                        self.mask_sink(patient_id, stem, mask)
                    with self.feed.busy("export"):
                        if host_render:
                            written = render_export_pairs(
                                [(stem, p["padded"], mask, p["dims"])],
                                out_dir, self.cfg, max_workers=1,
                                fault_hook=export_fault, retry=self.retry,
                            )
                        else:
                            written = export_pairs([(stem, gray, seg)], out_dir,
                                                   max_workers=1, fault_hook=export_fault,
                                                   retry=self.retry)
                if stem not in written:
                    raise IOError("JPEG export failed")
                # after the export check: truncated means "the pair exists
                # but the mask under-covers"; its own manifest status makes a
                # --resume rerun with a raised cap recompute it
                if not bool(p["conv"]):
                    truncated.append(stem)
                    status = STATUS_TRUNCATED
                else:
                    status = STATUS_DONE
                self._record(patient_id, journal, stem, status)
                ok += 1
            except Exception as e:  # noqa: BLE001 - reference: don't throw
                log.warning("error processing file %s: %s", stem, e)
                self._record(patient_id, journal, stem, STATUS_FAILED)
                failed.append(stem)

        def decode_one(job):
            di, f = job
            pixels = self._read_slice(f, patient=patient_id, index=di)
            if pixels is None:
                raise ValueError("decode/guard failed")
            padded, dims = self._pad_one(pixels)
            return {"stem": f.stem, "index": di, "pixels": padded, "dims": dims}

        pending = None
        pipe = self._ingest_pipeline(list(enumerate(files)), decode_one, patient_id)
        with pipe:
            for rec in pipe:
                if isinstance(rec, IngestFailure):
                    # resolved after the previous slice: failure handling
                    # stays in slice order
                    cur = {"stem": rec.item[1].stem, "error": rec.error}
                else:
                    cur = self._dispatch_slice(rec, host_render, patient_id)
                if pending is not None:
                    resolve(pending)
                pending = cur
            if pending is not None:
                resolve(pending)
        self._note_ingest(pipe)
        return ok, failed, truncated

    def _dispatch_slice(self, rec: dict, host_render: bool, patient_id: str) -> dict:
        """Enqueue one staged slice on the card, under the supervisor; its
        results stay there unless a dispatch deadline fetched them."""
        stem = rec["stem"]

        def enqueue():
            if self.model is not None:
                out = _student_process(self.model, rec["pixels"][None], rec["dims"][None],
                                       self.cfg)
                out = {k: v[0] for k, v in out.items()}
            else:
                out = process_slice(rec["pixels"], rec["dims"], self.cfg, device=self.device)
            if not host_render:
                out["render"] = render_pair(rec["pixels"], out["mask"], rec["dims"], self.cfg)
            return out

        try:
            with self.timer.section("compute"):
                wait_staged(rec)
                t_disp0 = time.monotonic()
                out = self._supervised(enqueue, patient_id, rec["index"])
            cur = {
                "stem": stem, "mask_dev": out["mask"], "conv": out["grow_converged"],
                "padded": rec["pixels_host"], "dims": rec["dims_host"],
                "t_disp0": t_disp0,
            }
            if not host_render:
                cur["render_dev"] = out["render"]
            return cur
        except Exception as e:  # noqa: BLE001 - reference: don't throw
            return {"stem": stem, "error": e}

    def _data_mesh(self):
        """A ``data`` mesh of the local devices, or None on one device.

        Local, not global: in a multi-process job each rank owns disjoint
        patients and runs on its own device, so nothing crosses processes
        but the final counters."""
        from nm03_capstone_project_tpu_torch.parallel.mesh import local_devices_from, make_mesh

        if self.process_count > 1:
            return None
        # the mesh starts at this run's device: the outputs gather on its
        # first entry, where the device render and the fetch expect them
        devs = local_devices_from(self.device)
        if len(devs) <= 1:
            return None
        return make_mesh(axis_names=("data",), devices=devs)

    def _student_replica(self, device: torch.device):
        """The student on ``device``: the run's own copy there, else one
        copy a distinct device, made once."""
        key = str(device)
        if key not in self._replicas:
            here = next(self.model.parameters()).device
            self._replicas[key] = (self.model if device == here
                                   else copy.deepcopy(self.model).to(device))
        return self._replicas[key]

    def _student_sharded(self, pixels, dims, mesh) -> Dict[str, torch.Tensor]:
        """The student over the ``data`` mesh, the chunks gathered on its
        first device (the run's)."""
        from nm03_capstone_project_tpu_torch.parallel import map_batch_sharded

        return map_batch_sharded(
            lambda dev, px, dm: _student_process(self._student_replica(dev), px, dm, self.cfg),
            pixels, dims, mesh)

    def _run_parallel(
        self, patient_id: str, out_dir: Path, files: List[Path], journal
    ) -> Tuple[int, List[str], List[str]]:
        host_render = self.batch_cfg.render_stage == "host"
        bs = self.batch_cfg.batch_size
        mesh = self._data_mesh()
        if mesh is not None:
            from nm03_capstone_project_tpu_torch.parallel import (
                pad_to_multiple,
                process_batch_sharded,
            )

            # mesh-aligned batches: a full batch splits evenly, and a short
            # one is padded with filler slices (pad_to_multiple) at staging
            n_dev = mesh.shape["data"]
            bs = max(n_dev, (bs // n_dev) * n_dev)
        ok, failed = 0, []
        # written from IO-pool threads (dict ops are atomic under the GIL);
        # resolved against `written` at the end so a slice whose export
        # fails is counted failed, never truncated
        conv_by_stem: Dict[str, bool] = {}
        batches = [files[i : i + bs] for i in range(0, len(files), bs)]
        export_futures = []
        expected_stems: List[str] = []
        export_fault = self._export_fault_hook(patient_id)
        from nm03_capstone_project_tpu_torch import native

        use_native = self.batch_cfg.use_native and native.available()
        # decode concurrency: up to `ingest_decode_workers` batches in flight
        # on the ingest pool; each batch's slice decode splits the io_workers
        # budget (_decode_thread_split is the one formula)
        inner_threads = self._decode_thread_split(len(batches))

        def decode_batch(job):
            """(batch index, files) -> decoded host batch of the good slices."""
            bi, batch_files = job
            idx0 = bi * bs
            if use_native:
                return self._decode_batch_native(batch_files, patient_id, idx0,
                                                 threads=inner_threads)
            if inner_threads > 1 and len(batch_files) > 1:
                with cf.ThreadPoolExecutor(inner_threads) as slice_pool:
                    decoded = list(slice_pool.map(
                        lambda jf: self._read_slice(jf[1], patient_id, idx0 + jf[0]),
                        enumerate(batch_files),
                    ))
            else:
                decoded = [self._read_slice(f, patient_id, idx0 + j)
                           for j, f in enumerate(batch_files)]
            stems = [f.stem for f in batch_files]
            good = [(s, p) for s, p in zip(stems, decoded) if p is not None]
            bad = [s for s, p in zip(stems, decoded) if p is None]
            if not good:
                return {"stems": [], "bad": bad, "pixels": None, "dims": None}
            pixels, dims = self._stack([p for _, p in good])
            return {"stems": [s for s, _ in good], "bad": bad, "pixels": pixels, "dims": dims}

        def decode_mesh_batch(job):
            batch = decode_batch(job)
            if batch["pixels"] is not None:
                batch["pixels"], batch["dims"], _ = pad_to_multiple(
                    batch["pixels"], batch["dims"], n_dev)
            return batch

        def journal_slice(stem):
            # slice-grain crash record the moment the pair is on disk (from
            # the export pool threads; the journal is thread-safe)
            journal.record(
                stem, STATUS_DONE if conv_by_stem.get(stem, True) else STATUS_TRUNCATED
            )

        def fetch_export(batch, mask_dev, conv_dev, render_dev, t_disp0):
            """On the ingest pool: fetch, render (host stage) and write."""
            with self.feed.busy("fetch"):
                mask_b = mask_dev.cpu().numpy()
                conv_b = conv_dev.cpu().numpy()
                if render_dev is not None:
                    gray_b, seg_b = (t.cpu().numpy() for t in render_dev)
            self.feed.record("dispatch", t_disp0, time.monotonic())
            for i, s in enumerate(batch["stems"]):
                conv_by_stem[s] = bool(conv_b[i])
            if self.mask_sink is not None:
                for i, s in enumerate(batch["stems"]):
                    self.mask_sink(patient_id, s, mask_b[i])
            with self.feed.busy("export"):
                if render_dev is None:
                    items = [
                        (s, batch["pixels_host"][i], mask_b[i], batch["dims_host"][i])
                        for i, s in enumerate(batch["stems"])
                    ]
                    return render_export_pairs(
                        items, out_dir, self.cfg, fault_hook=export_fault, retry=self.retry,
                        success_hook=journal_slice, pool=export_pool,
                    )
                items = [(s, gray_b[i], seg_b[i]) for i, s in enumerate(batch["stems"])]
                return export_pairs(items, out_dir, fault_hook=export_fault, retry=self.retry,
                                    success_hook=journal_slice, pool=export_pool)

        # the decode pool runs batches ahead into the bounded staging ring;
        # the stager copies batch N+1 to the card while batch N computes;
        # result fetch + export stream back on the same pool
        pipe = self._ingest_pipeline(
            list(enumerate(batches)),
            decode_batch if mesh is None else decode_mesh_batch,
            patient_id,
        )
        export_pool = cf.ThreadPoolExecutor(EXPORT_WORKERS, thread_name_prefix="nm03-export")
        with pipe, export_pool:
            for bi, batch in enumerate(pipe):
                if isinstance(batch, IngestFailure):
                    # a whole-batch decode failure: every slice of the batch
                    # is counted failed, never propagated
                    _, batch_files = batch.item
                    log.warning(
                        "ingest decode failed for batch %d: %s", batch.index, batch.error
                    )
                    for f in batch_files:
                        failed.append(f.stem)
                        self._record(patient_id, journal, f.stem, STATUS_FAILED)
                    continue
                for s in batch["bad"]:
                    failed.append(s)
                    self._record(patient_id, journal, s, STATUS_FAILED)
                if not batch["stems"]:
                    continue

                def enqueue(batch=batch):
                    if self.model is not None and mesh is not None:
                        out = self._student_sharded(batch["pixels"], batch["dims"], mesh)
                    elif self.model is not None:
                        out = _student_process(
                            self.model, batch["pixels"], batch["dims"], self.cfg
                        )
                    elif mesh is not None:
                        # the canvas mask over the mesh; a device render
                        # runs on this process's device from it
                        out = process_batch_sharded(
                            batch["pixels"], batch["dims"], self.cfg, mesh, mask_only=True
                        )
                    else:
                        out = process_batch(
                            batch["pixels"], batch["dims"], self.cfg, device=self.device
                        )
                    if not host_render:
                        out["render"] = render_pair(
                            batch["pixels"], out["mask"], batch["dims"], self.cfg
                        )
                    return out

                try:
                    # unsupervised: enqueue only, the fetch on the IO pool is
                    # the batch's sync, overlapped with the next batch's compute
                    with self.timer.section("dispatch"):
                        wait_staged(batch)
                        t_disp0 = time.monotonic()
                        out = self._supervised(enqueue, patient_id, bi)
                except Exception as e:  # noqa: BLE001 - a failed batch, counted
                    log.warning("batch of %s failed on the device: %s",
                                ", ".join(batch["stems"]), e)
                    for s in batch["stems"]:
                        failed.append(s)
                        self._record(patient_id, journal, s, STATUS_FAILED)
                    continue
                export_futures.append(
                    (batch["stems"], pipe.submit(
                        fetch_export, batch, out["mask"], out["grow_converged"],
                        out.get("render"), t_disp0,
                    ))
                )
                expected_stems.extend(batch["stems"])
            with self.timer.section("export"):
                written = set()
                for stems, fut in export_futures:
                    try:
                        written.update(fut.result())
                    except Exception as e:  # noqa: BLE001 - its slices count failed
                        log.warning("fetch/export of %s failed: %s", ", ".join(stems), e)
        self._note_ingest(pipe)
        # success is "the JPEG pair exists", not "compute finished"
        truncated: List[str] = []
        for s in expected_stems:
            if s in written:
                ok += 1
                if not conv_by_stem.get(s, True):
                    truncated.append(s)
                    self.manifest.record(patient_id, s, STATUS_TRUNCATED)
                else:
                    self.manifest.record(patient_id, s, STATUS_DONE)
            else:
                log.warning("export failed for slice %s", s)
                self._record(patient_id, journal, s, STATUS_FAILED)
                failed.append(s)
        return ok, failed, truncated

    def _decode_batch_native(
        self,
        batch_files: List[Path],
        patient_id: Optional[str] = None,
        base_index: int = 0,
        threads: Optional[int] = None,
    ) -> dict:
        """Decode one batch with the C++ thread-pool loader.

        Same output contract as the Python path in ``_run_parallel``: the
        good slices stacked in order, failed stems in ``bad``. Files the C++
        parser cannot read (baseline JPEG, for one) are decoded again by the
        Python reader, whose envelope is a superset of the C++ parser's: a
        per-file alternate decoder, not a retry of a failure (counted as the
        JAX package counts it, ``resilience_retries_total{cause=
        "native_parse"}``, outside any retry budget). Files a decode-site
        fault rule selects are decoded again through :meth:`_read_slice`,
        where the injection happens (the selector probe has no side effect).
        """
        from nm03_capstone_project_tpu_torch import native

        if threads is None:
            threads = self._decode_thread_split(1)
        pixels, dims, okf, errs = native.load_batch_native(
            batch_files, canvas=self.cfg.canvas, min_dim=self.cfg.min_dim, threads=threads
        )
        retry_idx = [
            i for i, (o, e) in enumerate(zip(okf, errs))
            if not o and int(e) == 2  # "DICOM parse failed"
        ]
        if retry_idx:
            self.obs.registry.counter(
                RESILIENCE_RETRIES_TOTAL,
                help="supervised retries by cause (resilience.RetryPolicy)",
                cause="native_parse",
            ).inc(len(retry_idx))
            with cf.ThreadPoolExecutor(min(threads, len(retry_idx))) as pool:
                retried = pool.map(
                    lambda i: decode_and_guard(batch_files[i], self.cfg), retry_idx
                )
            for i, px in zip(retry_idx, retried):
                if px is not None:
                    h, w = px.shape
                    pixels[i] = 0.0  # the slot may hold a partial native write
                    pixels[i, :h, :w] = px
                    dims[i] = (h, w)
                    okf[i] = True
        injected_bad: set = set()
        plan = self.fault_plan
        if plan is not None and plan.has_site("decode"):
            for i, f in enumerate(batch_files):
                if plan.routes_decode(patient=patient_id, stem=f.stem, index=base_index + i):
                    px = self._read_slice(f, patient=patient_id, index=base_index + i)
                    if px is None:
                        okf[i] = False
                        injected_bad.add(f.stem)
                    else:
                        h, w = px.shape
                        pixels[i] = 0.0
                        pixels[i, :h, :w] = px
                        dims[i] = (h, w)
                        okf[i] = True
        stems = [f.stem for f in batch_files]
        bad = [s for s, o in zip(stems, okf) if not o]
        for f, o, e in zip(batch_files, okf, errs):
            if not o and f.stem not in injected_bad:  # _read_slice logged those
                log.warning(
                    "failed to decode %s: %s",
                    f.name, native.BATCH_ERRORS.get(int(e), f"error {e}"),
                )
        idx = np.flatnonzero(okf)
        if idx.size == 0:
            return {"stems": [], "bad": bad, "pixels": None, "dims": None}
        if idx.size == len(batch_files):  # all ok: the arena is already in shape
            return {"stems": stems, "bad": [], "pixels": pixels, "dims": dims}
        return {
            "stems": [stems[i] for i in idx],
            "bad": bad,
            "pixels": pixels[idx],
            "dims": dims[idx],
        }

    # -- padding helpers ---------------------------------------------------

    def _pad_one(self, pixels: np.ndarray):
        c = self.cfg.canvas
        out = np.zeros((c, c), np.float32)
        out[: pixels.shape[0], : pixels.shape[1]] = pixels
        return out, np.asarray(pixels.shape, np.int32)

    def _stack(self, arrays: List[np.ndarray]):
        """Stack the real slices, each padded to the canvas.

        Unlike the JAX package, whose ``_pad_stack`` pads every batch to a
        multiple of 8 so that one jitted program serves all sizes, nothing
        is padded in the batch axis: eager PyTorch compiles nothing per
        shape, and blank slices would only run through the kernels.
        """
        c = self.cfg.canvas
        out = np.zeros((len(arrays), c, c), np.float32)
        dims = np.zeros((len(arrays), 2), np.int32)
        for i, a in enumerate(arrays):
            out[i, : a.shape[0], : a.shape[1]] = a
            dims[i] = a.shape
        return out, dims

    # -- streaming ingest --------------------------------------------------

    def _decode_thread_split(self, n_batches: int) -> int:
        """Per-batch decode thread budget: io_workers divided by how many
        batches can decode at once (the ingest pool's bound, clamped by the
        patient's batch count). The one formula for both the Python slice
        pool and the C++ loader."""
        workers = max(1, self.batch_cfg.ingest_decode_workers or self.batch_cfg.io_workers)
        concurrent = max(1, min(workers, max(n_batches, 1)))
        return max(1, self.batch_cfg.io_workers // concurrent)

    def _ingest_pipeline(self, source, decode, patient_id: str) -> IngestPipeline:
        """One host→device pipeline per patient run: ring depth and decode
        pool from BatchConfig, the stager on this thread's stream, the fault
        plan's ``ingest`` site keyed by the patient."""
        workers = self.batch_cfg.ingest_decode_workers or self.batch_cfg.io_workers
        stager = Stager(self.device)

        def stage(item):
            return item if item.get("pixels") is None else stager(item)

        return IngestPipeline(
            source=source,
            decode=decode,
            stage=stage,
            depth=max(self.batch_cfg.ingest_depth, 1),
            decode_workers=max(workers, 1),
            staged_depth=max(self.batch_cfg.prefetch_depth, 1),
            feed=self.feed,
            spans=self.timer,
            obs=self.obs,
            fault_plan=self.fault_plan,
            fault_patient=patient_id,
        )

    def _note_ingest(self, pipe: IngestPipeline) -> None:
        """Keep one pipeline's drained snapshot and refresh the live
        ``ingest_*`` gauges. Telemetry never costs a run."""
        try:
            self._ingest_reports.append(pipe.publish(self.obs.registry))
        except Exception as e:  # noqa: BLE001 — telemetry never costs a run
            log.warning("ingest telemetry failed: %s", e)

    def ingest_report(self) -> Optional[dict]:
        """Run-level aggregate of the per-patient pipeline snapshots (the
        ``ingest`` record of the drivers' results JSON)."""
        reps = self._ingest_reports
        if not reps:
            return None
        counts: Dict[str, int] = {}
        for r in reps:
            for k, v in r["counts"].items():
                counts[k] = counts.get(k, 0) + v
        weighted = [
            r for r in reps if r["upload_overlap_ratio"] is not None and r["upload_s"] > 0
        ]
        up_s = sum(r["upload_s"] for r in weighted)
        overlap = (
            round(sum(r["upload_overlap_ratio"] * r["upload_s"] for r in weighted) / up_s, 4)
            if up_s > 0
            else None
        )
        return {
            "patients": len(reps),
            "ring_capacity": reps[-1]["ring"]["capacity"],
            "ring_peak": max(r["ring"]["peak"] for r in reps),
            "ring_occupancy_ratio": round(
                sum(r["ring"]["occupancy_ratio"] for r in reps) / len(reps), 4
            ),
            "decode_queue_peak": max(r["decode_queue_peak"] for r in reps),
            "upload_s": round(sum(r["upload_s"] for r in reps), 4),
            "upload_overlap_ratio": overlap,
            "counts": counts,
        }

    def publish_ingest(self) -> Optional[dict]:
        """The drained-at-exit gauge refresh (the drivers call it before the
        final metrics snapshot): occupancy = mean over patient pipelines,
        queue depth = the run's decode-lookahead high-water mark, overlap =
        upload-weighted mean."""
        rep = self.ingest_report()
        if rep is None:
            return None
        from nm03_capstone_project_tpu_torch.ingest.pipeline import publish_gauges

        publish_gauges(
            self.obs.registry,
            occupancy=rep["ring_occupancy_ratio"],
            queue_depth=rep["decode_queue_peak"],
            overlap=rep["upload_overlap_ratio"],
        )
        return rep

    # -- cohort loop -------------------------------------------------------

    def _emit_outcome(self, pid: str, status: str, **fields) -> None:
        """Terminal patient telemetry; never raises into the cohort loop."""
        try:
            if not self.obs.has_outcome(pid):
                self.obs.patient_outcome(pid, status, **fields)
        except Exception as e:  # noqa: BLE001 — telemetry never costs a run
            log.warning("patient %s: outcome telemetry failed: %s", pid, e)

    def process_all_patients(self) -> RunSummary:
        mode_name = self.mode.capitalize()
        print(f"\n=== Starting {mode_name} Processing for All Patients ===\n")
        patients = find_patient_dirs(self.base_path)
        print(f"Found {len(patients)} patient directories.")
        from nm03_capstone_project_tpu_torch.cli.common import shard_patients

        patients = shard_patients(patients, self.process_rank, self.process_count)
        summary = RunSummary()
        if not patients:
            print("No patient directories found. Exiting.")
            return summary
        for pid in patients:
            try:
                result = self.process_patient(pid)
            except Exception as e:  # noqa: BLE001 - reference: move to next patient
                log.warning("failed to process patient %s: %s", pid, e)
                summary.patients.append(PatientResult(pid, 0, 0))
                self._emit_outcome(pid, "failed", error_class=type(e).__name__)
                continue
            summary.patients.append(result)
            summary.patients_ok += 1
            # outside the containment try: a telemetry failure must never
            # double-count the patient in the summary
            self._emit_outcome(
                pid,
                "ok",
                slices_total=result.total,
                slices_ok=result.succeeded,
                slices_failed=len(result.failed_slices),
                slices_truncated=len(result.truncated_slices),
            )
        print("\n=== All Processing Completed ===\n")
        print(f"Successfully processed {summary.patients_ok}/{len(patients)} patients.")
        return summary


def device_label(device: torch.device) -> str:
    """The card's name, or ``"cpu"``: what a results record ran on."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
