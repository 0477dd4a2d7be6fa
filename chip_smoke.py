#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on the card, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit. Phases, each printing one JSON line:

1. ``build`` — compiles the kernels from ``nm03_capstone_project_tpu_torch/
   csrc`` (nvcc, sm_90a, one process per source), reads the card's name and
   power limit, and prints each kernel's registers and spills as ptxas
   reports them, and the fused kernel's min/max a median for each window.
2. ``median``, ``fused``, ``grow`` — each hand-written kernel against its
   plain PyTorch version on the card, at the main path's shape (25, 256,
   256) and at a prime-sized canvas: the median and the fused kernel
   bitwise for every odd window 3..15 (the fused kernel rounds every step
   as the plain ops do), the grow kernel bitwise in mask, per-slice
   converged and steps, with a truncating ``max_iters`` too, and at
   canvases 512, 1024 and 2048; the fused kernel also bitwise over one long
   study of 160 planes at 512 x 512 in one launch (the volume path's
   shape). Each prints the wrapper's and the plain
   version's median time over repeats (CUDA events), the kernel's own
   device time a launch (``device_ms``, torch.profiler's self device time
   by kernel name; ``device_ms_by`` says ``cuda_events`` where three
   profiler windows in turn missed the kernel's records) and the least
   time the card could take. ``masks`` does the same for the seed/valid and
   finish kernels (``csrc/masks.cu``) on the TCIA batch, a BraTS-sized
   batch of 155 planes and its volume (the 3D finish), each bitwise to the
   torch ops. Every later phase that runs ``process_batch``,
   ``process_volume`` or a served graph under the kernels counts one
   launch of each of the two a call or a replay.
3. ``slice`` — a cohort of 20 patients x 25 slices (the size of the TCIA
   Brain-Tumor-Progression cohort the reference targets) through
   ``process_batch`` in batches of 25, with the kernels and again with the
   plain ops: masks and ``grow_converged`` identical, the first 50 masks
   equal to the golden the JAX package made
   (``nm03_capstone_project_tpu_torch/testdata/smoke_masks.json``), every
   kernel of the path launched. One
   batch with ``fuse_preprocess=False`` drives the standalone median kernel,
   and a batch of phantoms at canvas 1024 goes through ``process_batch``
   with the kernels and with the plain ops, masks equal.
4. ``driver`` — the batch drivers end to end: a synthetic DICOM cohort of
   20 patients x 25 slices at 256 (``data/synthetic.py::
   write_synthetic_cohort``) through ``CohortProcessor(mode="parallel")``:
   decode (the host C++ batch decoder), the pinned copy to the card, the
   fused and grow kernels, host render and JPEG export, manifest. Checks:
   500/500 slices and 1000 JPEG files, a manifest all ``done``, the masks
   equal to ``process_batch`` under the plain ops on the same decoded
   pixels, the first 50 masks and their host renders equal to the golden
   the JAX package made (``testdata/driver_golden.json``), and one patient
   each through ``mode="sequential"``, ``render_stage="device"`` and
   ``fuse_preprocess=False`` (the median kernel) equal to the parallel run
   in masks and JPEG bytes. Then the parallel driver's CLI, ``main()``
   with ``--results-json``, twice with the kernels and twice with
   ``--no-kernels``: a ``driver_throughput`` line with slices/s end to end
   (decode and JPEG export included), the JPEG encoder that ran, the
   kernels' launches and the card's name and power limit. One more CLI run,
   apart from those turns, takes ``--metrics-out --log-json --heartbeat-s 1
   --profile-dir``: its events and snapshot pass ``scripts/
   check_telemetry.py --expect-patients 20``, its results JSON carries
   ``feed_stall`` with a ratio in [0, 1], and its profile names the fused
   and grow kernels (the ``driver`` line's ``telemetry``).
5. ``serve`` — the single-slice server (``serving/server.py``) on the card,
   in process on 127.0.0.1: warmup captures one CUDA graph per batch bucket
   (1, 2, 4, 8, 16), then the driver phase's 500 DICOM files arrive as
   ``POST /v1/segment`` bodies from 16 client threads (under the profiler:
   the device's idle share), 50 of them again one at a time (bucket 1,
   mask only), and 31 of the smoke cohort's non-square phantoms as raw
   float32 bodies in bursts of 1, 2, 4, 8 and 16. Checks: every answer 200,
   each mask equal to the driver's for the same slice and each JPEG pair
   byte-equal to the driver's files, the phantoms' masks equal to
   ``process_batch`` with the plain ops, every bucket replayed, no kernel
   wrapper run outside a graph, ``If-None-Match`` repeats answered 304 and
   plain repeats from the result tier, and a 503 after ``begin_drain``. A
   second server with ``fuse_preprocess=False`` answers 8 requests, so the
   median kernel launches inside its graphs. The line has the statuses,
   the batch-size histogram (by bucket bound), replays and capture seconds
   per bucket, p50/p99 latency and requests/s at concurrency 16 and 1, the
   idle share, the server's own mean request time and queue wait, one
   slice's DICOM decode and render + encode on the host (median of 20), one
   graph replay against eager ``_process`` per bucket (CUDA events, median
   of 20), the kernels' launches from replays and the card's name and power
   limit.
6. ``volume`` — the 3D volume path: the volume driver's CLI
   (``cli/volume.py``, ``main()`` with ``--export-mhd --results-json``)
   over the driver phase's 20 x 25 DICOM cohort, one volume a patient, in
   turns with the kernels and with ``--no-kernels`` (kernels, plain, plain,
   kernels). Checks: 20/20 patients, 500 planes and 1000 JPEG files a run;
   every mask read back from ``mask.mhd`` equal to the golden the JAX
   package made (``testdata/volume_golden.json``: sha256, voxels,
   ``grow_converged``); masks and JPEG bytes equal between the kernels and
   the plain run; the fused kernel launched once a patient, the 3D grow
   kernel (``csrc/grow3d.cu``) once a patient (one cooperative launch runs
   a growth's every block), and the 2D grow kernel never. The cohort holds two
   distinct masks, so four phantom volumes of other shapes go through
   ``process_volume`` with the kernels, each equal to its entry in the
   golden. One patient each with ``--render-stage device``,
   ``--no-preprocess-fuse`` (the median kernel, once) and
   ``--grow-algorithm jump`` (converged) equals the kernels run. Then a
   long phantom study of 160 x 512 x 512 through ``process_volume`` with
   the kernels (one fused launch, one 3D grow launch) and with the
   plain ops, masks and
   ``converged`` equal (the ``fused`` phase also holds the kernel bitwise at
   that shape). The line has volumes/s and slices/s (the results JSON's
   ``wall_s``, median over the turns), the ``timings_s`` shares of a
   kernels run, the device's idle share under the profiler for one kernels
   pass, the 3D growth's time, steps and blocks (run on the card: no host sync)
   for the cohort's median patient and for the long study, the launches
   and the card's name and power limit. One more volume CLI run with the
   telemetry flags passes ``check_telemetry.py --expect-patients 20`` and
   its profile names the fused and the 3D grow kernels; the line's
   ``telemetry``. ``grow3d`` times the 3D grow kernel, held bitwise to the
   plain loop first, on a BraTS-sized 155 x 256 x 256 phantom study and on
   a 25-plane cohort patient: the wrapper's milliseconds (CUDA events
   around calls that wait on nothing), its kernels' device time a call
   (pack, run and unpack;
   taken by the profiler right after the ``grow`` phase, as the envelope's
   are), the plain loop's milliseconds and the floor.
7. ``shard`` — multi-device inference (``parallel/``) on the one card,
   whose meshes name ``cuda:0`` several times (NCCL refuses two ranks on
   one GPU). (a) ``process_volume_zsharded`` over ``[cuda:0] x 4``: the
   cohort's 20 volumes (25 planes padded to 28) and the 160 x 512 x 512
   long study, each equal to ``process_volume`` and the cohort to
   ``volume_golden.json``, also over ``[cuda:0] x 2`` and at ``morph_size``
   5 (two halo planes a boundary), the fused kernel once a slab (and the
   median kernel once a slab under ``fuse_preprocess=False``); the study's
   wall time sharded and unsharded in turns. (b) ``process_batch_sharded``
   over a ``("data",)`` mesh of ``[cuda:0] x 4`` on the 500-slice smoke
   cohort in batches of 100: masks equal to the ``slice`` phase's and to
   ``smoke_masks.json``, one fused and one grow launch a chunk. (c)
   world-of-1 ``--distributed`` runs under NCCL (``--coordinator-address
   127.0.0.1:<free port> --num-processes 1 --process-id 0``): the parallel
   driver's JPEG pairs byte-equal to the ``driver`` phase's, the volume
   driver's (also with ``--z-shard``) JPEG pairs and ``mask.raw`` to the
   ``volume`` phase's, the process group gone between runs; the same
   two drivers through their entry points over four local devices (the
   card named four times): ``nm03-volume --z-shard`` says it z-shards over
   4 local devices and launches the fused kernel four times a volume, the
   parallel driver splits each batch over a 4-entry data mesh (four fused
   and four grow launches a batch), both byte-equal to the ``volume`` and
   ``driver`` phases' files; the parallel driver with ``--model`` (a
   seeded full-width student) over the same four local devices, its files
   byte-equal to a one-device ``--model`` run's; and the process-group
   transport of ``zshard`` in that world of 1 (its ``all_reduce`` and
   ``all_gather`` on the card), also ``process_volume_batch_zsharded`` over
   a ('data', 'z') process-group mesh: the cohort as one (20, 28, 256, 256)
   batch, equal to the in-process form over ``[cuda:0] x 4`` as 2 x 2 and
   to ``volume_golden.json``, one fused launch. (d) the volume gang over
   four lanes on the card (the executor's explicit ``lane_devices``): the
   20 cohort studies as ``POST /v1/segment-volume`` bodies, each answered
   with ``z_shards`` 4 and the golden mask, then a fault plan's death of
   lane 2 mid-volume: the next study answers ``z_shards`` 3, the golden
   mask, the lane quarantined. The line has the times, the launches and
   the card's name and power limit.
8. ``serve_volume`` — whole-study serving: the server (``serving/server.py``
   with ``--volume-serving``, depth buckets 8, 16 and 32; slice buckets 1,
   2, 4, 8 and 16; canvas 256) in process on 127.0.0.1. The main path: the
   driver phase's 20 x 25 DICOM cohort as 20 ``application/x-nm03-dicom-
   parts`` studies (each patient's files as they are on disk) at
   concurrency 1 and again at 4, timed without the profiler, each mask
   (padded 25 -> 32 and cropped back) equal to its ``volume_golden.json``
   entry, one fused launch a study and no grow launch. The same studies
   go to the gang alone (decoded, submitted from 1 and from 4 threads:
   its dispatch span with no HTTP work beside it). Then the golden's
   phantoms of depth 13, 20 and 32 as raw float32 bodies, each equal to
   its entry, and the depth-40 one refused with 413; one study with
   ``?output=mhd``, its header and data equal to the volume CLI's
   ``mask.mhd`` pair; a retry with the same ``X-Nm03-Idempotency-Key``
   and another patient's study, answered from the store with the first's
   ETag and pair and no launch; two identical studies at once (the gang
   gate held until the second has joined the first), one fused launch;
   100 slice requests during 6 studies, all 200 and equal to the driver's
   masks. A second server answers the cohort runs again under the
   profiler (the device's idle share, and the profiler's cost to the
   wall); one study goes through a ``fuse_preprocess=False`` server, one
   median launch. The fused and median kernels are held bitwise to their
   plain versions at the shapes the gang gives them: a cohort study
   padded to the 32-plane bucket and the 13-plane phantom padded to 16.
   The plain merge and sort medians on the card are bitwise equal to the
   pruned one (k = 3, 7, 15). A server started with ``--distributed-init``
   in a world-of-1 job under NCCL (its gang's z-mesh the process group)
   answers the 20 studies again, each the golden, ``/readyz``
   ``volumes.distributed`` true. The line has latency p50/p99 and
   volumes/s at concurrency 1 and 4 (unprofiled and profiled), the
   server's own split of a study (median span milliseconds: queue wait,
   gang wait, dispatch, gather, payload encode), the wall of a served
   study split (``wall_split_ms``: admission wait, staging, the gang's
   program, the mask's fetch, encode, and the rest: decode, reply, HTTP),
   the gang-alone dispatch, one study's host decode and base64 + JSON
   alone, the distributed server's run, the launches and the card's name
   and power limit.
9. ``student`` — the U-Net students (``models/``, ``cli/train.py``) on
   the driver phase's DICOM cohort at the JAX CLI's width (base 16, two
   levels, canvas 256): ``cli.train.main`` distils 256 slices through the
   teacher (the fused and grow kernels, counted) and trains the 2D student
   300 steps in bf16 (the loss must fall below 0.7x its first value, IoU
   against the teacher above 0.6), ``--eval-only --restore`` must give the
   same IoU to 4 decimals, and ``--model-3d --volume-depth 8`` trains the
   3D student 100 steps on 20 volumes (one fused and one 3D grow launch a
   volume for the teacher's labels; the same checks). The trained 2D student's f32 forward on a (25, 256, 256)
   patient on the card, with ``cudnn.allow_tf32`` turned on first, must
   equal the CPU forward within 1e-5 x max |logit|, and the same forward
   with the model's own TF32 guard bypassed must miss that bound (so the
   check can see TF32); its bf16 masks may differ from the f32 ones only
   where |f32 logit| < 2 (where the f32 student is under 88 % sure).
   Then the students deploy: the parallel
   driver's CLI with ``--model`` (500/500 slices and 1000 JPEGs, its
   masks through a ``mask_sink`` with IoU against the driver phase's
   teacher masks above 0.6, no kernel launched) and then without it
   (slices/s of both in one turn), and the volume CLI with the 3D
   student (20/20 patients, 25-plane volumes padded to 28 and cropped
   back, volumes/s, IoU against the volume phase's masks); two patients'
   exported ``mask.mhd`` are held to the same student run on the CPU in
   f32 (``cli.volume._make_student_volume_fn``): equal except where |f32
   logit| < 2, and the CPU masks equal their logits, cropped by hand,
   above 0 inside the valid extent. Last, one
   training step at (256, 256, 256), median of 20 after warmup (CUDA
   events), in bf16 and in f32, beside the least time the convolutions'
   FLOPs need (3 forwards a step) at the card's dense bf16 and float32
   peaks, and one step of each under the profiler (its top kernels).
   Beyond one device, in f32 with TF32 off: ``fit_sharded`` over
   ``[cuda:0] x 4`` as (data, model) = (2, 2) and ``fit_distributed`` in a
   world of 1 under NCCL must follow one device's loss curve from the same
   seeded init (``STUDENT_SHARD_STEPS`` steps at the training rate, every
   loss within ``STUDENT_SHARD_RTOL``), the sharded step timed beside one
   device's; and the
   train driver continues the trained 2D student three ways on the same
   256 slices: on one device, with its local devices patched to
   ``[cuda:0] x 4`` (dp 2 x tp 2), and
   ``--distributed`` in a world of 1 under NCCL (data parallel across the
   job's ranks): the final loss within ``STUDENT_SHARD_RTOL`` and the IoU
   against the teacher within ``STUDENT_SHARD_IOU`` of the one-device
   run, each run's loss moved by more than ``STUDENT_SHARD_RTOL`` (its
   first loss is printed), the teacher's fused and grow kernels once each.
10. ``operate`` — the service on the card under load and under faults, on
   the driver phase's 500 DICOM files. A server (buckets 1-16, the result
   tier on) with a fault plan (``OPERATE_PLAN``: two ``dispatch``/
   ``transient`` fires, one ``dispatch``/``hang`` past a 2 s
   ``dispatch_timeout_s``, one ``cache``/``corrupt_entry``), an SLO
   (availability 99 %, p99 1000 ms) and the device-time ledger's sampler
   (a 200 ms capture every 2 s). A drill of four phantoms one at a time:
   the first retried twice and answered 200, the fourth hung past its
   deadline (504), ``/readyz`` 503 ``degraded`` until the probation probe
   reinstates the one lane, two flight-recorder dumps (the lane's
   quarantine, the degradation); a repeated body read corrupt once
   (recomputed, then a hit). Then the port's loadgen (``serving/loadgen``
   as a library): the cohort as DICOM bodies at concurrency 16, and an open
   loop of 200 at half that rate during which ``GET /debug/profile?ms=100``
   (a 409 while the sampler holds the profiler is retried) must hold the
   fused and grow kernels' names. Checks: every 200's mask equals the
   driver's (the golden's); the ledger's accounts equal the executor's busy
   seconds; the stage shares sum to 1 with ``median7`` and ``grow`` above 0
   (graph replays reach the pie; a pie, a ``/debug/profile`` capture or a
   driver's ``--profile-dir`` trace that missed the kernels is taken
   again, up to ``PROFILE_TRIES``, and the misses are on the line); the
   busy fraction in (0, 1], MFU against
   the H100's 67 TFLOP/s, the padding rows equal to the bucket arithmetic
   of the batch sizes the loadgen saw; the ``slo_*`` gauges present, the
   budget <= 1; every fault, quarantine and reinstatement counted exactly
   once; ``/debug/flightrec`` and ``/debug/result-cache`` 200. The same
   closed loop on a fresh server with the sampler off gives the sampler's
   cost. Last the driver drill: the parallel CLI over the cohort with
   ``DRIVER_DRILL_PLAN`` (decode error and corrupt, two transient
   dispatches, an export I/O error, an ingest decode error) must give
   ``DRIVER_DRILL_COUNTS`` (the CPU's numbers) and export only pairs equal to
   the clean run's; an ``export``/``sigterm`` drill in a subprocess, then
   ``--resume``, ends with JPEG pairs and manifest byte-identical to the
   clean run's. The line has the drill, both loadgen summaries, the stage
   pie, saturation, ledger, HBM table, SLO block, the driver drill's counts,
   the launches and the card's name and power limit.
11. ``fleet`` — three port servers as subprocesses on the one card
   (``python -m nm03_capstone_project_tpu_torch.serving.server``, buckets
   1-16, each with its own CUDA context, graphs and ``--log-json``) behind
   the fleet router (``fleet/router.py``) in this process, with its own
   event log. The first 250 of the driver phase's 500 DICOM files go once
   straight to one replica (the baseline: what the router costs) and once
   through the router at concurrency 16 (the port's loadgen as a library);
   then the SIGKILL drill: once a third of them is answered, one replica is
   frozen (SIGSTOP) for half a second, so requests park on it, and killed.
   Every request answers 200 with the driver's JPEG pair for its slice, the
   router fails requests over and ejects the replica, ``/readyz`` stays 200
   at 2/3 capacity, and every replica answered. The router's stream and
   the three replicas' merge into one Perfetto trace (``obs/trace.py``) with
   a track per replica and the failed-over request's hops; the killed
   replica relaunches on its port (each replica listens below the kernel's
   ephemeral port range, so no connection takes a dead replica's port) and
   is reinstated through one probation canary. The
   fault plan's ``fleet`` rules (``replica_unreachable`` on one replica,
   ``proxy_io_error``) each fire and are counted once, each ejection
   followed by a reinstatement. ``nm03-top --fleet`` (``serving/top.py``)
   shows three rows. Last, ``fleet.manager.rolling_restart`` relaunches
   every replica from its own ``/readyz`` recipe while loadgen rounds run:
   every replica under a new pid, no request failed, routed capacity never
   below 2/3. The replicas' fused, grow and median launches on the main
   path (the fleet run and the drill) come from their own ``/readyz`` and
   ``/metrics`` (graph replays times the launches a graph holds). The line
   has requests/s and p50/p99 direct and through the router, the drill's
   counts, each replica's drain, warm and graph capture seconds, the
   capacity floor, the seconds of each step (``steps_s``), the launches
   and the card's name and power limit.
12. ``lockdep`` — the lock-order witness (``utils/lockdep.py``) on the card:
   under ``lockdep.install()`` a server with four lanes on ``cuda:0``
   (buckets 1 and 4, each lane's own graphs) and the volume gang (depth
   bucket 32) answers 48 of the cohort's DICOM slices at concurrency 8
   while 4 of its studies arrive as ``application/x-nm03-dicom-parts``
   bodies at concurrency 2: every answer 200, each slice mask the driver's,
   each study ``z_shards`` 4 and its ``volume_golden.json`` mask. After the
   drain the witness (``lockdep_witness.json``) gates clean against the
   port's static may-hold graph (``analysis/lockorder.py``), in process and
   through ``python -m nm03_capstone_project_tpu_torch.analysis.gate
   --lockdep-witness`` (which also runs the port's lint): 0 inversions, 0
   cycles, every observed edge explained. The same witness with one edge
   also taken the other way round (ABBA) must fail the gate. The line has
   the edge and site counts, the gate's and the lint's verdicts, the
   launches and the card's name and power limit.
13. ``sanitize`` — ``--sanitize`` (``utils/sanitize.py``) on the card: the
   parallel driver's CLI with ``--sanitize --metrics-out`` over the
   cohort writes JPEG pairs byte-equal to the ``driver`` phase's and a
   manifest byte-equal to its clean CLI run's, with
   ``pipeline_recompiles_total`` 0 after the warm-up and no guard tripped;
   the unfused patient (the median kernel) under a session of its own
   gives the clean run's files. Then the planted hazards: a NaN in the
   pixels of a batch through ``process_batch`` raises naming the stage
   ``extend_edges``; a bucket graph captured after the warm-up counts one
   recompile, replays a clean slice to the driver's mask, and a replay of
   a NaN slice raises at its fetch naming the stage; a CPU tensor handed
   to the sequential runner's guarded dispatch raises naming the site
   ``cli/runner.py::_dispatch_slice``, inline and on a supervised worker
   thread. The line has the sanitized and the clean run's walls, the
   raised errors, the launches and the card's name and power limit.
14. ``compile_cache`` — the kernel-library cache (``compilehub/``,
   ``--compile-cache-dir``) on the card, through port servers started as
   subprocesses (canvas 256, buckets 1 and 4, the result tier on), each
   answering the first 2 slices of ``testdata/driver_golden.json`` as
   DICOM bodies, one at a time: every mask the golden's, every JPEG pair
   the driver phase's, and every start's answers equal to the first's. (1)
   A cold start on an empty directory: 3 misses, 0 hits, the three
   libraries built and published, three entries that verify. (2) A warm
   start on its own with ``nvcc`` out of reach (``PATH`` and
   ``CUDA_HOME`` stripped of the toolkit, so a build would raise): 3
   hits, 0 builds, ``/readyz`` ``replica.compile_cache_hits`` 3. Then
   three drills at once, each on its own directory: (3) one flipped byte
   in the median library's entry, on a copy of the directory:
   ``cache_cli verify`` exits 1, the next start misses 1 and hits 2 (the
   median library rebuilt and stored again), and ``verify`` then exits
   0; (4) on another copy, the median library's entry gone and a
   ``cache``/``io_error`` fault plan: the store is aborted, the server
   serves from its own build, a miss and the fault counted, and ``gc``
   reclaims the tmp file once it is past the grace for a live writer's;
   (5) two replicas cold together on an empty directory: both serve, and
   every entry verifies. (6) On its own, ``python -m
   nm03_capstone_project_tpu_torch.fleet.cli restart --compile-cache-dir``
   over the first replica of (5) (the ``fleet`` phase walks a restart of
   three): the relaunch reports ``compile_cache_hits`` 3 and
   builds 0, and serves the golden. Each stop's metrics snapshot passes
   ``scripts/check_telemetry.py``'s exact counter forms
   (``compile_cache_hits_total==0`` cold, ``==3`` warm). The line has
   ``warm_s`` (process start to ready; the cold, warm and relaunched
   starts each alone, the four of (3)-(5) together) of every start, each library's
   source, build and load seconds and each graph's capture seconds, the
   relaunches' split of their ``warm_s``, each stop's drain (``stop_s``:
   SIGTERM to exit), each start's answers (``serve_s``), the seconds of
   each step (``steps_s``), the launches
   and the card's name and power limit
   (``until_app_s``: spawn to the app's identity, from its ``/readyz``
   ``replica.start_unix``).
15. ``envelope`` — every route past the default config, each bitwise to
   its plain version: the median's ``select`` route at k = 17, 31 and 63
   (and 70,000 slices in two launches, signed zeros and a NaN), its
   ``wide`` route at k = 65 (the canvas-256 ``process_batch``'s median
   input and a random batch, signed zeros and a NaN), 127 and 225
   (segments in shared memory), 227 and 257 (in a device scratch; from
   225 held to the plain sort median, the network there being millions of
   min/max) on a 64 x 64 slice, with ``torch.median``'s time at each, and
   signed zeros, negatives and NaNs of both signs at 223 and 227; the
   fused stage's ``split`` route (the median with normalize and clip on
   load, then the sharpen kernel: two launches a call) at k = 17, 65 and
   a 33-tap sharpen, and the sharpen kernel alone at 9 and 33 taps (its
   device time and floor at both, on the canvas-3072 ``process_batch``'s
   median image, and the earlier staged design beside it at 9 taps); the
   grow's ``global`` route on two phantoms at 2304², 3072², 4096², 1024 x
   4096, 16,385 x 2,304, 2,304 x 16,385 and 20,000² (past the old side
   limit) and 8192² (past the resident tiles), mask, ``converged`` and
   steps. Then ``process_batch`` at canvas 3072 with k = 17 (one select,
   one sharpen and one global launch) and at canvas 256 with k = 65 (one
   wide, one sharpen and one cluster grow launch), each against a golden
   the JAX package made
   (``testdata/envelope_golden.json``, ``envelope_wide_golden.json``). The
   line has each route's wrapper and device time, plain and library
   times and floor, the 20,000² grow's among them, and the seconds of
   each step (``steps_s``).
16. ``serve_envelope`` — every route inside the served CUDA graphs: a
   server at canvas 3072 (the global grow in its graphs), buckets 1 and
   2, two lanes on the card, at k = 17 (split: select and sharpen), 7
   (fused) and 65 (split: wide and sharpen): 8 phantom bodies at
   concurrency 4, each answer the batch
   path's mask, and at k = 17 the batch path the golden's; each bucket's
   kernels and capture seconds.
17. ``kernels`` — one line, ``{"kernels": [...]}``, per kernel: launches in
   the driver's run (``launches``; the median kernel's from the unfused
   patient), in the ``slice`` phase's (``slice_launches``), by the
   ``serve`` phase's graph replays (``serve_launches``: replays times the
   launches a graph holds), in the volume driver's run
   (``volume_launches``; the median kernel's from its unfused patient), in
   the ``serve_volume`` phase's main runs (``serve_volume_launches``: the
   cohort at concurrency 1 and 4 and through the ``--distributed-init``
   server; the median kernel's from its unfused server), by the teacher
   while the ``student`` phase's 2D and 3D training runs and its three
   multi-device driver runs distil their labels (``student_launches``),
   in the ``operate`` phase (``operate_launches``:
   both servers' replays and the driver drill), by the ``fleet`` phase's
   replicas (``fleet_launches``) and on the ``shard`` phase's main path
   (``shard_launches``: the z-sharded cohort, the data-parallel smoke
   cohort, the volume and parallel drivers over four local devices and
   the process-group batch; the median kernel's from their unfused runs),
   by the ``lockdep`` phase's instrumented server (``lockdep_launches``:
   replays and the gang's launches) and in the ``sanitize`` phase's
   sanitized driver run (``sanitize_launches``; the median kernel's from
   its unfused patient), by the ``compile_cache`` phase's servers
   (``compile_cache_launches``: every start's graph replays), in the
   ``envelope`` phase (``envelope_launches``; the wide route's from its own
   ``process_batch``) and by the ``serve_envelope`` servers' replays
   (``serve_envelope_launches``), the largest difference
   from the plain version, its wrapper and device time, the plain time and
   the bound.

Every phase line names the card (``nvidia_smi``) and the host (``host``:
CPU model, logical cores, the 1-minute load average at the phase's start,
the Python and torch versions), so a slower host and a slower port can be
told apart, and carries its own ``seconds``; each long phase also carries
the seconds of its steps (``steps_s``). The ``median`` and ``fused`` lines
time the other plans (k = 9 to 15) beside k = 7 (``windows``). Before
the ``kernels`` line a ``script`` line gives the
script's seconds from its imports to there. The card's ``nvidia-smi`` name and power limit print on a line of their own;
the last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line, as does a machine without CUDA.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
import math
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (700 W). The 67 TFLOP/s of float32 outside the
# tensor cores counts an FMA as two flops: one add or multiply instruction
# issues at half of it. Min/max, 32-bit bitwise ops and shifts issue at 64
# per SM per clock against 128 float32 lanes (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): a quarter.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
OP_RATES = {"add_mul": PEAK_F32_FLOPS / 2, "minmax_bitwise": PEAK_F32_FLOPS / 4}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MAIN_SHAPE = (25, 256, 256)
DRIVER_COHORT = (20, 25, 256)  # patients, slices each, slice size
PRIME_SHAPE = (3, 251, 241)
GROW_CANVASES = (512, 1024, 2048)
WINDOWS = (3, 5, 7, 9, 11, 13, 15)
WINDOWS_TIMED = (9, 11, 13, 15)  # the median and fused plans timed beside k = 7
# the envelope phase: the routes past the generated plans and one cluster
ENVELOPE_WINDOWS = (17, 31)
ENVELOPE_BATCH = (70000, 16, 16)  # more slices than the median grid's z dimension
ENVELOPE_TAPS = 33
ENVELOPE_CANVASES = ((2304, 2304), (3072, 3072), (4096, 4096), (1024, 4096))
ENVELOPE_PIPELINE = (3072, 17)  # canvas and median window of process_batch, 2 slices
ENVELOPE_LIMIT = (2, 256, 256)  # the select kernel at MAX_SELECT_WINDOW
ENVELOPE_STREAMED = 2  # the 4096 x 4096 grow case upsampled this many times a side:
# past the global route's resident tiles (8192 x 8192 x 2)
# past the select route: the wide median at k = 65 (the canvas-256
# process_batch's median input, and a random batch), then 127 (segments in
# shared memory) and 257 (in a device scratch) on a slice narrower than 257
ENVELOPE_WIDE = (65, 127, 257)
ENVELOPE_WIDE_SMALL = (1, 64, 64)
# either side of the segments' switch to a device scratch, on signed zeros,
# negatives and NaNs of both signs: slices wider than the window, so some
# windows miss the NaNs
ENVELOPE_WIDE_KEYS = ((223, 227), (2, 24, 260))
ENVELOPE_WIDE_PIPELINE = (256, 65)  # canvas and median window of the wide route's process_batch
ENVELOPE_SIDES = ((16385, 2304), (2304, 16385))  # grow past the old 16,384 side limit
ENVELOPE_HUGE = (5000, 4)  # phantoms at 5000 x 5000 upsampled 4 times a side: 20,000 x 20,000
# serve_envelope: the server at canvas 3072 (the global grow in its
# graphs), buckets 1 and 2, two lanes on the card, at each median window
# (the split route's select and sharpen at 17, the fused kernel at 7, its
# wide and sharpen at 65), phantom bodies at concurrency 4
SERVE_ENVELOPE = (3072, (1, 2), 2)
SERVE_ENVELOPE_WINDOWS = (17, 7, 65)
SERVE_ENVELOPE_PHANTOMS = 8
SERVE_ENVELOPE_CONCURRENCY = 4
REPEATS = 20
PROFILE_TRIES = 3  # profiles of a path before its check fails, or before CUDA events
PROFILE_MARGIN_S = 0.05  # a device-time window open this long around its calls
BACKLOG_S = 0.05  # the CUDA-events fallback's sleep kernel ahead of the timed calls
SERVE_BUCKETS = (1, 2, 4, 8, 16)
SERVE_CONCURRENCY = 16
SERVE_SINGLES = 50  # requests one at a time (bucket 1)
SERVE_BURSTS = (2, 4, 8, 16)  # phantom bursts, one batch each
SERVE_REPEATS = 10  # If-None-Match repeats
LONG_STUDY = (160, 512, 512)  # planes, canvas: one long study in one launch
VOLUME_TURNS = ("kernels", "plain", "plain", "kernels")
SERVE_VOLUME_BUCKETS = (8, 16, 32)
# the served cohort's runs: (concurrency, query); another query, another
# result key, so the second run dispatches every study again
SERVE_VOLUME_RUNS = ((1, "?output=mask"), (4, "?output=mask&compressed=1"))
SERVE_VOLUME_MIXED = 6  # studies sent while slices arrive
SERVE_VOLUME_MIXED_SLICES = 100
STUDENT_STEPS = (300, 100)  # training steps of the 2D and the 3D student
STUDENT_TIMED_STEPS = 20  # training steps timed a precision
STUDENT_SHARD_STEPS = 12  # f32 steps of each multi-device training run
# an f32 curve over a (2, 2) mesh or a world of 1 sums the same batch in
# another order: its every loss within this relative distance of one
# device's, its IoU against the teacher within STUDENT_SHARD_IOU
STUDENT_SHARD_RTOL = 1e-3
STUDENT_SHARD_IOU = 0.005
# the three driver runs continue the trained student: at the training
# rate (3e-3) a dozen f32 steps undo it, so they fine-tune
STUDENT_FINE_TUNE_LR = 1e-4
STUDENT_F32_RTOL = 1e-5  # f32 forward, card vs CPU: x max |logit|
STUDENT_DELTA = 2.0  # bf16 masks may differ from f32 only where |f32 logit| < this
DEPLOY_TURNS = ("student", "classical")  # the parallel CLI, --model and without
# the operate phase's server: two transient dispatch errors (retried), a hang
# at dispatch OPERATE_HANG_INDEX past a shorter deadline (the one lane
# quarantines, the probe reinstates it) and one corrupt result-tier entry
OPERATE_HANG_INDEX = 3
OPERATE_DEADLINE_S = 2.0
OPERATE_PROBE_S = 0.5
OPERATE_PLAN = {"seed": 8, "faults": [
    {"site": "dispatch", "kind": "transient", "count": 2},
    {"site": "dispatch", "kind": "hang", "index": OPERATE_HANG_INDEX, "hang_s": 30.0},
    {"site": "cache", "kind": "corrupt_entry", "count": 1},
]}
OPERATE_SLO = (99.0, 1000.0)  # availability %, p99 target ms
OPERATE_SAMPLER = (2.0, 200)  # ledger profile interval s, capture ms
OPERATE_OPEN_REQUESTS = 200
OPERATE_OPEN_SHARE = 0.5  # the open loop's rate, a share of the closed loop's
# the driver drill over the DRIVER_COHORT: one of each of the drivers'
# fault kinds, and the counts the same plan gives on the CPU
# (tests/test_torch_driver_faults.py runs it on a cohort of the same
# patients, stems and batches and holds the port to these numbers)
DRIVER_DRILL_PLAN = {"seed": 5, "faults": [
    {"site": "decode", "kind": "error", "patient": "PGBM-0003", "stem": "1-07"},
    {"site": "decode", "kind": "corrupt", "patient": "PGBM-0004", "stem": "1-12"},
    {"site": "dispatch", "kind": "transient", "count": 2},
    {"site": "export", "kind": "io_error", "stem": "1-03", "count": 5},
    {"site": "ingest", "kind": "decode_error", "patient": "PGBM-0006", "index": 0},
]}
DRIVER_DRILL_COUNTS = {
    "slices_ok": 472,  # 500 less 1 decode error, 1 corrupt, 1 export, 25 (one batch)
    "retries": {"dispatch": 2, "export": 4},
    "faults": {"decode/error": 1, "decode/corrupt": 1, "dispatch/transient": 2,
               "export/io_error": 5, "ingest/decode_error": 1},
}
DRIVER_SIGTERM_AFTER = 60  # export checks before the SIGTERM
# the fleet: replicas on the one card, the share of the drill's requests
# answered before one replica is frozen (SIGSTOP) and then killed, how long
# it stays frozen (requests park on it meanwhile), and the loadgen rounds
# (requests, concurrency) that run through the rolling restart
FLEET_REPLICAS = 3
FLEET_KILL_SHARE = 1 / 3
FLEET_STOP_S = 0.5
FLEET_RESTART_LOAD = (32, 4)  # requests and concurrency of each round during the rolling restart
FLEET_SLICES = 250  # the first slices of the cohort, sent by each run around the SIGKILL
FLEET_START_TIMEOUT_S = 240


# the 1-minute load average when the line being built began: taken as
# each line is printed (and at the start of main), so a phase's line
# carries the load at its phase's start
_PHASE_LOAD = {}
_SCRIPT_T0 = time.perf_counter()  # the script's seconds run from its imports


def host_record(load_1m) -> dict:
    """The host a line was measured on, beside its card: CPU model, logical
    cores, the 1-minute load average at the phase's start, and the Python
    and torch versions. Host-bound numbers move with these, not only with
    the port."""
    info = {}
    try:  # the first processor's fields; x86 names its model, Arm its part
        for ln in Path("/proc/cpuinfo").read_text().split("\n\n")[0].splitlines():
            key, _, value = ln.partition(":")
            info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = next((info[k] for k in ("model name", "Model", "cpu model", "Hardware", "CPU part")
                  if info.get(k)), None)
    return {"cpu_model": model or platform.processor() or "not reported",
            "machine": platform.machine(), "logical_cores": os.cpu_count(),
            "load_1m_at_start": load_1m, "python": platform.python_version(),
            "torch": torch.__version__, "torch_cuda": torch.version.cuda}


def emit(obj) -> None:
    """Print one JSON line. A line that names the card (``nvidia_smi``)
    also names the host (:func:`host_record`)."""
    if isinstance(obj, dict) and "nvidia_smi" in obj:
        obj = dict(obj, host=host_record(_PHASE_LOAD.get("load_1m")))
    print(json.dumps(obj), flush=True)
    _PHASE_LOAD["load_1m"] = os.getloadavg()[0]


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


class StepTimer:
    """The seconds of a phase's steps: ``timer(name)`` records under
    ``name`` the seconds since the previous call (or the timer's start) in
    ``timer.spent``."""

    def __init__(self, t0: float | None = None):
        self.spent = {}
        self._t = time.perf_counter() if t0 is None else t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.spent[name], self._t = round(now - self._t, 3), now


def launch_dict(**nonzero) -> dict:
    """Launch counts by kernel name, every wrapper of ``ops/launches.py``
    present: the ones given, 0 for the rest."""
    from nm03_capstone_project_tpu_torch.ops.launches import KERNELS

    unknown = set(nonzero) - set(KERNELS)
    require(not unknown, f"unknown kernel names {sorted(unknown)}")
    return {k: nonzero.get(k, 0) for k in KERNELS}


def per_entry(calls: int) -> dict:
    """The launches of the seed/valid and finish kernels in ``calls`` entry
    calls (``process_batch``, ``process_volume``, ``_process``) under the
    kernels: one each a call."""
    return {"seeds": calls, "finish": calls}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn`` over ``repeats`` runs (CUDA events)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel, wrapper, repeats: int = REPEATS, per_call=None, events=True):
    """The kernel's own device time a launch, and how it was taken.

    torch.profiler's self device time of the kernels whose name holds
    ``kernel`` (a name, or a tuple of names a call launches one each of, or
    ``per_call`` of: their sum a call), over a window of ``repeats`` calls,
    in which ``wrapper``'s launch counter must rise by ``repeats`` (times
    the largest of ``per_call``, where a wrapper counts each of its
    launches). Each window is held open ``PROFILE_MARGIN_S`` on both sides
    of the calls, so that records whose device timestamps land just outside
    the calls' few milliseconds still fall in it. A window in which any one
    name's kernel records are not ``repeats`` (times its ``per_call``; on an
    H100 windows lose records after a million launches outside any window:
    ``scripts/torch_profiler_windows.py --launches``) is opened again, up to
    ``PROFILE_TRIES`` windows; after that the time is ``repeats`` calls
    between CUDA events behind a sleep kernel of ``BACKLOG_S``, so that the
    calls run back to back on the card and the events hold no host time.
    A call that waits on the card between its launches (``events`` false)
    would put the host's time between the events, so its time is then
    "not measured".
    Returns ``(ms, "profiler" | "cuda_events" | "not measured", the missed
    windows: their records of the kernel and the device records they did
    hold, by name)``.
    """
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    per_call = per_call or (1,) * len(names)
    launched = repeats * max(per_call)
    fn()
    torch.cuda.synchronize()
    missed = []
    for _ in range(PROFILE_TRIES):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        require(wrapper.launches - before == launched,
                f"{kernel}: the wrapper launched {wrapper.launches - before}, not {launched}")
        records = prof.key_averages()
        hits = [e for e in records if any(n in e.key for n in names)]
        calls = [sum(e.count for e in hits if n in e.key) for n in names]
        if calls == [repeats * c for c in per_call]:
            return sum(e.self_device_time_total for e in hits) / repeats / 1e3, "profiler", missed
        missed.append({"calls": calls, "saw": {e.key[:60]: e.count for e in records
                                               if e.self_device_time_total > 0}})
    if not events:
        return "not measured", "not measured", missed
    before = wrapper.launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(BACKLOG_S * 2e9))  # cycles: the H100's SM clock is below 2 GHz
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    require(wrapper.launches - before == launched,
            f"{kernel}: the wrapper launched {wrapper.launches - before}, not {launched}")
    return start.elapsed_time(end) / repeats, "cuda_events", missed


def ptxas_report(log: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            k = re.search(r"(band_kernel|fused_kernel|grow_kernel|grow_global_kernel|"
                          r"select_kernel|wide_kernel|windowed_sharpen_kernel|sharpen_kernel)"
                          r"(I(?:L[ib]\d+E)+E)?", m.group(1))
            name = None if k is None else k.group(1) + (
                "<%s>" % ",".join(re.findall(r"\d+", k.group(2))) if k.group(2) else "")
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def bound(bytes_moved: float, ops: dict):
    """Least milliseconds for the work, and whether bytes or ops bound it.

    ``ops`` counts operations by kind of ``OP_RATES``; the kinds issue to
    separate pipes, so the slowest kind bounds the operations.
    """
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = max(n / OP_RATES[kind] * 1e3 for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def preprocess_kwargs(cfg) -> dict:
    """The fused preprocess kernel's keyword arguments under ``cfg``."""
    return dict(
        norm_low=cfg.norm_low, norm_high=cfg.norm_high,
        norm_min=cfg.norm_intensity_min, norm_max=cfg.norm_intensity_max,
        clip_low=cfg.clip_low, clip_high=cfg.clip_high,
        median_window=cfg.median_window, sharpen_gain=cfg.sharpen_gain,
        sharpen_sigma=cfg.sharpen_sigma, sharpen_kernel=cfg.sharpen_kernel,
    )


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def files_of(root: Path) -> dict:
    """``{relative path: bytes}`` of the JPEG files under ``root``."""
    return {str(f.relative_to(root)): f.read_bytes() for f in sorted(root.rglob("*.jpg"))}


def driver_phase(tmp: Path, smi: str, kernels: dict, reset):
    """The batch drivers end to end on the card (phase 4 of the docstring).

    Returns the launches of the parallel run (the median kernel's from the
    unfused patient) and what the ``serve`` phase holds its answers to: the
    cohort's directory and, by (patient, stem), the parallel run's masks
    and JPEG pairs.
    """
    from nm03_capstone_project_tpu_torch import native
    from nm03_capstone_project_tpu_torch.cli import parallel as parallel_cli
    from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor
    from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.render.export import encode_jpeg_bytes, jpeg_encoder

    t_phase = time.perf_counter()
    phase_step = StepTimer(t_phase)
    n_pat, n_sl, size = DRIVER_COHORT
    cfg = PipelineConfig(canvas=size)
    t0 = time.perf_counter()
    cohort = tmp / "cohort"
    write_synthetic_cohort(cohort, n_patients=n_pat, n_slices=n_sl, height=size, width=size)
    write_s = time.perf_counter() - t0
    encoder = jpeg_encoder()
    require(native.available(), "the host C++ layer did not load")

    def collector():
        masks, lock = {}, threading.Lock()

        def sink(pid, stem, mask):
            with lock:
                masks[(pid, stem)] = np.array(mask, copy=True)
        return masks, sink

    phase_step("write_cohort")
    # the main path: the parallel driver over the whole cohort
    masks, sink = collector()
    out_par = tmp / "parallel"
    proc = CohortProcessor(cohort, out_par, cfg=cfg, batch_cfg=BatchConfig(),
                           mode="parallel", mask_sink=sink)
    reset()
    t0 = time.perf_counter()
    summary = proc.process_all_patients()
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    n = n_pat * n_sl
    require(summary.patients_ok == n_pat, f"patients ok {summary.patients_ok}/{n_pat}")
    require(summary.succeeded_slices == n and summary.total_slices == n,
            f"slices ok {summary.succeeded_slices}/{summary.total_slices}")
    par_files = files_of(out_par)
    require(len(par_files) == 2 * n, f"{len(par_files)} JPEG files, not {2 * n}")
    manifest = json.loads((out_par / "manifest.json").read_text())
    statuses = [s for pat in manifest.values() for s in pat.values()]
    require(len(statuses) == n and set(statuses) == {"done"},
            f"manifest: {len(statuses)} slices, statuses {sorted(set(statuses))}")
    require(launches["fused"] > 0 and launches["grow"] > 0
            and launches["seeds"] == launches["finish"] == launches["fused"],
            f"the driver did not launch every kernel of its path: {launches}")
    require(len(masks) == n, f"the mask sink saw {len(masks)} slices")

    phase_step("parallel_run")
    # the same decoded pixels through process_batch with the plain ops
    plain_cfg = PipelineConfig(canvas=size, use_kernels=False)
    decoded = {}
    for pid in find_patient_dirs(cohort):
        files = load_dicom_files_for_patient(cohort, pid)
        px = np.zeros((len(files), size, size), np.float32)
        dims = np.zeros((len(files), 2), np.int32)
        for i, f in enumerate(files):
            a = read_dicom(f).pixels
            px[i, : a.shape[0], : a.shape[1]] = a
            dims[i] = a.shape
        decoded[pid] = ([f.stem for f in files], px, dims)
        want = process_batch(torch.from_numpy(px).cuda(), torch.from_numpy(dims).cuda(),
                             plain_cfg)["mask"].cpu().numpy()
        for i, f in enumerate(files):
            require(np.array_equal(masks[(pid, f.stem)], want[i]),
                    f"{pid}/{f.stem}: driver mask != plain process_batch")

    phase_step("plain_check")
    # the first 50 masks and their host renders against the JAX-made golden;
    # the renders are the ones the driver encoded (same renderer, same bytes)
    golden = json.loads((build.PKG / "testdata" / "driver_golden.json").read_text())
    for g in golden["slices"]:
        pid, stem = g["patient"], g["stem"]
        stems, px, dims = decoded[pid]
        i = stems.index(stem)
        m = masks[(pid, stem)]
        gray, seg = native.render_pair_native(px[i], m, dims[i], cfg)
        got = {"dims": [int(d) for d in dims[i]],
               "mask_sha256": hashlib.sha256(m.tobytes()).hexdigest(),
               "area": int(m.sum()),
               "gray_sha256": hashlib.sha256(gray.tobytes()).hexdigest(),
               "seg_sha256": hashlib.sha256(seg.tobytes()).hexdigest()}
        require(got == {k: g[k] for k in got}, f"{pid}/{stem}: differs from the golden")
        require(par_files[f"{pid}/{stem}_original.jpg"] == encode_jpeg_bytes(gray)
                and par_files[f"{pid}/{stem}_processed.jpg"] == encode_jpeg_bytes(seg),
                f"{pid}/{stem}: the driver's JPEG pair is not its render")

    phase_step("golden")
    # one patient each: sequential, device render, the unfused (median) path
    variants = {}
    for key, pid, mode, vcfg, bcfg in (
        ("sequential", "PGBM-0001", "sequential", cfg, BatchConfig()),
        ("device_render", "PGBM-0002", "parallel", cfg, BatchConfig(render_stage="device")),
        ("unfused", "PGBM-0003", "parallel",
         PipelineConfig(canvas=size, fuse_preprocess=False), BatchConfig()),
    ):
        vmasks, vsink = collector()
        out = tmp / key
        vproc = CohortProcessor(cohort, out, cfg=vcfg, batch_cfg=bcfg, mode=mode,
                                mask_sink=vsink)
        reset()
        res = vproc.process_patient(pid)
        torch.cuda.synchronize()
        vl = {k: fn.launches for k, fn in kernels.items()}
        require(res.succeeded == n_sl, f"{key}: {res.succeeded}/{n_sl} slices")
        need = ("median", "grow") if key == "unfused" else ("fused", "grow")
        require(all(vl[k] > 0 for k in need) and vl["seeds"] == vl["finish"] == vl[need[0]],
                f"{key}: launches {vl}")
        for (p_, stem), m in vmasks.items():
            require(np.array_equal(m, masks[(p_, stem)]), f"{key}: {p_}/{stem} mask differs")
        require(len(vmasks) == n_sl, f"{key}: the sink saw {len(vmasks)} slices")
        vfiles = files_of(out)
        require(vfiles == {k: v for k, v in par_files.items() if k.startswith(pid + "/")},
                f"{key}: JPEG files differ from the parallel run's")
        variants[key] = {"patient": pid, "launches": vl}
    launches["median"] = variants["unfused"]["launches"]["median"]

    phase_step("variants")
    # the parallel driver's CLI, end to end: plain, kernels, kernels, plain
    runs = {"kernels": [], "plain": []}
    timing = {}
    for i, which in enumerate(("plain", "kernels", "kernels", "plain")):
        rj = tmp / f"results_{i}.json"
        argv = ["--base-path", str(cohort), "--output", str(tmp / f"cli_{i}"),
                "--results-json", str(rj), "--canvas", str(size)]
        if which == "plain":
            argv.append("--no-kernels")
        reset()
        rc = parallel_cli.main(argv)
        require(rc == 0, f"parallel CLI run {i} ({which}) exited {rc}")
        rec = json.loads(rj.read_text())
        require(rec["summary"]["slices_ok"] == n, f"CLI run {i}: {rec['summary']['slices_ok']}")
        require(rec["backend"] == "cuda" and not rec["backend_degraded"], f"CLI run {i}: {rec}")
        kl = rec["kernel_launches"]
        require((kl["fused"] > 0 and kl["grow"] > 0
                 and kl["seeds"] == kl["finish"] == kl["fused"]) if which == "kernels"
                else sum(kl.values()) == 0, f"CLI run {i} ({which}) launches {kl}")
        runs[which].append(n / rec["wall_s"])
        timing[f"{which}_{i}"] = {"wall_s": rec["wall_s"], "timing_s": rec["timing_s"]}

    phase_step("cli_turns")
    # where the device sits idle under the driver: device busy over one run
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        CohortProcessor(cohort, tmp / "profiled", cfg=cfg, mode="parallel").process_all_patients()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3

    phase_step("profiled_run")
    # the drivers' telemetry, apart from the throughput turns
    telemetry = telemetry_run(parallel_cli.main, ["--base-path", str(cohort), "--canvas",
                                                  str(size)],
                              tmp / "cli_telemetry", kernels, reset, ("fused", "grow"),
                              feed_stall=True)

    phase_step("telemetry")
    emit({"phase": "driver", "patients": n_pat, "slices": n, "size": size,
          "write_cohort_s": write_s, "parallel_s": par_s, "jpeg_files": len(par_files),
          "launches": launches, "golden_slices": len(golden["slices"]),
          "variants": variants, "timing": timing, "telemetry": telemetry,
          "profiled_wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
          "seconds": time.perf_counter() - t_phase, "steps_s": phase_step.spent,
          "nvidia_smi": smi})
    # the throughput turns' line: their seconds are the driver line's cli_turns
    emit({"phase": "driver_throughput",
          "kernels_slices_per_s": runs["kernels"], "plain_slices_per_s": runs["plain"],
          "jpeg_encoder": encoder, "launches": launches,
          "seconds": phase_step.spent["cli_turns"], "nvidia_smi": smi})
    return launches, {"cohort": cohort, "masks": masks, "files": par_files,
                      "slices_per_s": runs["kernels"]}


def http_post(url: str, body: bytes, headers: dict):
    """POST with urllib; (status, json payload or None, headers, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    dt = time.perf_counter() - t0
    return status, json.loads(raw) if raw else None, hdrs, dt


def client_run(url: str, jobs: list, concurrency: int):
    """Send ``jobs`` ((key, body, headers)) from ``concurrency`` threads;
    ``({key: (status, payload, headers, seconds)}, wall seconds)``."""
    results, lock, it = {}, threading.Lock(), iter(jobs)

    def worker():
        while True:
            with lock:
                job = next(it, None)
            if job is None:
                return
            key, body, headers = job
            out = http_post(url, body, headers)
            with lock:
                results[key] = out

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(len(results) == len(jobs), f"{len(results)} answers to {len(jobs)} requests")
    return results, wall


def latency_stats(results: dict, wall: float) -> dict:
    lat = sorted(r[3] * 1e3 for r in results.values())
    return {"requests": len(lat), "wall_s": wall, "requests_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def serve_phase(driver_out: dict, smi: str, kernels: dict, reset) -> dict:
    """Single-slice serving on the card (phase 5 of the docstring).

    Returns each kernel's launches made by graph replays while the servers
    answered requests (replays x the kernels a graph holds).
    """
    from torch.profiler import ProfilerActivity, profile

    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.synthetic import smoke_cohort
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom_bytes
    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
    from nm03_capstone_project_tpu_torch.render.export import encode_jpeg_bytes
    from nm03_capstone_project_tpu_torch.render.host_render import host_render_pair
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    t_phase = time.perf_counter()
    phase_step = StepTimer(t_phase)
    cohort, dmasks, dfiles = driver_out["cohort"], driver_out["masks"], driver_out["files"]
    dicom = [(pid, f.stem, f.read_bytes()) for pid in find_patient_dirs(cohort)
             for f in load_dicom_files_for_patient(cohort, pid)]
    require(len(dicom) == len(dmasks), f"{len(dicom)} DICOM files, {len(dmasks)} driver masks")
    cfg = PipelineConfig(canvas=DRIVER_COHORT[2])
    statuses = {}

    def tally(results: dict, want: int = 200):
        for status, payload, _, _ in results.values():
            statuses[status] = statuses.get(status, 0) + 1
            require(status == want, f"HTTP {status} where {want} was due: {payload}")

    def check_dicom(results: dict, jpeg: bool):
        for (pid, stem), (_, payload, headers, _) in results.items():
            m = dmasks[(pid, stem)]
            h, w = payload["shape"]
            require(payload["mask_sha256"] == hashlib.sha256(
                np.ascontiguousarray(m[:h, :w]).tobytes()).hexdigest(),
                f"served {pid}/{stem}: mask != the driver's")
            if jpeg:
                require(base64.b64decode(payload["original_jpeg_b64"])
                        == dfiles[f"{pid}/{stem}_original.jpg"]
                        and base64.b64decode(payload["processed_jpeg_b64"])
                        == dfiles[f"{pid}/{stem}_processed.jpg"],
                        f"served {pid}/{stem}: JPEG pair != the driver's files")

    phase_step("read_cohort")
    app = ServingApp(cfg=cfg, buckets=SERVE_BUCKETS, result_cache_bytes=1 << 30)
    httpd, _, port = serve_in_thread(app)  # warmup: one CUDA graph a bucket
    url = f"http://127.0.0.1:{port}/v1/segment"
    try:
        graphs = app.status()["cuda_graphs"]
        require(graphs["enabled"] and sorted(map(int, graphs["lanes"]["0"])) == list(
            SERVE_BUCKETS), f"cuda_graphs: {graphs}")
        capture_s = {b: g["capture_s"] for b, g in graphs["lanes"]["0"].items()}
        reset()
        app.executor.reset_replays()  # the main path's run: replays from here count

        phase_step("start_and_capture")
        # the cohort's 500 DICOM files from 16 clients, under the profiler
        jobs = [((pid, stem), body, {"Content-Type": "application/dicom"})
                for pid, stem, body in dicom]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            c16, c16_wall = client_run(url, jobs, SERVE_CONCURRENCY)
            torch.cuda.synchronize()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        tally(c16)
        check_dicom(c16, jpeg=True)

        phase_step("concurrency16")
        # one at a time: bucket 1 (mask only: another result key, so no hit)
        jobs = [((pid, stem), body, {"Content-Type": "application/dicom"})
                for pid, stem, body in dicom[:SERVE_SINGLES]]
        c1, c1_wall = client_run(url + "?output=mask", jobs, 1)
        tally(c1)
        check_dicom(c1, jpeg=False)

        phase_step("concurrency1")
        # the smoke cohort's non-square phantoms as raw float32 bodies, in
        # bursts that each coalesce into one batch: a 0.25 s window, taken
        # up by the batcher from its next batch on (the first phantom's)
        phantoms = [a for a in smoke_cohort() if a.shape[0] != a.shape[1]][5::7]
        phantoms = phantoms[: 1 + sum(SERVE_BURSTS)]
        app.batcher.max_wait_s = 0.25
        bursts, start = {}, 0
        for b in (1,) + SERVE_BURSTS:
            jobs = [(start + i, a.astype("<f4").tobytes(),
                     {"Content-Type": "application/octet-stream",
                      "X-Nm03-Height": str(a.shape[0]), "X-Nm03-Width": str(a.shape[1])})
                    for i, a in enumerate(phantoms[start : start + b])]
            res, _ = client_run(url, jobs, b)
            bursts.update(res)
            start += b
        tally(bursts)
        batch = pad_to_canvas(phantoms, cfg.canvas_hw, device="cuda")
        want = process_batch(batch.pixels, batch.dims, PipelineConfig(
            canvas=cfg.canvas, use_kernels=False))["mask"].cpu().numpy()
        for i, a in enumerate(phantoms):
            payload = bursts[i][1]
            got_sha = payload["mask_sha256"]
            h, w = a.shape
            require(payload["shape"] == [h, w] and got_sha == hashlib.sha256(
                np.ascontiguousarray(want[i, :h, :w]).tobytes()).hexdigest(),
                f"phantom {i} ({h}x{w}): served mask != plain process_batch")
        replays = {b: g["replays"] for b, g in app.status()["cuda_graphs"]["lanes"]["0"].items()}
        launches = app.executor.replay_launches()
        require(all(n > 0 for n in replays.values()), f"a bucket never replayed: {replays}")
        # each replay launches the seed/valid and finish kernels once
        require(launches.get("fused", 0) > 0 and launches.get("grow", 0) > 0
                and launches.get("seeds") == launches.get("finish") == sum(replays.values()),
                f"the graphs did not launch every kernel of the path: {launches}")
        wrapper_launches = {k: fn.launches for k, fn in kernels.items()}
        require(sum(wrapper_launches.values()) == 0,
                f"serving ran a kernel wrapper outside a graph: {wrapper_launches}")

        phase_step("bursts")
        # the result tier: repeats of answered bodies, with and without the ETag
        cached = 0
        for pid, stem, body in dicom[:SERVE_REPEATS]:
            etag = c16[(pid, stem)][2]["ETag"]
            status, payload, headers, _ = http_post(
                url, body, {"Content-Type": "application/dicom", "If-None-Match": etag})
            require(status == 304 and payload is None and headers["ETag"] == etag,
                    f"{pid}/{stem}: If-None-Match gave {status}")
            status, payload, headers, _ = http_post(
                url, body, {"Content-Type": "application/dicom"})
            require(status == 200 and headers["X-Nm03-Cache"] == "hit"
                    and headers["ETag"] == etag and payload["mask_sha256"]
                    == c16[(pid, stem)][1]["mask_sha256"], f"{pid}/{stem}: repeat missed")
            statuses[304] = statuses.get(304, 0) + 1
            statuses[200] += 1
            cached += 1
        require(app.executor.replay_launches() == launches, "a cached repeat replayed")

        phase_step("result_tier")
        # where a concurrency-16 request's time goes on the host: the
        # server's own wall and queue wait (its histograms), and one
        # slice's decode and render + encode, alone (median of 20)
        reg = app.registry
        server_side = {
            name: reg.get(name).sum / reg.get(name).count
            for name in ("serving_request_seconds", "serving_queue_wait_seconds")}
        body = dicom[0][2]
        px = read_dicom_bytes(body).pixels
        mask = dmasks[(dicom[0][0], dicom[0][1])]
        dims = np.asarray(px.shape, np.int32)

        def host_ms(fn):
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        host_cost_ms = {
            "decode": host_ms(lambda: read_dicom_bytes(body)),
            "render_encode": host_ms(lambda: [encode_jpeg_bytes(im) for im in
                                              host_render_pair(px, mask, dims, cfg)]),
        }
        hist = app.registry.get("serving_batch_size").cumulative()
        batch_hist, prev = {}, 0
        for le, n in hist:
            if n > prev:
                batch_hist[le] = n - prev
            prev = n
        drained = app.begin_drain(reason="chip_smoke")
        # a body the result tier has not seen (a stored one is still served)
        status, payload, _, _ = http_post(url + "?output=mask", dicom[-1][2],
                                          {"Content-Type": "application/dicom"})
        require(drained and status == 503 and payload["draining"] is True,
                f"after begin_drain a request got {status}")
        statuses[503] = statuses.get(503, 0) + 1
    finally:
        app.begin_drain(reason="chip_smoke")
        httpd.shutdown()
        httpd.server_close()

    phase_step("host_costs")
    # one graph replay against eager _process, per bucket, on the same inputs
    graph_vs_eager = {}
    for b in SERVE_BUCKETS:
        g = app.executor._runners[0][b]
        px, dm = g.pixels, g.dims
        graph_vs_eager[b] = {"graph_ms": cuda_ms(g.graph.replay),
                             "eager_ms": cuda_ms(lambda: _process(px, dm, cfg))}
    app.close()

    phase_step("graph_vs_eager")
    # the unfused path: the standalone median kernel inside the graphs
    uapp = ServingApp(cfg=PipelineConfig(canvas=cfg.canvas, fuse_preprocess=False),
                      buckets=(1, 4), result_cache_bytes=1 << 26)
    uhttpd, _, uport = serve_in_thread(uapp)
    try:
        uapp.executor.reset_replays()
        jobs = [((pid, stem), body, {"Content-Type": "application/dicom"})
                for pid, stem, body in dicom[100:108]]
        unfused, _ = client_run(f"http://127.0.0.1:{uport}/v1/segment?output=mask", jobs, 4)
        tally(unfused)
        ulaunch = uapp.executor.replay_launches()
    finally:
        uapp.begin_drain(reason="chip_smoke")
        uhttpd.shutdown()
        uhttpd.server_close()
        uapp.close()
    for (pid, stem), (_, payload, _, _) in unfused.items():
        m = dmasks[(pid, stem)]
        require(payload["mask_sha256"] == hashlib.sha256(m.tobytes()).hexdigest(),
                f"unfused served {pid}/{stem}: mask != the driver's")
    require(ulaunch.get("median", 0) > 0 and "fused" not in ulaunch
            and ulaunch.get("seeds") == ulaunch.get("finish") == ulaunch["median"],
            f"the unfused graphs' launches: {ulaunch}")

    serve_launches = {k: launches.get(k, 0) + ulaunch.get(k, 0) for k in kernels}
    phase_step("unfused_server")
    emit({"phase": "serve", "buckets": list(SERVE_BUCKETS), "statuses": statuses,
          "dicom_requests": len(dicom), "singles": SERVE_SINGLES,
          "phantoms": len(phantoms), "cached_repeats": cached,
          "batch_size_hist": batch_hist, "replays": replays, "capture_s": capture_s,
          "concurrency16": latency_stats(c16, c16_wall), "concurrency1": latency_stats(
              c1, c1_wall),
          "server_mean_s": server_side, "host_cost_ms": host_cost_ms,
          "c16_device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "c16_idle_share": 1 - busy_ms / (c16_wall * 1e3) if busy_ms > 0 else "not measured",
          "graph_vs_eager_ms": graph_vs_eager, "serve_launches": serve_launches,
          "unfused_launches": ulaunch, "seconds": time.perf_counter() - t_phase,
          "steps_s": phase_step.spent, "nvidia_smi": smi})
    return serve_launches


def long_study():
    """``(volume, dims)`` of one long phantom study: LONG_STUDY planes at the
    full canvas, numpy float32 and int32."""
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume

    d, h, w = LONG_STUDY
    return phantom_volume(d, h, w, seed=5), np.asarray([h, w], np.int32)


def grow_stats(px, dm, cfg) -> dict:
    """The 3D growth of ``process_volume`` alone on one volume on the card:
    its milliseconds (host clock around it, synchronized; median of 3), the
    dilation steps it ran and the blocks of ``grow_block_iters`` steps (on
    the kernel the card decides each block; read here after the growth)."""
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import (
        grow_volume,
        volume_grow_inputs,
    )

    pre, seeds, valid = volume_grow_inputs(px, dm, cfg)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, conv, steps = grow_volume(pre, seeds, valid, cfg, return_steps=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    steps = int(steps)
    return {"grow_ms": statistics.median(times), "steps": steps,
            "blocks": steps // cfg.grow_block_iters, "converged": bool(conv)}


GROW3D_KERNELS = ("grow3d_pack_kernel", "grow3d_kernel", "grow3d_unpack_kernel")


def grow3d_inputs(cfg) -> dict:
    """The 3D grow kernel's timed volumes on the card, as
    ``volume_grow_inputs`` gives them to the growth: a BraTS-sized
    155-plane phantom study (the benchmark's volume cell) and the cohort's
    first patient, the 25 planes ``write_synthetic_cohort`` writes for
    PGBM-0001."""
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_series, phantom_volume
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import volume_grow_inputs

    _, n_sl, size = DRIVER_COHORT
    bvol = np.zeros((155, size, size), np.float32)
    bvol[:, :240, :240] = phantom_volume(155, 240, 240, seed=21)
    cvol = np.clip(np.stack(phantom_series(n_sl, size, size, seed=0)), 0, 65535)
    return {name: volume_grow_inputs(torch.from_numpy(vol.astype(np.float32)).cuda(),
                                     torch.tensor(hw, dtype=torch.int32, device="cuda"), cfg)
            for name, vol, hw in (("brats", bvol, (240, 240)),
                                  ("cohort_patient", cvol.astype(np.uint16), (size, size)))}


def grow3d_kwargs(valid, cfg) -> dict:
    return dict(low=cfg.grow_low, high=cfg.grow_high, valid=valid,
                block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters, return_steps=True)


def grow3d_device_times(cfg) -> dict:
    """The 3D grow kernel's own device time a call on :func:`grow3d_inputs`
    (:func:`device_ms`: the pack, the one cooperative run of every block and
    the unpack, summed a call; the profiler's records must show each of the
    three once a call), taken early, beside the envelope's: after the
    launch-heavy phases the profiler's windows came back short. A call
    waits on nothing, so CUDA events time it where the profiler misses.
    ``{name: (ms, method, missed windows)}``."""
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv

    out = {}
    for name, (pre, seeds, valid) in grow3d_inputs(cfg).items():
        kw = grow3d_kwargs(valid, cfg)
        out[name] = device_ms(lambda: hv.region_grow_3d_kernel(pre, seeds, **kw), GROW3D_KERNELS,
                              hv.region_grow_3d_kernel)
    return out


def grow3d_times(cfg, dev_times: dict) -> dict:
    """The 3D grow kernel (``ops/hopper_volume.py``) on each of
    :func:`grow3d_inputs`, held bitwise to the plain loop (mask, converged,
    steps) and then timed: the wrapper's milliseconds a call (CUDA events;
    the call reads nothing back), its kernels' own device time a call
    from ``dev_times`` (:func:`grow3d_device_times`), the plain loop's
    milliseconds and the floor: the bytes that reach HBM, the float32
    volume read once and the mask written once (each step's packed region
    and band, 3/8 of a byte a voxel, stay in L2: ``l2_bytes``, not
    charged), or ten bitwise operations a 32-voxel word a step against the
    card's rate."""
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
    from nm03_capstone_project_tpu_torch.ops.volume import region_grow_3d

    out = {}
    for name, (pre, seeds, valid) in grow3d_inputs(cfg).items():
        kw = grow3d_kwargs(valid, cfg)
        got = hv.region_grow_3d_kernel(pre, seeds, **kw)
        want = region_grow_3d(pre, seeds, **kw)
        require(torch.equal(got[0], want[0]) and bool(got[1]) == bool(want[1])
                and int(got[2]) == want[2], f"3D grow kernel != plain at {tuple(pre.shape)}")
        steps, n = want[2], pre.numel()
        b_ms, b_by = bound(4 * n + n, {"minmax_bitwise": 10 * steps * n / 32})
        dev_ms, dev_by, dev_missed = dev_times[name]
        out[name] = {
            "shape": list(pre.shape), "steps": steps, "blocks": steps // cfg.grow_block_iters,
            "voxels": int(got[0].sum()), "converged": bool(got[1]), "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: hv.region_grow_3d_kernel(pre, seeds, **kw)),
            "device_ms": dev_ms, "device_ms_by": dev_by, "profiler_missed": dev_missed,
            "plain_ms": cuda_ms(lambda: region_grow_3d(pre, seeds, **kw), repeats=3),
            "bound_ms": b_ms, "bound_by": b_by, "l2_bytes": steps * 3 * n / 8}
    return out


MASKS_KERNELS = {"seeds": "seed_valid_kernel", "finish": "finish_kernel"}


def masks_phase(cfg, main_px, main_dims, smi: str) -> dict:
    """The seed/valid and finish kernels (``ops/hopper_masks.py``) on the
    main path's studies, each held bitwise to the torch ops and then timed:
    the TCIA batch (``main_px``, the cohort's sizes), a BraTS-sized batch of
    155 planes of 240 x 240 on the 256 canvas (:func:`grow3d_inputs`), and
    its volume (one seed plane; the 3D finish). The finish takes each
    study's grown mask. Timed: the wrapper's milliseconds (CUDA events), the
    kernel's own device time (:func:`device_ms`), the torch ops'
    milliseconds and the floor: the bytes, 2 a pixel written for the seeds
    and valid, 1 read and 1 written a voxel for the finish. Prints the
    ``masks`` line; returns the kernels table's two rows (the TCIA batch)."""
    from nm03_capstone_project_tpu_torch.ops import hopper_masks as hk
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges

    t_phase = time.perf_counter()
    grow_kw = dict(low=cfg.grow_low, high=cfg.grow_high)
    hw = tuple(main_px.shape[-2:])
    pre = hm._fused_preprocess_plain(extend_edges(main_px, main_dims), **preprocess_kwargs(cfg))
    seeds, valid = hk.seed_valid_masks_plain(main_dims, hw)
    tcia_seg = hg.region_grow_kernel(pre, seeds, valid=valid, **grow_kw)[0]
    bpre, bseeds, bvalid = grow3d_inputs(cfg)["brats"]
    bdims = torch.tensor([[240, 240]] * bpre.shape[0], dtype=torch.int32, device="cuda")
    vdims = bdims[0].clone()
    studies = {
        "tcia": (main_dims, tcia_seg, False),
        "brats_slices": (bdims, hg.region_grow_kernel(bpre, bseeds, valid=bvalid, **grow_kw)[0],
                         False),
        "volume": (vdims, hv.region_grow_3d_kernel(bpre, bseeds, valid=bvalid, **grow_kw)[0],
                   True),
    }
    out = {"seeds": {}, "finish": {}}
    for study, (dims, seg, volume) in studies.items():
        calls = {
            "seeds": (lambda d=dims: hk.seed_valid_masks_kernel(d, hw),
                      lambda d=dims: hk.seed_valid_masks_plain(d, hw),
                      hk.seed_valid_masks_kernel, 2 * dims[..., 0].numel() * hw[0] * hw[1]),
            "finish": (lambda d=dims, s=seg, v=volume: hk.finish_mask_kernel(
                           s, d, cfg.morph_size, v),
                       lambda d=dims, s=seg, v=volume: hk.finish_mask_plain(
                           s, d, cfg.morph_size, v),
                       hk.finish_mask_kernel, 2 * seg.numel()),
        }
        for key, (kernel, plain, wrapper, nbytes) in calls.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got, want = (torch.stack(got), torch.stack(want)) if key == "seeds" else (got, want)
            require(torch.equal(got, want), f"{key} kernel != torch ops ({study})")
            dev_ms, dev_by, dev_missed = device_ms(kernel, MASKS_KERNELS[key], wrapper)
            b_ms, b_by = bound(nbytes, {"minmax_bitwise": 0})
            out[key][study] = {
                "shape": list(got.shape), "voxels": int(got.sum()), "max_abs_err": 0.0,
                "ms": cuda_ms(kernel), "device_ms": dev_ms, "device_ms_by": dev_by,
                "profiler_missed": dev_missed, "plain_ms": cuda_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "masks", "bitwise": True, "morph_size": cfg.morph_size, **out,
          "launches": {"seeds": hk.seed_valid_masks_kernel.launches,
                       "finish": hk.finish_mask_kernel.launches},
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return {k: v["tcia"] for k, v in out.items()}


def volume_phase(tmp: Path, cohort: Path, study, smi: str, kernels: dict, reset,
                 grow3d_dev: dict) -> dict:
    """The 3D volume path on the card (phase 6 of the docstring).

    ``grow3d_dev`` is :func:`grow3d_device_times`, taken early. Returns each
    kernel's launches in the volume driver's main run (the median kernel's
    from the unfused patient).
    """
    from torch.profiler import ProfilerActivity, profile

    from nm03_capstone_project_tpu_torch.cli import volume as volume_cli
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.pipeline import process_volume

    t_phase = time.perf_counter()
    phase_step = StepTimer(t_phase)
    n_pat, n_sl, size = DRIVER_COHORT
    n = n_pat * n_sl
    cfg = PipelineConfig(canvas=size)
    golden_file = json.loads((build.PKG / "testdata" / "volume_golden.json").read_text())
    golden = {g["patient"]: g for g in golden_file["patients"]}
    require(len(golden) == n_pat, f"the volume golden holds {len(golden)} patients")

    def cli(base: Path, out: Path, *extra) -> dict:
        rj = out.parent / (out.name + ".json")
        rc = volume_cli.main(["--base-path", str(base), "--output", str(out),
                              "--results-json", str(rj), "--canvas", str(size),
                              "--export-mhd", *extra])
        require(rc == 0, f"volume CLI {out.name} exited {rc}")
        rec = json.loads(rj.read_text())
        require(rec["backend_actual"] == "cuda" and rec["z_sharded"] is False,
                f"volume CLI {out.name}: {rec['backend_actual']}")
        return rec

    def outputs(out: Path, rec: dict):
        """The run's JPEG files and its masks read back from mask.mhd."""
        masks = {pid: read_metaimage(out / pid / "mask.mhd")[0] for pid in rec["patients"]}
        return files_of(out), masks

    phase_step("setup")
    # the main path, the volume CLI over the cohort: kernels and plain in turns
    runs, kept, launches = {"kernels": [], "plain": []}, {}, None
    for i, which in enumerate(VOLUME_TURNS):
        out = tmp / f"volume_{i}"
        reset()
        rec = cli(cohort, out, *(["--no-kernels"] if which == "plain" else []))
        kl = rec["kernel_launches"]
        if i == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
            require(launches == kl, f"launch counts {launches} != the CLI's {kl}")
        pats = rec["patients"]
        require(len(pats) == n_pat and sum(p["exported"] for p in pats.values()) == n
                and sum(p["slices"] for p in pats.values()) == n,
                f"volume run {i} ({which}): {len(pats)} patients")
        require(kl == (launch_dict(fused=n_pat, grow3d=n_pat, **per_entry(n_pat))
                       if which == "kernels" else launch_dict()),
                f"volume run {i} ({which}) launches {kl}")
        files, masks = outputs(out, rec)
        require(len(files) == 2 * n, f"volume run {i}: {len(files)} JPEG files, not {2 * n}")
        for pid, g in golden.items():
            m = masks[pid]
            got = {"depth": int(m.shape[0]),
                   "mask_sha256": hashlib.sha256(m.tobytes()).hexdigest(),
                   "voxels": int(m.sum()),
                   "grow_converged": pid not in rec["grow_truncated_patients"]}
            require(got == {k: g[k] for k in got} and pats[pid]["mask_voxels"] == g["voxels"],
                    f"volume run {i} ({which}) {pid}: differs from the golden")
        if which not in kept:
            kept[which] = (files, masks, out)
        runs[which].append(rec)
    kfiles, kmasks, kout = kept["kernels"]
    pfiles, pmasks, _ = kept["plain"]
    require(kfiles == pfiles, "volume: JPEG files with the kernels != plain")
    require(all(np.array_equal(kmasks[p], pmasks[p]) for p in kmasks),
            "volume: masks with the kernels != plain")

    phase_step("cli_turns")
    # the cohort holds two distinct masks; phantom volumes of four other
    # shapes, each a mask of its own, through process_volume with the kernels
    for ph in golden_file["phantoms"]:
        d, h, w = ph["shape"]
        batch = pad_to_canvas(list(phantom_volume(d, h, w, seed=ph["seed"])), (size, size),
                              device="cuda")
        out = process_volume(batch.pixels, batch.dims[0], cfg)
        m = out["mask"].cpu().numpy()
        got = {"mask_sha256": hashlib.sha256(m.tobytes()).hexdigest(),
               "voxels": int(m.sum()), "grow_converged": bool(out["grow_converged"])}
        require(got == {k: ph[k] for k in got}, f"phantom volume {ph['shape']}: "
                "differs from the golden")

    phase_step("phantoms")
    # one patient each through the variants, against the kernels run
    variants = {}
    for key, pid, extra, need in (
        ("device_render", "PGBM-0004", ["--render-stage", "device"], {"fused": 1}),
        ("unfused", "PGBM-0005", ["--no-preprocess-fuse"], {"median": 1}),
        ("jump", "PGBM-0006", ["--grow-algorithm", "jump"], {"fused": 1}),
    ):
        base = tmp / f"vcohort_{key}"
        shutil.copytree(cohort / pid, base / pid)
        out = tmp / f"volume_{key}"
        reset()
        rec = cli(base, out, *extra)
        vl = {k: fn.launches for k, fn in kernels.items()}
        # the dilate schedule grows on the 3D grow kernel, the jump one on torch ops
        dilate = key != "jump"
        want = launch_dict(**need, **per_entry(1), **({"grow3d": 1} if dilate else {}))
        require(vl == want == rec["kernel_launches"], f"volume {key}: launches {vl}")
        vfiles, vmasks = outputs(out, rec)
        conv = pid not in rec["grow_truncated_patients"]
        # the jump schedule converges within its 1024 rounds here, and then
        # gives the dilate schedule's masks
        require(conv, f"volume {key}: {pid} truncated")
        require(np.array_equal(vmasks[pid], kmasks[pid]), f"volume {key}: mask differs")
        require(vfiles == {k: v for k, v in kfiles.items() if k.startswith(pid + "/")},
                f"volume {key}: JPEG files differ from the kernels run's")
        variants[key] = {"patient": pid, "launches": vl, "converged": conv}
    launches["median"] = variants["unfused"]["launches"]["median"]

    phase_step("variants")
    # where a kernels run's time goes, and the device's idle share under it
    rec0 = runs["kernels"][0]
    shares = {}
    for key, sec in rec0["timings_s"].items():
        stage = key.split("/", 1)[0]
        shares[stage] = shares.get(stage, 0.0) + sec / rec0["wall_s"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli(cohort, tmp / "volume_profiled")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3

    phase_step("profiled_run")
    # the volume driver's telemetry, apart from the turns (the fused kernel
    # and the 3D grow kernel; not the 2D grow kernel)
    telemetry = telemetry_run(volume_cli.main, ["--base-path", str(cohort), "--canvas",
                                                str(size), "--export-mhd"],
                              tmp / "volume_telemetry", kernels, reset, ("fused", "grow3d"),
                              feed_stall=False)

    phase_step("telemetry")
    # the 3D growth alone: every cohort patient, the median one reported
    per_patient = {}
    for pid in golden:
        vol, dims, _, _ = volume_cli._load_volume(cohort, pid, cfg)
        per_patient[pid] = grow_stats(torch.from_numpy(vol).cuda(),
                                      torch.from_numpy(dims).cuda(), cfg)
    by_ms = sorted(per_patient, key=lambda p: per_patient[p]["grow_ms"])
    median_pid = by_ms[len(by_ms) // 2]

    phase_step("growth_3d")
    # the 3D grow kernel alone: a BraTS-sized study (the benchmark's volume
    # cell) and a 25-plane cohort patient
    grow3d = grow3d_times(cfg, grow3d_dev)

    phase_step("grow3d_kernel")
    # one long study through process_volume, kernels and plain
    svol, sdims = study
    spx, sdm = torch.from_numpy(svol).cuda(), torch.from_numpy(sdims).cuda()
    scfg = PipelineConfig(canvas=LONG_STUDY[1])
    splain = PipelineConfig(canvas=LONG_STUDY[1], use_kernels=False)

    def study_run(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = process_volume(spx, sdm, c)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset()
    sfast, first_s = study_run(scfg)
    study_launches = {k: fn.launches for k, fn in kernels.items()}
    sslow, first_plain_s = study_run(splain)
    require(study_launches == launch_dict(fused=1, grow3d=1, **per_entry(1)),
            f"long study launches {study_launches}")
    require(torch.equal(sfast["mask"], sslow["mask"]), "long study: kernel mask != plain")
    require(bool(sfast["grow_converged"]) == bool(sslow["grow_converged"]),
            "long study: converged differs")
    require(int(sfast["mask"].sum()) > 0, "long study segmented nothing")
    del sslow
    # warm runs in turns (the first ones above also pay the allocator's
    # first blocks at this shape)
    study_s = {"kernels": [], "plain": []}
    for which in VOLUME_TURNS:
        study_s[which].append(study_run(scfg if which == "kernels" else splain)[1])
    study_grow = grow_stats(spx, sdm, scfg)

    def rate(recs):
        walls = [r["wall_s"] for r in recs]
        return {"volumes_per_s": statistics.median(n_pat / w for w in walls),
                "slices_per_s": statistics.median(n / w for w in walls), "wall_s": walls}

    phase_step("long_study")
    emit({"phase": "volume", "patients": n_pat, "planes": n, "size": size,
          "jpeg_files": len(kfiles), "golden_patients": len(golden),
          "golden_phantoms": len(golden_file["phantoms"]),
          "checks": ["20/20 patients ok, 500 planes, 1000 JPEG files a run",
                     "every mask (mask.mhd) = volume_golden.json (sha256, voxels, converged)",
                     "4 phantom volumes of other shapes (kernels) = volume_golden.json",
                     "kernels = plain: masks and JPEG bytes",
                     "device render, unfused (median kernel), jump = the kernels run",
                     "fused kernel once a patient; long study kernels = plain"],
          "kernels": rate(runs["kernels"]), "plain": rate(runs["plain"]),
          "time_shares": shares, "profiled_wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
          "grow_median_patient": {"patient": median_pid, **per_patient[median_pid]},
          "grow_ms_range": [per_patient[by_ms[0]]["grow_ms"], per_patient[by_ms[-1]]["grow_ms"]],
          "long_study": {"shape": list(LONG_STUDY),
                         "process_volume_s": statistics.median(study_s["kernels"]),
                         "plain_s": statistics.median(study_s["plain"]), "turns_s": study_s,
                         "first_s": {"kernels": first_s, "plain": first_plain_s},
                         "voxels": int(sfast["mask"].sum()),
                         "converged": bool(sfast["grow_converged"]), **study_grow},
          "variants": variants, "telemetry": telemetry, "launches": launches,
          "grow3d": grow3d, "seconds": time.perf_counter() - t_phase,
          "steps_s": phase_step.spent, "nvidia_smi": smi})
    return launches, {"masks": kmasks, "volumes_per_s": rate(runs["kernels"])["volumes_per_s"],
                      "mhd_dir": kout, "grow3d": grow3d["brats"]}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stable_port(taken=()) -> int:
    """A free port below the kernel's ephemeral range, for a server that
    must come back on the same port after it dies: a port from ``bind(0)``
    is in that range, where, once its listener is gone, any connect() (the
    router's health probes of the dead replica included) may take it as its
    own source port and hold it past the relaunch. No connect() and no
    ``bind(0)`` is ever given a port below the range."""
    import random
    import socket

    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768  # Linux's default
    require(low > 11024, f"the ephemeral port range starts at {low}: no stable port below it")
    for port in random.Random(time.time_ns()).sample(range(low - 10000, low), 200):
        if port in taken:
            continue
        with socket.socket() as s:  # no SO_REUSEADDR: a port in TIME_WAIT is skipped too
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in [{low - 10000}, {low})")


def shard_phase(tmp: Path, driver_out: dict, volume_out: dict, study, smoke, smi: str,
                kernels: dict, reset) -> dict:
    """Multi-device inference on the one card (phase 7 of the docstring).

    ``smoke`` is ``(cohort, masks, converged)`` of the ``slice`` phase.
    Returns each kernel's launches on the phase's main path: the cohort's
    volumes z-sharded four ways (fused), the smoke cohort over the 4-entry
    ``data`` mesh (fused and grow), and, for the median kernel, one
    volume and one batch under ``fuse_preprocess=False``.
    """
    import dataclasses

    import torch.distributed as dist

    from nm03_capstone_project_tpu_torch.cli import parallel as parallel_cli
    from nm03_capstone_project_tpu_torch.cli import volume as volume_cli
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.parallel import (
        Mesh,
        distributed,
        make_mesh,
        process_batch_sharded,
        process_volume_batch_zsharded,
        process_volume_zsharded,
    )
    from nm03_capstone_project_tpu_torch.pipeline import process_volume
    from nm03_capstone_project_tpu_torch.resilience import FaultPlan
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    phase_t0 = time.perf_counter()
    n_pat, n_sl, size = DRIVER_COHORT
    cohort = driver_out["cohort"]
    dev = torch.device("cuda", 0)
    golden_file = json.loads((build.PKG / "testdata" / "volume_golden.json").read_text())
    golden = {g["patient"]: g for g in golden_file["patients"]}
    cfg = PipelineConfig(canvas=size)

    def zmesh(n):
        return make_mesh(devices=[dev] * n, axis_names=("z",))

    def sha(m):
        return hashlib.sha256(np.ascontiguousarray(m).tobytes()).hexdigest()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    launches = {}

    phase_step = StepTimer(phase_t0)
    phase_step("setup")

    # (a) the cohort's 25-plane volumes padded to 28, z-sharded over
    # [cuda:0] x 4: the phase's main path for the fused kernel
    vols = {}
    for pid in find_patient_dirs(cohort):
        vol, dims, _, _ = volume_cli._load_volume(cohort, pid, cfg)
        vols[pid] = (vol, dims)
    require(len(vols) == n_pat, f"{len(vols)} cohort volumes")

    def padded(vol, n):
        pad = (-vol.shape[0]) % n
        return np.concatenate([vol, np.zeros((pad,) + vol.shape[1:], vol.dtype)]) if pad else vol

    def cohort_run(n, c, pids):
        out = {}
        for pid in pids:
            vol, dims = vols[pid]
            r = process_volume_zsharded(padded(vol, n), dims, c, zmesh(n))
            out[pid] = (r["mask"][: vol.shape[0]].cpu().numpy(), bool(r["grow_converged"]))
        return out

    pids = sorted(vols)
    reset()
    four, cohort4_s = timed(lambda: cohort_run(4, cfg, pids))
    launches["zshard"] = {k: fn.launches for k, fn in kernels.items()}
    require(launches["zshard"] == launch_dict(fused=4 * n_pat, grow=0, median=0),
            f"z-sharded cohort launches {launches['zshard']}, not 4 fused a volume")
    two = cohort_run(2, cfg, pids)
    for pid in pids:
        g = golden[pid]
        for tag, (m, conv) in (("x4", four[pid]), ("x2", two[pid])):
            require(m.shape[0] == g["depth"] == n_sl and sha(m) == g["mask_sha256"]
                    and int(m.sum()) == g["voxels"] and conv == g["grow_converged"],
                    f"z-sharded {tag} {pid}: differs from the golden")
            require(np.array_equal(m, volume_out["masks"][pid]),
                    f"z-sharded {tag} {pid}: differs from process_volume")
    # morph_size 5: two halo planes cross each boundary (28 / 4 = 7 planes a slab)
    cfg5 = dataclasses.replace(cfg, morph_size=5)
    for pid in pids[:2]:
        vol, dims = vols[pid]
        want = process_volume(torch.from_numpy(vol).to(dev), torch.from_numpy(dims).to(dev),
                              cfg5)
        got = cohort_run(4, cfg5, [pid])[pid]
        require(np.array_equal(got[0], want["mask"].cpu().numpy())
                and got[1] == bool(want["grow_converged"]), f"morph 5 x4 {pid}: differs")
    # the unfused path: one volume, the median kernel once a slab
    reset()
    cohort_run(4, dataclasses.replace(cfg, fuse_preprocess=False), pids[:1])
    launches["zshard_unfused"] = {k: fn.launches for k, fn in kernels.items()}
    require(launches["zshard_unfused"] == launch_dict(fused=0, grow=0, median=4),
            f"unfused z-sharded launches {launches['zshard_unfused']}")

    # the long study, 160 x 512 x 512: sharded four and two ways, and at
    # morph_size 5, each against process_volume; wall times on the card
    svol, sdims = study
    spx, sdm = torch.from_numpy(svol).to(dev), torch.from_numpy(sdims).to(dev)
    scfg = PipelineConfig(canvas=LONG_STUDY[1])
    study_times = {"unsharded": [], "x4": []}
    want = None
    for which in ("unsharded", "x4", "x4", "unsharded"):
        if which == "unsharded":
            out, s = timed(lambda: process_volume(spx, sdm, scfg))
            want = out
        else:
            reset()
            out, s = timed(lambda: process_volume_zsharded(spx, sdm, scfg, zmesh(4)))
            sl = {k: fn.launches for k, fn in kernels.items()}
            require(sl == launch_dict(fused=4, grow=0, median=0), f"long study x4 launches {sl}")
            require(torch.equal(out["mask"], want["mask"])
                    and bool(out["grow_converged"]) == bool(want["grow_converged"]),
                    "long study x4: differs from process_volume")
        study_times[which].append(s)
    out2 = process_volume_zsharded(spx, sdm, scfg, zmesh(2))
    require(torch.equal(out2["mask"], want["mask"]), "long study x2: differs")
    scfg5 = dataclasses.replace(scfg, morph_size=5)
    want5 = process_volume(spx, sdm, scfg5)
    out5 = process_volume_zsharded(spx, sdm, scfg5, zmesh(4))
    require(torch.equal(out5["mask"], want5["mask"]), "long study morph 5 x4: differs")
    require(int(want["mask"].sum()) > 0, "the long study segmented nothing")
    del out, out2, out5, want5

    phase_step("zshard")
    # (b) the smoke cohort over a ("data",) mesh of [cuda:0] x 4, in
    # batches of 100 (25 a chunk)
    smoke_cohort_px, smoke_masks, smoke_conv = smoke
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas

    dmesh = make_mesh(devices=[dev] * 4, axis_names=("data",))
    dp_batches = [pad_to_canvas(smoke_cohort_px[i:i + 100], (256, 256), device=dev)
                  for i in range(0, len(smoke_cohort_px), 100)]
    reset()
    dp_out, dp_s = timed(lambda: [process_batch_sharded(b.pixels, b.dims, cfg, dmesh,
                                                        mask_only=True) for b in dp_batches])
    launches["dp"] = {k: fn.launches for k, fn in kernels.items()}
    require(launches["dp"] == launch_dict(fused=4 * len(dp_batches), grow=4 * len(dp_batches),
                                          **per_entry(4 * len(dp_batches))), f"data-parallel launches {launches['dp']}")
    dp_masks = torch.cat([o["mask"] for o in dp_out]).cpu().numpy()
    dp_conv = torch.cat([o["grow_converged"] for o in dp_out]).cpu().numpy()
    require(np.array_equal(dp_masks, smoke_masks) and np.array_equal(dp_conv, smoke_conv),
            "data-parallel masks != process_batch's")
    smoke_golden = json.loads((build.PKG / "testdata" / "smoke_masks.json").read_text())
    for g in smoke_golden["slices"]:
        i = g["index"]
        require(sha(dp_masks[i]) == g["sha256"] and int(dp_masks[i].sum()) == g["area"],
                f"data-parallel slice {i}: differs from the golden")
    reset()
    unf = process_batch_sharded(dp_batches[0].pixels, dp_batches[0].dims,
                                dataclasses.replace(cfg, fuse_preprocess=False), dmesh)
    torch.cuda.synchronize()
    launches["dp_unfused"] = {k: fn.launches for k, fn in kernels.items()}
    require(launches["dp_unfused"] == launch_dict(grow=4, median=4, **per_entry(4))
            and np.array_equal(unf["mask"].cpu().numpy(), smoke_masks[:100]),
            f"unfused data-parallel: launches {launches['dp_unfused']}")

    phase_step("data_mesh")
    # (c) world-of-1 driver runs under NCCL, byte-identical to the earlier phases
    def dist_flags():
        return ["--distributed", "--coordinator-address", f"127.0.0.1:{free_port()}",
                "--num-processes", "1", "--process-id", "0"]

    def after_run(tag):
        # the drivers leave the job themselves; the group is gone between runs
        if dist.is_initialized():
            dist.destroy_process_group()
            require(False, f"{tag}: the driver left its process group behind")

    world1 = {}
    out = tmp / "shard_parallel"
    rj = tmp / "shard_parallel.json"
    t0 = time.perf_counter()
    rc = parallel_cli.main(["--base-path", str(cohort), "--output", str(out), "--canvas",
                            str(size), "--results-json", str(rj), *dist_flags()])
    world1["parallel_s"] = time.perf_counter() - t0
    after_run("parallel")
    require(rc == 0, f"world-of-1 parallel driver exited {rc}")
    require(files_of(out) == driver_out["files"], "world-of-1 parallel: JPEG pairs differ")
    rec = json.loads(rj.read_text())
    require(rec["summary"]["slices_ok"] == n_pat * n_sl and "cluster" not in rec,
            f"world-of-1 parallel results {rec['summary']}")
    kout = volume_out["mhd_dir"]
    want_files = files_of(kout)
    want_mhd = {pid: (kout / pid / "mask.raw").read_bytes() for pid in pids}
    for tag, extra in (("volume", []), ("volume_zshard", ["--z-shard"])):
        out = tmp / f"shard_{tag}"
        t0 = time.perf_counter()
        rc = volume_cli.main(["--base-path", str(cohort), "--output", str(out), "--canvas",
                              str(size), "--export-mhd", *extra, *dist_flags()])
        world1[f"{tag}_s"] = time.perf_counter() - t0
        after_run(tag)
        require(rc == 0, f"world-of-1 {tag} exited {rc}")
        require(files_of(out) == want_files, f"world-of-1 {tag}: JPEG pairs differ")
        require(all((out / pid / "mask.raw").read_bytes() == want_mhd[pid] for pid in pids)
                and all(np.array_equal(read_metaimage(out / pid / "mask.mhd")[0],
                                       volume_out["masks"][pid]) for pid in pids),
                f"world-of-1 {tag}: mask.mhd differs")
    phase_step("world1_drivers")
    # the drivers' own multi-device paths through their entry points: with
    # four local devices (the one card named four times, as the CPU tests
    # name the CPU four times) the volume driver z-shards each study and
    # the parallel driver splits each batch over a data mesh
    import contextlib
    import io

    from nm03_capstone_project_tpu_torch.config import BatchConfig
    from nm03_capstone_project_tpu_torch.parallel import mesh as mesh_mod

    real_local_devices = mesh_mod.local_devices
    mesh_mod.local_devices = lambda device=None: [dev] * 4
    try:
        out = tmp / "shard_volume_local"
        said = io.StringIO()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            rc = volume_cli.main(["--base-path", str(cohort), "--output", str(out), "--canvas",
                                  str(size), "--export-mhd", "--z-shard"])
        world1["volume_zshard_local_s"] = time.perf_counter() - t0
        launches["volume_local"] = {k: fn.launches for k, fn in kernels.items()}
        print(said.getvalue(), end="")
        require(rc == 0, f"volume --z-shard over 4 local devices exited {rc}")
        require("z-sharding volumes over 4 local devices" in said.getvalue(),
                "volume --z-shard did not z-shard over the 4 local devices")
        require(launches["volume_local"] == launch_dict(fused=4 * n_pat, grow=0, median=0),
                f"volume --z-shard launches {launches['volume_local']}, not 4 fused a volume")
        require(files_of(out) == want_files, "volume --z-shard (4 local): JPEG pairs differ")
        require(all((out / pid / "mask.raw").read_bytes() == want_mhd[pid] for pid in pids),
                "volume --z-shard (4 local): mask.raw differs")
        # mesh-aligned batches of 24, the short one padded to the mesh
        bs = max(4, BatchConfig().batch_size // 4 * 4)
        n_batches = n_pat * -(-n_sl // bs)
        out = tmp / "shard_parallel_local"
        reset()
        t0 = time.perf_counter()
        rc = parallel_cli.main(["--base-path", str(cohort), "--output", str(out), "--canvas",
                                str(size)])
        world1["parallel_local_s"] = time.perf_counter() - t0
        launches["parallel_local"] = {k: fn.launches for k, fn in kernels.items()}
        require(rc == 0, f"parallel driver over 4 local devices exited {rc}")
        require(launches["parallel_local"] == launch_dict(fused=4 * n_batches,
                                                          grow=4 * n_batches,
                                                          **per_entry(4 * n_batches)),
                f"parallel driver's data mesh launches {launches['parallel_local']}, "
                f"not 4 fused and 4 grow for each of {n_batches} batches")
        require(files_of(out) == driver_out["files"],
                "parallel driver over 4 local devices: JPEG pairs differ")
        # the student over the data mesh: --model, one copy of it for the
        # one distinct device, the files byte-equal to a one-device run's
        # (a seeded student at full width: the check is equality, not IoU)
        from nm03_capstone_project_tpu_torch import models as pm

        ckpt = tmp / "shard_student"
        pm.save_params(ckpt, pm.init_unet(torch.Generator().manual_seed(0), base=16,
                                          device=dev), meta={"model_3d": False})
        student_files = {}
        for tag, devs in (("one", [dev]), ("mesh", [dev] * 4)):
            mesh_mod.local_devices = lambda device=None, devs=devs: list(devs)
            out = tmp / f"shard_student_{tag}"
            reset()
            t0 = time.perf_counter()
            rc = parallel_cli.main(["--base-path", str(cohort), "--output", str(out),
                                    "--canvas", str(size), "--model", str(ckpt)])
            world1[f"student_{tag}_s"] = time.perf_counter() - t0
            require(rc == 0, f"parallel driver --model ({tag}) exited {rc}")
            require(sum(fn.launches for fn in kernels.values()) == 0,
                    f"parallel driver --model ({tag}) launched a kernel")
            student_files[tag] = files_of(out)
            shutil.rmtree(out)
        require(len(student_files["one"]) == 2 * n_pat * n_sl
                and student_files["mesh"] == student_files["one"],
                "parallel driver --model over 4 local devices: JPEG pairs differ from one "
                f"device ({sum(student_files['mesh'].get(k) != v for k, v in student_files['one'].items())} files)")
    finally:
        mesh_mod.local_devices = real_local_devices

    phase_step("local_devices")
    # the process-group transport under NCCL in a world of 1: the count's
    # all_reduce and the mask's all_gather on the card (no halo peers)
    require(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda"),
            "world of 1: no process group")
    try:
        gmesh = distributed.global_mesh(("z",))
        pg_mesh = Mesh(gmesh.devices, ("z",), process_group=True)
        vol, dims = vols[pids[0]]
        r = process_volume_zsharded(vol, dims, cfg, pg_mesh)
        require(dist.get_backend() == "nccl" and r["mask"].is_cuda
                and np.array_equal(r["mask"].cpu().numpy(), volume_out["masks"][pids[0]]),
                "world of 1 over NCCL: the mask differs")
        # the batched form over the process group: the cohort as one
        # (20, 28, 256, 256) batch on a ('data', 'z') mesh of the job's one
        # rank, against the in-process form and the golden
        batch = np.stack([padded(vols[pid][0], 4) for pid in pids])
        bdims = np.stack([vols[pid][1] for pid in pids])
        g2 = distributed.global_mesh(("data", "z"), (1, 1))
        reset()
        pg_batch, world1["batch_pg_s"] = timed(lambda: process_volume_batch_zsharded(
            batch, bdims, cfg, Mesh(g2.devices, ("data", "z"), process_group=True)))
        launches["batch_pg"] = {k: fn.launches for k, fn in kernels.items()}
        require(launches["batch_pg"] == launch_dict(fused=1, grow=0, median=0),
                f"batched process-group z-shard launches {launches['batch_pg']}")
        in_proc = process_volume_batch_zsharded(
            batch, bdims, cfg, make_mesh(devices=[dev] * 4, axis_names=("data", "z"),
                                         axis_sizes=(2, 2)))
        require(torch.equal(pg_batch["mask"], in_proc["mask"])
                and torch.equal(pg_batch["grow_converged"], in_proc["grow_converged"]),
                "batched z-shard over the process group != in process")
        for i, pid in enumerate(pids):
            m = pg_batch["mask"][i, :n_sl].cpu().numpy()
            require(sha(m) == golden[pid]["mask_sha256"]
                    and bool(pg_batch["grow_converged"][i]) == golden[pid]["grow_converged"],
                    f"batched z-shard over the process group, {pid}: differs from the golden")
        del batch, pg_batch, in_proc
    finally:
        distributed.shutdown()

    phase_step("process_group")
    # (d) the volume gang over four lanes on the one card: 20 studies at
    # z_shards 4, then a lane's death mid-volume and the next at 3
    studies = {}
    for pid in pids:
        raws = [f.read_bytes() for f in load_dicom_files_for_patient(cohort, pid)]
        studies[pid] = b"".join(len(r).to_bytes(4, "little") + r for r in raws)
    plan = FaultPlan.from_spec({"faults": [{"site": "volume", "kind": "dispatch_error",
                                            "lane": 2, "index": n_pat}]})
    app = ServingApp(cfg=cfg, buckets=(1, 2), lane_devices=[dev] * 4, fault_plan=plan,
                     volume_serving=True, volume_depth_buckets=SERVE_VOLUME_BUCKETS,
                     lane_probe_interval_s=600.0)
    httpd, _, port = serve_in_thread(app)
    vurl = f"http://127.0.0.1:{port}/v1/segment-volume"
    parts = {"Content-Type": "application/x-nm03-dicom-parts"}
    gang = {}
    try:
        st = app.status()["volumes"]
        require(st["z_shards"] == 4, f"four-lane gang warmed at {st['z_shards']}")
        reset()
        res, wall = client_run(vurl, [(pid, studies[pid], parts) for pid in pids], 1)
        launches["gang"] = {k: fn.launches for k, fn in kernels.items()}
        for pid, (status, payload, headers, _) in res.items():
            require(status == 200 and payload["z_shards"] == 4
                    and headers.get("X-Nm03-Z-Shards") == "4", f"gang {pid}: {status}")
            m = np.frombuffer(base64.b64decode(payload["mask_b64"]), np.uint8).reshape(
                payload["shape"])
            require(sha(m) == golden[pid]["mask_sha256"], f"gang {pid}: differs from golden")
        require(launches["gang"] == launch_dict(fused=4 * n_pat, grow=0, median=0),
                f"four-lane gang launches {launches['gang']}")
        gang["x4"] = latency_stats(res, wall)
        status, payload, headers, secs = http_post(vurl, studies[pids[0]], parts)
        require(status == 200 and payload["z_shards"] == 3 and payload["requeues"] == 1,
                f"after the lane death: {status} {payload.get('z_shards')}")
        m = np.frombuffer(base64.b64decode(payload["mask_b64"]), np.uint8).reshape(
            payload["shape"])
        require(sha(m) == golden[pids[0]]["mask_sha256"], "gang x3: differs from the golden")
        require(app.executor.healthy_lanes() == [0, 1, 3], "lane 2 not quarantined")
        require(app.registry.get("serving_lane_quarantines_total", lane="2",
                                 cause="device_lost").value == 1, "quarantine not booked")
        gang["x3_ms"] = secs * 1e3
    finally:
        app.begin_drain(reason="smoke")
        httpd.shutdown()
        httpd.server_close()
        app.close()

    main = {k: sum(launches[p][k] for p in ("zshard", "dp", "volume_local", "parallel_local",
                                            "batch_pg"))
            for k in kernels}
    main["median"] = launches["zshard_unfused"]["median"] + launches["dp_unfused"]["median"]
    phase_step("gang")
    emit({"phase": "shard", "checks": [
              "cohort 20 x 25 (padded 28) z-sharded x4 and x2 = volume_golden.json = process_volume",
              "morph_size 5 x4 (two halo planes) = process_volume; fused 4 a volume",
              "long study 160 x 512^2 x4, x2, morph 5 = process_volume",
              "smoke cohort over a 4-entry data mesh = process_batch = smoke_masks.json",
              "world-of-1 --distributed (nccl) parallel, volume, volume --z-shard: "
              "byte-identical to the driver and volume phases",
              "4 local devices: volume --z-shard (4 fused a volume) and the parallel "
              "driver's data mesh (4 fused + 4 grow a batch) byte-identical to the "
              "volume and driver phases",
              "4 local devices: the parallel driver's --model over the data mesh "
              "byte-identical to a one-device --model run",
              "world of 1 (nccl): process_volume_batch_zsharded over the process group "
              "= in process ([cuda:0] x 4 as 2 x 2) = volume_golden.json",
              "four-lane gang: 20 studies at z_shards 4 = golden; lane death -> z_shards 3"],
          "long_study": {"shape": list(LONG_STUDY),
                         "unsharded_s": study_times["unsharded"], "x4_s": study_times["x4"],
                         "unsharded_median_s": statistics.median(study_times["unsharded"]),
                         "x4_median_s": statistics.median(study_times["x4"])},
          "cohort_x4_s": cohort4_s, "data_parallel_s": dp_s, "world1": world1,
          "gang": gang, "launches": launches,
          "seconds": time.perf_counter() - phase_t0, "steps_s": phase_step.spent,
          "nvidia_smi": smi})
    return main


def serve_volume_phase(tmp: Path, driver_out: dict, volume_out: dict, smi: str,
                       kernels: dict, reset) -> dict:
    """Whole-study serving on the card (phase 8 of the docstring).

    Returns each kernel's launches in the main run (the cohort's studies at
    concurrency 1 and 4; the median kernel's from the unfused server).
    """
    from torch.profiler import ProfilerActivity, profile

    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom_bytes, write_dicom
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.obs import RunContext
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
    from nm03_capstone_project_tpu_torch.ops.median import (
        vector_median_filter,
        vector_median_filter_merge,
        vector_median_filter_sort,
    )
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    phase_t0 = time.perf_counter()
    n_pat, n_sl, size = DRIVER_COHORT
    cohort, dmasks = driver_out["cohort"], driver_out["masks"]
    golden_file = json.loads((build.PKG / "testdata" / "volume_golden.json").read_text())
    golden = {g["patient"]: g for g in golden_file["patients"]}
    parts = "application/x-nm03-dicom-parts"

    phase_step = StepTimer(phase_t0)
    # each patient's 25 DICOM files, as they are on disk, one study a body
    studies, slices = {}, []
    for pid in find_patient_dirs(cohort):
        files = load_dicom_files_for_patient(cohort, pid)
        raws = [f.read_bytes() for f in files]
        studies[pid] = b"".join(len(r).to_bytes(4, "little") + r for r in raws)
        slices += [(pid, f.stem, r) for f, r in zip(files, raws)]
    require(len(studies) == n_pat and set(studies) <= set(golden), f"{len(studies)} studies")
    pids = sorted(studies)

    def sha(m):
        return hashlib.sha256(np.ascontiguousarray(m).tobytes()).hexdigest()

    def served_mask(payload):
        return np.frombuffer(base64.b64decode(payload["mask_b64"]), np.uint8).reshape(
            payload["shape"])

    def check_study(pid, payload, with_mask=True):
        g = golden[pid]
        require(payload["shape"] == [g["depth"], size, size] and payload["z_shards"] in (0, 1),
                f"served {pid}: shape {payload['shape']}")
        got = {"mask_sha256": payload["mask_sha256"], "voxels": payload["mask_voxels"],
               "grow_converged": payload["grow_converged"]}
        require(got == {k: g[k] for k in got}, f"served {pid}: differs from the golden")
        if with_mask:
            require(sha(served_mask(payload)) == g["mask_sha256"], f"served {pid}: mask_b64")

    statuses = {}

    def tally(results, want=200):
        for status, payload, _, _ in results.values():
            statuses[status] = statuses.get(status, 0) + 1
            require(status == want, f"HTTP {status} where {want} was due: {payload}")

    def cohort_jobs(conc):
        return [(pid, body, {"Content-Type": parts, "X-Nm03-Request-Id": f"c{conc}-{pid}"})
                for pid, body in studies.items()]

    cfg = PipelineConfig(canvas=size)
    log_json = tmp / "serve_volume_events.jsonl"
    obs = RunContext.create("serve", log_json=str(log_json))
    app = ServingApp(cfg=cfg, buckets=SERVE_BUCKETS, result_cache_bytes=1 << 30, obs=obs,
                     volume_serving=True, volume_depth_buckets=SERVE_VOLUME_BUCKETS)
    httpd, _, port = serve_in_thread(app)  # graphs first, then the gang's buckets
    base = f"http://127.0.0.1:{port}"
    vurl = base + "/v1/segment-volume"
    try:
        st = app.status()
        require(st["volumes"]["enabled"] and st["volumes"]["z_shards"] == 1
                and st["volumes"]["depth_buckets"] == list(SERVE_VOLUME_BUCKETS),
                f"volumes block: {st['volumes']}")

        # the main path: the cohort's 20 studies at concurrency 1, then at 4
        # (another result key, compressed=1, so each is dispatched again),
        # timed without the profiler (its idle share comes from a second
        # server below)
        runs, main_res = {}, {}
        reset()
        for conc, query in SERVE_VOLUME_RUNS:
            res, wall = client_run(vurl + query, cohort_jobs(conc), conc)
            main_res[conc] = res
            tally(res)
            for pid, (_, payload, headers, _) in res.items():
                require(headers.get("X-Nm03-Cache") == "fill", f"{pid}: not dispatched")
                check_study(pid, payload)
            runs[conc] = latency_stats(res, wall)
            runs[conc]["volumes_per_s"] = runs[conc].pop("requests_per_s")
        main_launches = {k: fn.launches for k, fn in kernels.items()}
        dispatched = n_pat * len(SERVE_VOLUME_RUNS)
        require(main_launches == launch_dict(fused=dispatched, grow=0, median=0),
                f"the served studies' launches {main_launches}, not one fused a study")

        # the gang alone, fed the decoded studies from 1 and from 4 threads:
        # its dispatch span with no HTTP decode or encode running beside it
        decoded = {pid: app.decode_volume_dicom(studies[pid], parts) for pid in pids}

        def gang_direct(conc):
            def one(pid):
                vol = decoded[pid]
                req = app.volumes.submit(vol, vol.shape[1:])
                require(req.wait(120) and req.error is None, f"gang alone {pid}: {req.error}")
                require(sha(req.mask) == golden[pid]["mask_sha256"], f"gang alone {pid}: mask")
                return next(sp["dur_s"] for sp in req.trace.snapshot()
                            if sp["name"] == "volume_dispatch") * 1e3

            t0 = time.perf_counter()
            with ThreadPoolExecutor(conc) as pool:
                dispatch_ms = list(pool.map(one, pids))
            wall = time.perf_counter() - t0
            return {"volumes_per_s": len(pids) / wall,
                    "dispatch_ms_p50": statistics.median(dispatch_ms),
                    "dispatch_ms_max": max(dispatch_ms)}

        gang_alone = {conc: gang_direct(conc) for conc, _ in SERVE_VOLUME_RUNS}

        # the golden's phantoms as raw bodies: depths 13 and 20 pad to 16
        # and 32, 32 fills its bucket; 40 is past the largest bucket (its raw
        # body is past the body cap too, so it goes as DICOM parts, whose
        # depth the server reads and refuses)
        phantoms = []
        for ph in golden_file["phantoms"]:
            d, h, w = ph["shape"]
            vol = phantom_volume(d, h, w, seed=ph["seed"]).astype("<f4")
            if d > SERVE_VOLUME_BUCKETS[-1]:
                body = b""
                for i, plane in enumerate(vol):
                    f = tmp / f"deep_{i}.dcm"
                    write_dicom(f, np.clip(plane, 0, 65535).astype(np.uint16))
                    body += len(f.read_bytes()).to_bytes(4, "little") + f.read_bytes()
                status, payload, _, _ = http_post(vurl, body, {"Content-Type": parts})
                statuses[status] = statuses.get(status, 0) + 1
                require(status == 413 and "depth bucket" in payload["error"],
                        f"a {d}-plane study got {status}: {payload}")
                continue
            status, payload, _, _ = http_post(vurl, vol.tobytes(), {
                "Content-Type": "application/octet-stream", "X-Nm03-Depth": str(d),
                "X-Nm03-Height": str(h), "X-Nm03-Width": str(w)})
            statuses[status] = statuses.get(status, 0) + 1
            require(status == 200, f"phantom {ph['shape']}: {status} {payload}")
            full = np.zeros((d, size, size), np.uint8)
            full[:, :h, :w] = served_mask(payload)
            got = {"mask_sha256": sha(full), "voxels": payload["mask_voxels"],
                   "grow_converged": payload["grow_converged"]}
            require(got == {k: ph[k] for k in got}, f"phantom {ph['shape']}: != the golden")
            phantoms.append(ph["shape"])

        # ?output=mhd: the volume CLI's mask.mhd pair; then an idempotency-key
        # repeat, answered from the store with the same ETag
        pid = pids[2]
        key = {"Content-Type": parts, "X-Nm03-Idempotency-Key": f"{pid}-mhd"}
        status, payload, headers, _ = http_post(vurl + "?output=mhd", studies[pid], key)
        require(status == 200, f"mhd: {status}")
        cli_dir = volume_out["mhd_dir"] / pid
        require(base64.b64decode(payload["mhd_header_b64"]) == (cli_dir / "mask.mhd").read_bytes()
                and base64.b64decode(payload["mhd_data_b64"]) == (cli_dir / "mask.raw").read_bytes(),
                "the served MetaImage pair != the volume CLI's")
        etag, mhd_pair = headers["ETag"], (payload["mhd_header_b64"], payload["mhd_data_b64"])
        # the retry carries the key and another patient's study: the key
        # names the first result, which comes from the store
        before = {k: fn.launches for k, fn in kernels.items()}
        status, payload, headers, _ = http_post(vurl + "?output=mhd", studies[pids[3]], key)
        require(status == 200 and headers["X-Nm03-Cache"] == "hit" and headers["ETag"] == etag
                and (payload["mhd_header_b64"], payload["mhd_data_b64"]) == mhd_pair
                and {k: fn.launches for k, fn in kernels.items()} == before,
                f"idempotent retry: {status} {headers.get('X-Nm03-Cache')}")
        statuses[200] += 2

        # two identical studies at once: the gang gate is held until the
        # second has joined the first, so they make one dispatch
        pid = pids[-1]
        reset()
        out = {}

        def send(i):
            out[i] = http_post(vurl + "?output=summary", studies[pid], {"Content-Type": parts})

        coalesced0 = app.volume_inflight.stats()["coalesced"]
        with app.batcher.gang_parked():
            threads = [threading.Thread(target=send, args=(0,))]
            threads[0].start()
            deadline = time.monotonic() + 60
            while app.volume_inflight.stats()["in_flight"] < 1 and time.monotonic() < deadline:
                # nm03-lint: disable=NM422 the drill holds the gang gate on purpose: the lanes stay parked until the first study is in flight
                time.sleep(0.001)
            threads.append(threading.Thread(target=send, args=(1,)))
            threads[1].start()
            while (app.volume_inflight.stats()["coalesced"] == coalesced0
                   and time.monotonic() < deadline):
                # nm03-lint: disable=NM422 same deliberate drill hold: the second study must coalesce onto the first before the gate opens
                time.sleep(0.001)
        for t in threads:
            t.join(timeout=120)
        require(not any(t.is_alive() for t in threads), "a coalesced request hung")
        for status, payload, _, _ in out.values():
            statuses[status] = statuses.get(status, 0) + 1
            require(status == 200, f"coalesced: {status}")
            check_study(pid, payload, with_mask=False)
        coalesce_launches = {k: fn.launches for k, fn in kernels.items()}
        require(coalesce_launches == launch_dict(fused=1, grow=0, median=0)
                and sorted(r[2]["X-Nm03-Cache"] for r in out.values()) == ["fill", "hit"],
                f"two identical studies: launches {coalesce_launches}")

        # slices while studies run: every slice 200 and equal to the driver's
        vjobs = [(pid, body, {"Content-Type": parts}) for pid, body in
                 list(studies.items())[:SERVE_VOLUME_MIXED]]
        sjobs = [((p_, stem), raw, {"Content-Type": "application/dicom"})
                 for p_, stem, raw in slices[:: max(1, len(slices) // SERVE_VOLUME_MIXED_SLICES)]]
        mixed = {}
        vt = threading.Thread(target=lambda: mixed.update(
            vol=client_run(vurl + "?output=summary&compressed=1", vjobs, 2)))
        vt.start()
        sres, _ = client_run(base + "/v1/segment?output=mask", sjobs, 4)
        vt.join(timeout=600)
        require("vol" in mixed, "the mixed run's volumes did not finish")
        tally(sres)
        tally(mixed["vol"][0])
        for (p_, stem), (_, payload, _, _) in sres.items():
            require(payload["mask_sha256"] == sha(dmasks[(p_, stem)]),
                    f"slice {p_}/{stem} during volumes: mask != the driver's")
        for pid, (_, payload, _, _) in mixed["vol"][0].items():
            check_study(pid, payload, with_mask=False)
        mixed_gang_wait = [p["gang_wait_s"] for _, p, _, _ in mixed["vol"][0].values()]
    finally:
        app.begin_drain(reason="chip_smoke")
        httpd.shutdown()
        httpd.server_close()
        app.close()

    phase_step("main_server")
    # a server started with --distributed-init in a world-of-1 job under
    # NCCL: the gang's z-mesh is the process group, its broadcasts, counts
    # and gather on the card; the cohort again, each study = the golden
    import torch.distributed as dist

    from nm03_capstone_project_tpu_torch.parallel import distributed
    from nm03_capstone_project_tpu_torch.serving import server as server_mod

    require(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda"),
            "world of 1: no process group")
    try:
        # the gang's dispatch headers travel on the host over gloo, beside NCCL
        require(dist.get_backend() == "nccl"
                and dist.get_backend(distributed.control_group()) == "gloo",
                "a world of 1 under NCCL has no gloo side group for the gang's headers")
        dflags = server_mod.build_parser().parse_args(
            ["--canvas", str(size), "--buckets", "1", "--volume-serving", "--distributed-init",
             "--volume-depth-buckets", ",".join(str(b) for b in SERVE_VOLUME_BUCKETS),
             "--result-cache-bytes", "1g"])
        require(server_mod._join_job(dflags) is None, "rank 0 of a world of 1 did not serve")
        dapp = server_mod.app_from_args(dflags)
        dhttpd, _, dport = serve_in_thread(dapp)
        try:
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{dport}/readyz", timeout=30) as r:
                dvols = json.loads(r.read())["volumes"]
            require(dvols["distributed"] is True and dvols["processes"] == 1
                    and dvols["z_shards"] == 1 and dvols["ready"] is True,
                    f"the --distributed-init server's volumes block {dvols}")
            reset()
            res, wall = client_run(f"http://127.0.0.1:{dport}/v1/segment-volume",
                                   cohort_jobs("d"), 1)
            tally(res)
            for pid, (_, payload, _, _) in res.items():
                check_study(pid, payload)
            dist_launches = {k: fn.launches for k, fn in kernels.items()}
            require(dist_launches == launch_dict(fused=n_pat, grow=0, median=0),
                    f"the --distributed-init server's launches {dist_launches}")
            distributed_run = {**latency_stats(res, wall), "volumes": dvols,
                               "launches": dist_launches, "header_group": "gloo"}
            distributed_run["volumes_per_s"] = distributed_run.pop("requests_per_s")
        finally:
            dapp.begin_drain(reason="chip_smoke")
            dhttpd.shutdown()
            dhttpd.server_close()
            dapp.close()
    finally:
        distributed.shutdown()

    phase_step("distributed_server")
    # the same cohort jobs under the profiler, on a second server (a fresh
    # result store, so every study is dispatched again): the device's idle
    # share, and what the profiler costs the wall
    papp = ServingApp(cfg=cfg, buckets=(1,), result_cache_bytes=1 << 30, volume_serving=True,
                      volume_depth_buckets=SERVE_VOLUME_BUCKETS)
    phttpd, _, pport = serve_in_thread(papp)
    profiled = {}
    try:
        reset()
        for conc, query in SERVE_VOLUME_RUNS:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res, wall = client_run(f"http://127.0.0.1:{pport}/v1/segment-volume" + query,
                                       cohort_jobs(conc), conc)
                torch.cuda.synchronize()
            busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
            tally(res)
            for pid, (_, payload, _, _) in res.items():
                check_study(pid, payload)
            profiled[conc] = {**latency_stats(res, wall), "device_busy_ms":
                              busy_ms if busy_ms > 0 else "not measured",
                              "idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms > 0
                              else "not measured"}
            profiled[conc]["volumes_per_s"] = profiled[conc].pop("requests_per_s")
        plaunches = {k: fn.launches for k, fn in kernels.items()}
        require(plaunches == main_launches, f"the profiled studies' launches {plaunches}")
    finally:
        papp.begin_drain(reason="chip_smoke")
        phttpd.shutdown()
        phttpd.server_close()
        papp.close()

    phase_step("profiled_server")
    # the server's own split of a study's time, from its trace spans
    split, by_trace = {}, {}
    for line in log_json.read_text().splitlines():
        ev = json.loads(line)
        tid = ev.get("trace_id") or ""
        if ev.get("event") != "serve_trace" or not ev.get("volume") or ev.get("cached"):
            continue
        conc = tid.split("-", 1)[0]
        if conc not in ("c1", "c4"):
            continue
        for sp in ev["spans"]:
            split.setdefault(conc, {}).setdefault(sp["name"], []).append(sp["dur_s"] * 1e3)
        by_trace[tid] = ev["spans"]
    split_ms = {c: {n: statistics.median(v) for n, v in d.items()} for c, d in split.items()}
    require(all(split_ms.get(f"c{c}", {}).keys() >= {
        "queue_wait", "volume_gang_acquire", "volume_dispatch", "volume_gather", "encode"}
        for c, _ in SERVE_VOLUME_RUNS), f"the server's spans: {split_ms}")

    # the wall of each served study as the client saw it, split: admission
    # wait (the gang's queue and the slice batcher's parking), staging (the
    # slabs to the card) and the gang's program (host time: its launches
    # and the growth's count syncs), the mask's fetch, the payload's
    # encode, and the rest (the body's decode, the JSON reply over HTTP,
    # the client), each the median over the run's studies
    wall_split_ms = {}
    for conc, res in main_res.items():
        parts_ms = {}
        for pid, (_, _, _, secs) in res.items():
            spans = {}
            for sp in by_trace[f"c{conc}-{pid}"]:
                spans.setdefault(sp["name"], []).append(sp)
            (disp,) = spans["volume_dispatch"]
            row = {"admission_wait": (spans["queue_wait"][0]["dur_s"]
                                      + spans["volume_gang_acquire"][0]["dur_s"]) * 1e3,
                   "staging": disp["stage_s"] * 1e3, "gang_program": disp["program_s"] * 1e3,
                   "mask_fetch": spans["volume_gather"][0]["dur_s"] * 1e3,
                   "encode": spans["encode"][0]["dur_s"] * 1e3}
            row["rest"] = secs * 1e3 - sum(row.values())
            row["wall"] = secs * 1e3
            for k, v in row.items():
                parts_ms.setdefault(k, []).append(v)
        wall_split_ms[f"c{conc}"] = {k: statistics.median(v) for k, v in parts_ms.items()}

    phase_step("wall_split")
    # host costs of one study alone: decoding its 25 parts, and base64 + JSON
    # of its 1.6 MB mask (median of 20)
    def host_ms(fn):
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    mask = dmasks[(slices[0][0], slices[0][1])]
    one = np.stack([mask] * n_sl)
    host_cost_ms = {
        "decode_25_parts": host_ms(lambda: [read_dicom_bytes(r) for _, _, r in slices[:n_sl]]),
        "b64_json_mask": host_ms(lambda: json.dumps(
            {"mask_b64": base64.b64encode(one.tobytes()).decode("ascii")})),
    }

    phase_step("host_costs")
    # the unfused server: the standalone median kernel, once a study
    ucfg = PipelineConfig(canvas=size, fuse_preprocess=False)
    uapp = ServingApp(cfg=ucfg, buckets=(1,), volume_serving=True,
                      volume_depth_buckets=(SERVE_VOLUME_BUCKETS[-1],))
    uhttpd, _, uport = serve_in_thread(uapp)
    try:
        pid = pids[1]
        reset()
        status, payload, _, _ = http_post(f"http://127.0.0.1:{uport}/v1/segment-volume",
                                          studies[pid], {"Content-Type": parts})
        ulaunch = {k: fn.launches for k, fn in kernels.items()}
        statuses[status] = statuses.get(status, 0) + 1
        require(status == 200, f"unfused study: {status}")
        check_study(pid, {**payload, "mask_sha256": sha(served_mask(payload))})
        require(ulaunch == launch_dict(fused=0, grow=0, median=1), f"unfused launches {ulaunch}")
    finally:
        uapp.begin_drain(reason="chip_smoke")
        uhttpd.shutdown()
        uhttpd.server_close()
        uapp.close()

    phase_step("unfused_server")
    # the kernels at the shapes the gang gives them (the fused kernel's tile
    # plan is chosen by the depth): a cohort study padded to the 32-plane
    # bucket and the 13-plane phantom padded to 16, each bitwise against
    # its plain version
    kw = preprocess_kwargs(cfg)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ph13 = next(ph for ph in golden_file["phantoms"] if ph["shape"][0] == 13)
    bucket_inputs = {
        "cohort_study": decoded[pids[0]],
        "phantom13": phantom_volume(*ph13["shape"], seed=ph13["seed"]).astype(np.float32),
    }
    bucket_checks = {}
    for name, vol in bucket_inputs.items():
        d, h, w = vol.shape
        bucket = next(b for b in SERVE_VOLUME_BUCKETS if d <= b)
        stack = np.zeros((bucket, size, size), np.float32)
        stack[:d, :h, :w] = vol
        dm = torch.tensor([h, w], dtype=torch.int32, device="cuda").expand(bucket, 2)
        x = extend_edges(torch.from_numpy(stack).cuda(), dm)
        got, want = hm.fused_preprocess_kernel(x, **kw), hm._fused_preprocess_plain(x, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"fused kernel != plain ({name} at {bucket} planes)")
        m = clip_intensity(normalize(x, cfg.norm_low, cfg.norm_high, cfg.norm_intensity_min,
                                     cfg.norm_intensity_max), cfg.clip_low, cfg.clip_high)
        mgot = hm.vector_median_filter_kernel(m, cfg.median_window)
        mwant = vector_median_filter(m, cfg.median_window)
        torch.cuda.synchronize()
        require(torch.equal(mgot, mwant), f"median kernel != plain ({name} at {bucket} planes)")
        bucket_checks[name] = {
            "shape": [bucket, size, size], "planes": d,
            "fused_launch_shape": list(hm.fused_launch_shape(
                bucket, size, size, cfg.median_window, cfg.sharpen_kernel, n_sm)),
            "fused_max_abs_err": max_abs(got, want), "median_max_abs_err": max_abs(mgot, mwant)}
    del x, m, got, want, mgot, mwant

    phase_step("bucket_kernels")
    # the plain merge and sort medians on the card: the pruned plan's bits
    x = (torch.rand(MAIN_SHAPE, generator=torch.Generator().manual_seed(11)) * 4000
         + 0.68).cuda()
    impls = {}
    for k in (3, 7, 15):
        pruned = vector_median_filter(x, k)
        for name, fn in (("merge", vector_median_filter_merge),
                         ("sort", vector_median_filter_sort)):
            require(torch.equal(fn(x, k), pruned), f"{name} median k={k} != pruned on the card")
            impls.setdefault(name, []).append(k)
    del x, pruned

    phase_step("plain_medians")
    # the main path: the cohort at concurrency 1 and 4, and again through
    # the --distributed-init server
    launches = {k: main_launches[k] + distributed_run["launches"][k] for k in kernels}
    launches["median"] = ulaunch["median"]
    phase_step("tally")
    emit({"phase": "serve_volume", "studies": n_pat, "planes": n_pat * n_sl, "size": size,
          "depth_buckets": list(SERVE_VOLUME_BUCKETS), "statuses": statuses,
          "checks": [f"{dispatched} cohort studies (x-nm03-dicom-parts) = "
                     "volume_golden.json, concurrency 1 and 4",
                     "phantoms of depth 13, 20, 32 (raw) = volume_golden.json; 40 -> 413",
                     "?output=mhd = the volume CLI's mask.mhd pair",
                     "idempotency-key retry with another study: hit, same ETag and "
                     "MHD pair, no launch",
                     "two identical studies: one fused launch",
                     "slices during studies: 200 and = the driver's masks",
                     "unfused server: one median launch",
                     "fused and median kernels = plain at the 32- and 16-plane buckets",
                     "merge and sort medians on the card = pruned",
                     "--distributed-init server in a world of 1 (nccl): 20 cohort studies = "
                     "volume_golden.json, /readyz volumes.distributed true"],
          "concurrency1": runs[1], "concurrency4": runs[4],
          "profiled": {f"concurrency{c}": v for c, v in profiled.items()},
          "gang_alone": {f"concurrency{c}": v for c, v in gang_alone.items()},
          "bucket_kernels": bucket_checks,
          "server_split_ms": split_ms, "wall_split_ms": wall_split_ms,
          "distributed": distributed_run, "host_cost_ms": host_cost_ms,
          "fused_launches_per_study": main_launches["fused"] / dispatched,
          "phantoms": phantoms, "coalesce_launches": coalesce_launches,
          "mixed": {"slices": len(sres), "studies": len(vjobs),
                    "gang_wait_s_max": max(mixed_gang_wait)},
          "unfused_launches": ulaunch, "medians_on_card": impls,
          "serve_volume_launches": launches, "seconds": time.perf_counter() - phase_t0,
          "steps_s": phase_step.spent,
          "nvidia_smi": smi})
    return launches


def conv_flops(model, shape) -> float:
    """Multiply-adds x 2 of every convolution of one forward pass of
    ``model`` on an input of ``shape``, counted from the convs' outputs."""
    from nm03_capstone_project_tpu_torch.models.unet import Conv

    total = [0.0]

    def hook(mod, inp, out):
        taps = mod.weight[0].numel()  # Cin x the kernel's taps
        total[0] += 2.0 * out.numel() * taps

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model(torch.zeros((1,) + tuple(shape[1:]), device=next(model.parameters()).device),
                  torch.bfloat16)
    finally:
        for h in hooks:
            h.remove()
    return total[0] * shape[0]


def step_kernels(fn) -> dict:
    """One call of ``fn`` under the profiler: device busy ms, the wall, and
    the 8 kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy if rows else "not measured",
            "kernels": len(rows), "launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in rows[:8]]}


def student_phase(tmp: Path, driver_out: dict, volume_out: dict, smi: str, kernels: dict,
                  reset) -> dict:
    """The U-Net students on the card (phase 9 of the docstring).

    Returns the teacher's kernel launches while the two training runs
    distilled their labels (2D and 3D summed).
    """
    import contextlib
    import io

    from nm03_capstone_project_tpu_torch import models as pm
    from nm03_capstone_project_tpu_torch.cli import parallel as parallel_cli
    from nm03_capstone_project_tpu_torch.cli import train as train_cli
    from nm03_capstone_project_tpu_torch.cli import volume as volume_cli
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.data.discovery import find_patient_dirs
    from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage

    phase_t0 = time.perf_counter()
    cohort = driver_out["cohort"]
    n_pat, n_sl, size = DRIVER_COHORT
    n = n_pat * n_sl
    cfg = PipelineConfig(canvas=size)
    steps_2d, steps_3d = STUDENT_STEPS

    def train(out: Path, *extra, said=None):
        """cli.train.main; (results JSON, printed first and last loss,
        seconds). ``said`` collects what it printed."""
        rj = out.parent / (out.name + ".json")
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(["--base-path", str(cohort), "--output", str(out),
                                 "--results-json", str(rj), "--canvas", str(size), *extra])
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        if said is not None:
            said.append(text)
        require(rc == 0, f"train {out.name} exited {rc}: {text[-400:]}")
        m = re.search(r"loss (\S+) -> (\S+)", text)
        losses = (float(m.group(1)), float(m.group(2))) if m else None
        return json.loads(rj.read_text()), losses, secs

    def iou(pairs) -> float:
        inter = union = 0
        for pred, truth in pairs:
            pred, truth = np.asarray(pred).astype(bool), np.asarray(truth).astype(bool)
            inter += int((pred & truth).sum())
            union += int((pred | truth).sum())
        return inter / union if union else 1.0

    phase_step = StepTimer(phase_t0)
    phase_step("setup")

    # -- 2D distillation at full width: 256 slices, 300 steps, bf16 --------
    reset()  # the main path's run: the teacher's launches while it labels
    rec2, loss2, train2_s = train(tmp / "student2d", "--max-slices", "256",
                                  "--steps", str(steps_2d), "--bf16")
    launches_2d = {k: fn.launches for k, fn in kernels.items()}
    require(launches_2d["fused"] > 0 and launches_2d["grow"] > 0
            and launches_2d["seeds"] == launches_2d["finish"] == launches_2d["fused"],
            f"the 2D teacher did not launch its kernels: {launches_2d}")
    require(rec2["slices"] == min(256, n) and rec2["steps"] == steps_2d,
            f"2D training: {rec2['slices']} slices, {rec2['steps']} steps")
    require(loss2 is not None and all(np.isfinite(loss2)) and loss2[1] < 0.7 * loss2[0],
            f"2D loss did not fall: {loss2}")
    require(rec2["iou_vs_teacher"] > 0.6, f"2D IoU vs the teacher {rec2['iou_vs_teacher']}")
    ckpt2 = tmp / "student2d" / "checkpoint"
    rec_eval, _, eval_s = train(tmp / "student2d_eval", "--max-slices", "256", "--eval-only",
                                "--restore", str(ckpt2), "--bf16")
    require(rec_eval["steps"] == 0
            and round(rec_eval["iou_vs_teacher"], 4) == round(rec2["iou_vs_teacher"], 4),
            f"eval-only IoU {rec_eval['iou_vs_teacher']} != {rec2['iou_vs_teacher']}")

    phase_step("train_2d")
    # -- 3D distillation: 20 volumes of 8 planes, 100 steps, bf16 ---------
    reset()
    rec3, loss3, train3_s = train(tmp / "student3d", "--model-3d", "--volume-depth", "8",
                                  "--steps", str(steps_3d), "--bf16")
    launches_3d = {k: fn.launches for k, fn in kernels.items()}
    # the teacher's labels: process_volume, the fused kernel and the 3D
    # grow kernel once a volume
    require(rec3["volumes"] == n_pat
            and launches_3d == launch_dict(fused=n_pat, grow3d=n_pat, **per_entry(n_pat)),
            f"3D training: {rec3['volumes']} volumes, launches {launches_3d}")
    require(loss3 is not None and all(np.isfinite(loss3)) and loss3[1] < 0.7 * loss3[0],
            f"3D loss did not fall: {loss3}")
    require(rec3["iou_vs_teacher"] > 0.6, f"3D IoU vs the teacher {rec3['iou_vs_teacher']}")
    ckpt3 = tmp / "student3d" / "checkpoint"

    phase_step("train_3d")
    # -- the f32 forward on the card = the CPU, with TF32 allowed globally --
    model, _ = pm.load_params(ckpt2, device="cuda")
    cpu_model, _ = pm.load_params(ckpt2, device="cpu")
    vol, _, _, _ = volume_cli._load_volume(cohort, find_patient_dirs(cohort)[0], cfg)
    x_cpu = pm.prepare_student_inputs(torch.from_numpy(vol), cfg)
    require(tuple(x_cpu.shape) == (n_sl, size, size), f"forward batch {tuple(x_cpu.shape)}")
    torch.backends.cudnn.allow_tf32 = True  # the model must turn it off itself
    try:
        with torch.no_grad():
            f32 = model(x_cpu.cuda(), torch.float32).cpu()
            require(torch.backends.cudnn.allow_tf32, "the forward left TF32 turned off")
            bf16 = model(x_cpu.cuda(), torch.bfloat16).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        want = cpu_model(x_cpu, torch.float32)
    scale = float(want.abs().max())
    f32_err = float((f32 - want).abs().max())
    require(f32_err <= STUDENT_F32_RTOL * scale,
            f"f32 forward on the card vs the CPU: {f32_err} > {STUDENT_F32_RTOL} x {scale}")
    differ = (bf16 > 0) != (f32 > 0)
    worst = float(f32.abs()[differ].max()) if bool(differ.any()) else 0.0
    require(worst < STUDENT_DELTA,
            f"bf16 and f32 masks differ where |f32 logit| = {worst} >= {STUDENT_DELTA}")
    # the same forward with the model's guard bypassed runs its convs in
    # TF32: the bound above must catch it
    from nm03_capstone_project_tpu_torch.models import unet as unet_mod

    guard = unet_mod.conv_precision
    unet_mod.conv_precision = lambda dtype, device: contextlib.nullcontext()
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32 = model(x_cpu.cuda(), torch.float32).cpu()
    finally:
        unet_mod.conv_precision = guard
        torch.backends.cudnn.allow_tf32 = False
    tf32_err = float((tf32 - want).abs().max())
    require(tf32_err > STUDENT_F32_RTOL * scale,
            f"a TF32 forward passes the f32 bound: {tf32_err} <= {STUDENT_F32_RTOL} x {scale}")
    forward = {"shape": list(x_cpu.shape), "f32_max_abs_err_vs_cpu": f32_err,
               "tf32_max_abs_err_vs_cpu": tf32_err,
               "f32_tolerance": STUDENT_F32_RTOL * scale, "max_abs_logit": scale,
               "bf16_max_abs_diff_vs_f32": float((bf16 - f32).abs().max()),
               "delta": STUDENT_DELTA, "bf16_mask_differ_share": float(differ.float().mean()),
               "max_abs_f32_logit_where_differ": worst}
    del cpu_model

    phase_step("tf32_guard")
    # -- deployment: the parallel driver's CLI and the volume CLI, --model --
    # the student's CLI run hands its masks to a mask_sink; then the
    # classical CLI runs for slices/s beside it in the same turn
    from nm03_capstone_project_tpu_torch.cli import runner as runner_mod

    masks, lock = {}, threading.Lock()

    def sink(pid, stem, m):
        with lock:
            masks[(pid, stem)] = np.array(m, copy=True)

    class SinkingProcessor(runner_mod.CohortProcessor):
        def __init__(self, *args, **kw):
            super().__init__(*args, mask_sink=sink, **kw)

    rates, timing, deploy_launches = {}, {}, None
    for i, which in enumerate(DEPLOY_TURNS):
        rj, out = tmp / f"deploy_{i}.json", tmp / f"deploy_{i}"
        argv = ["--base-path", str(cohort), "--output", str(out), "--results-json", str(rj),
                "--canvas", str(size)]
        real = runner_mod.CohortProcessor
        if which == "student":
            runner_mod.CohortProcessor = SinkingProcessor
            argv += ["--model", str(ckpt2)]
        reset()
        try:
            rc = parallel_cli.main(argv)
        finally:
            runner_mod.CohortProcessor = real
        if which == "student":
            deploy_launches = {k: fn.launches for k, fn in kernels.items()}
        require(rc == 0, f"parallel CLI run {i} ({which}) exited {rc}")
        rec = json.loads(rj.read_text())
        jpegs = len(files_of(out))
        kl = rec["kernel_launches"]
        require(rec["summary"]["slices_ok"] == n and jpegs == 2 * n
                and (sum(kl.values()) == 0) == (which == "student"),
                f"parallel CLI run {i} ({which}): {rec['summary']['slices_ok']} slices, "
                f"{jpegs} JPEGs, launches {kl}")
        rates.setdefault(which, []).append(n / rec["wall_s"])
        timing.setdefault(which, {"wall_s": rec["wall_s"], "timing_s": rec["timing_s"]})
        shutil.rmtree(out)
    require(len(masks) == n and sum(deploy_launches.values()) == 0,
            f"student deployment: the sink saw {len(masks)} slices, launches {deploy_launches}")
    teacher = driver_out["masks"]
    par_iou = iou((masks[k], teacher[k]) for k in teacher)
    require(par_iou > 0.6, f"the parallel driver's student IoU vs the teacher {par_iou}")

    rj = tmp / "student_vol.json"
    rc = volume_cli.main(["--base-path", str(cohort), "--output", str(tmp / "student_vol"),
                          "--results-json", str(rj), "--canvas", str(size), "--export-mhd",
                          "--model", str(ckpt3)])
    require(rc == 0, f"volume CLI --model exited {rc}")
    vol_rec = json.loads(rj.read_text())
    pats = vol_rec["patients"]
    require(len(pats) == n_pat and sum(p["exported"] for p in pats.values()) == n
            and sum(vol_rec["kernel_launches"].values()) == 0,
            f"volume CLI --model: {len(pats)} patients, launches {vol_rec['kernel_launches']}")
    vmasks = {pid: read_metaimage(tmp / "student_vol" / pid / "mask.mhd")[0] for pid in pats}
    require(all(m.shape == (n_sl, size, size) for m in vmasks.values()),
            "volume CLI --model: a mask is not cropped back to its 25 planes")
    vol_iou = iou((vmasks[p], volume_out["masks"][p]) for p in pats)
    phase_step("deploy_turns")
    # the planes it was trained on: each series' first 8
    vol_iou_8 = iou((vmasks[p][:8], volume_out["masks"][p][:8]) for p in pats)
    # two patients' exported masks (of distinct teacher masks) held to the
    # student run on the CPU in f32; a hook keeps the CPU logits, which are
    # cropped and masked by hand
    cpu3, _ = pm.load_params(ckpt3, device="cpu")
    cpu_fn = volume_cli._make_student_volume_fn(cpu3, cfg)
    seen = []
    hook = cpu3.register_forward_hook(lambda mod, inp, out: seen.append(out))
    first = sorted(pats)[0]
    other = next((p for p in sorted(pats)
                  if not np.array_equal(volume_out["masks"][p], volume_out["masks"][first])),
                 sorted(pats)[-1])
    vol_held = {}
    try:
        for pid in (first, other):
            v, d, _, _ = volume_cli._load_volume(cohort, pid, cfg)
            seen.clear()
            want3 = cpu_fn(torch.from_numpy(v), torch.from_numpy(d)).numpy().astype(bool)
            (lg,) = seen
            depth = v.shape[0]
            require(tuple(lg.shape) == (1, depth + (-depth) % 2**cpu3.levels, size, size),
                    f"volume student {pid}: logits {tuple(lg.shape)} for {depth} planes")
            lg = lg[0, :depth].numpy()
            inside = np.zeros((size, size), bool)
            inside[: d[0], : d[1]] = True
            require(np.array_equal(want3, (lg > 0) & inside),
                    f"volume student {pid}: the CPU mask is not its cropped logits > 0")
            differ = vmasks[pid].astype(bool) != want3
            worst = float(np.abs(lg)[differ].max()) if differ.any() else 0.0
            require(worst < STUDENT_DELTA,
                    f"volume student {pid}: card and CPU masks differ where |f32 logit| = "
                    f"{worst} >= {STUDENT_DELTA}")
            vol_held[pid] = {"voxels_cpu": int(want3.sum()), "voxels_card": int(vmasks[pid].sum()),
                             "differ_share": float(differ.mean()),
                             "max_abs_f32_logit_where_differ": worst}
    finally:
        hook.remove()
    del cpu3
    per_plane = {"patient": first, "student": vmasks[first].sum(axis=(1, 2)).tolist(),
                 "teacher": volume_out["masks"][first].sum(axis=(1, 2)).tolist()}

    phase_step("student_vs_cpu")
    # -- one training step, timed: 256 slices, bf16 and f32 ----------------
    planes = [volume_cli._load_volume(cohort, pid, cfg)[0] for pid in find_patient_dirs(cohort)]
    px = torch.from_numpy(np.concatenate(planes)[:256]).cuda()
    dims = torch.full((px.shape[0], 2), size, dtype=torch.int32, device=px.device)
    labels = pm.distill_batch(px, dims, cfg)
    x = pm.prepare_student_inputs(px, cfg)
    step_flops = 3 * conv_flops(model, tuple(x.shape))  # forward + backward ~ 3 forwards
    step_ms, bound_ms, step_profile = {}, {}, {}
    for name, dtype, peak in (("bf16", torch.bfloat16, PEAK_BF16_FLOPS),
                              ("f32", torch.float32, PEAK_F32_FLOPS)):
        net = pm.init_unet(torch.Generator().manual_seed(0), base=16, device="cuda")
        opt = pm.make_optimizer(net.parameters(), 3e-3, total_steps=steps_2d)

        def step():
            pm.train_step(net, opt, x, labels, dims, dtype)

        step_ms[name] = cuda_ms(step, repeats=STUDENT_TIMED_STEPS)
        bound_ms[name] = step_flops / peak * 1e3
        step_profile[name] = step_kernels(step)
        del net, opt, step
        torch.cuda.empty_cache()

    phase_step("step_timing")
    # -- the 2D student beyond one device: dp x tp over [cuda:0] x 4 as
    # (data, model) = (2, 2), and data parallel across the ranks of a world
    # of 1 under NCCL; f32 (TF32 off), held to one device's curve ----------
    import torch.distributed as dist

    from nm03_capstone_project_tpu_torch.parallel import make_mesh
    from nm03_capstone_project_tpu_torch.parallel import mesh as mesh_mod

    dev = torch.device("cuda", 0)
    smesh = make_mesh(devices=[dev] * 4, axis_names=("data", "model"), axis_sizes=(2, 2))

    def seeded():
        return pm.init_unet(torch.Generator().manual_seed(0), base=16, device=dev)

    def rel_gap(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    _, curve_one = pm.fit(seeded(), x, labels, dims, steps=STUDENT_SHARD_STEPS, lr=3e-3)
    _, curve_mesh = pm.fit_sharded(seeded(), x, labels, dims, smesh, steps=STUDENT_SHARD_STEPS,
                                   lr=3e-3)
    require(len(curve_mesh) == len(curve_one) == STUDENT_SHARD_STEPS
            and rel_gap(curve_mesh, curve_one) <= STUDENT_SHARD_RTOL,
            f"fit_sharded (2 x 2) curve {curve_mesh} vs one device {curve_one}")
    # fit_distributed in a world of 1 under NCCL: its gradient all_reduce on
    # the card, from the same seeded init at the training rate
    from nm03_capstone_project_tpu_torch.parallel import distributed

    require(distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda"),
            "world of 1: no process group")
    try:
        require(dist.get_backend() == "nccl", "fit_distributed's world of 1 is not NCCL")
        _, curve_job = pm.fit_distributed(seeded(), x, labels, dims, steps=STUDENT_SHARD_STEPS,
                                          lr=3e-3)
    finally:
        distributed.shutdown()
    require(len(curve_job) == STUDENT_SHARD_STEPS
            and rel_gap(curve_job, curve_one) <= STUDENT_SHARD_RTOL,
            f"fit_distributed (world of 1) curve {curve_job} vs one device {curve_one}")
    require(abs(curve_one[-1] - curve_one[0]) / curve_one[0] > 10 * STUDENT_SHARD_RTOL,
            f"the one-device curve {curve_one} barely moved: the comparison would hold nothing")
    step_fn, _ = pm.make_sharded_train_step(smesh, seeded(), 3e-3, steps_2d, torch.float32)
    sharded_step_ms = cuda_ms(lambda: step_fn(x, labels, dims), repeats=STUDENT_TIMED_STEPS)
    del step_fn
    torch.cuda.empty_cache()

    phase_step("multi_device_fit")
    # the train driver three ways on the same 256 slices, each continuing
    # the trained 2D student (so that the IoU has something to hold): one
    # device, its local devices patched to [cuda:0] x 4 (dp 2 x tp 2),
    # --distributed
    dargs = ("--max-slices", "256", "--steps", str(STUDENT_SHARD_STEPS), "--restore",
             str(ckpt2), "--lr", str(STUDENT_FINE_TUNE_LR))
    drivers, said = {}, []
    multi_launches = {k: 0 for k in kernels}
    real_local_devices = mesh_mod.local_devices
    for tag, extra in (("one", ()), ("mesh", ()),
                       ("world1", ("--distributed", "--coordinator-address",
                                   f"127.0.0.1:{free_port()}", "--num-processes", "1",
                                   "--process-id", "0"))):
        if tag == "mesh":
            mesh_mod.local_devices = lambda device=None: [dev] * 4
        reset()
        try:
            rec, printed, secs = train(tmp / f"student2d_{tag}", *dargs, *extra, said=said)
        finally:
            mesh_mod.local_devices = real_local_devices
        got = {k: fn.launches for k, fn in kernels.items()}
        require(got == launch_dict(fused=1, grow=1, **per_entry(1)),
                f"train driver ({tag}): the teacher's launches {got}")
        multi_launches = {k: multi_launches[k] + got[k] for k in kernels}
        require(not dist.is_initialized(), f"train driver ({tag}) left its process group")
        require(printed is not None, f"train driver ({tag}) printed no loss")
        drivers[tag] = {"first_loss": printed[0], "final_loss": rec["final_loss"],
                        "iou": rec["iou_vs_teacher"], "cli_s": secs, "launches": got}
        print(f"chip_smoke: train driver ({tag}): loss {printed[0]} -> {rec['final_loss']}",
              flush=True)
        # the fine-tune must move the loss by more than the tolerance the
        # three runs are held to, or their agreement would hold nothing
        require(abs(printed[0] - rec["final_loss"]) / rec["final_loss"] > STUDENT_SHARD_RTOL,
                f"train driver ({tag}): the fine-tune moved the loss {printed[0]} -> "
                f"{rec['final_loss']} by no more than rtol {STUDENT_SHARD_RTOL}")
    require("on 4 devices (dp=2 x tp=2)" in said[1], "the train driver did not run dp x tp")
    require("over 1 processes x 1 device (global batch 256)" in said[2],
            "the train driver did not train across the job's ranks")
    require(drivers["one"]["iou"] > 0.6, f"the fine-tuned student's IoU {drivers['one']}")
    for tag in ("mesh", "world1"):
        require(rel_gap([drivers[tag]["final_loss"]], [drivers["one"]["final_loss"]])
                <= STUDENT_SHARD_RTOL
                and abs(drivers[tag]["iou"] - drivers["one"]["iou"]) <= STUDENT_SHARD_IOU,
                f"train driver ({tag}) {drivers[tag]} vs one device {drivers['one']}")
    multi = {"steps": STUDENT_SHARD_STEPS, "rtol": STUDENT_SHARD_RTOL,
             "iou_atol": STUDENT_SHARD_IOU, "curve_one": curve_one, "curve_dp2_tp2": curve_mesh,
             "curve_max_rel_gap": rel_gap(curve_mesh, curve_one), "curve_world1": curve_job,
             "curve_world1_max_rel_gap": rel_gap(curve_job, curve_one), "drivers": drivers,
             "step_ms_f32": {"one_device": step_ms["f32"], "dp2_tp2": sharded_step_ms},
             "note": "one card named four times: the shards run one after another on it, "
                     "so dp x tp only adds work here",
             "nvidia_smi": smi}

    launches = {k: launches_2d[k] + launches_3d[k] + multi_launches[k] for k in kernels}
    phase_step("train_drivers")
    emit({"phase": "student", "cohort": {"patients": n_pat, "slices": n, "size": size},
          "checks": ["2D: 256 slices, 300 steps bf16, loss falls below 0.7x, IoU > 0.6",
                     "eval-only --restore: the same IoU to 4 decimals",
                     "3D: 20 volumes of 8 planes, 100 steps bf16, loss falls, IoU > 0.6",
                     "f32 forward on the card = the CPU with TF32 on (1e-5 x max logit, "
                     "which a TF32 forward misses); bf16 masks = f32 "
                     "outside delta",
                     "parallel CLI --model: 500/500 slices, 1000 JPEGs, IoU > 0.6",
                     "volume driver --model: 20/20 patients, 25-plane masks, two held to "
                     "the CPU f32 student outside delta",
                     "fit_sharded over [cuda:0] x 4 as (data, model) = (2, 2), and "
                     "fit_distributed in a world of 1 (nccl): the f32 loss curve from the "
                     "seeded init at lr 3e-3 = one device's within rtol 1e-3",
                     "train driver over 4 local devices (dp 2 x tp 2) and --distributed in a "
                     "world of 1 (nccl): final loss within rtol 1e-3 and IoU within 0.005 of "
                     "the one-device run, each moving its loss by more than 1e-3; one "
                     "fused and one grow launch each"],
          "multi_device": multi,
          "train_2d": {"steps": steps_2d, "first_loss": loss2[0], "last_loss": loss2[1],
                       "iou": rec2["iou_vs_teacher"], "eval_only_iou": rec_eval["iou_vs_teacher"],
                       "cli_s": train2_s, "eval_only_s": eval_s, "launches": launches_2d},
          "train_3d": {"steps": steps_3d, "volumes": rec3["volumes"], "depth": 8,
                       "first_loss": loss3[0], "last_loss": loss3[1],
                       "iou": rec3["iou_vs_teacher"], "cli_s": train3_s,
                       "launches": launches_3d},
          "step_ms": step_ms, "step_bound_ms": bound_ms, "step_gflop": step_flops / 1e9,
          "step_shape": list(x.shape), "step_profile": step_profile, "forward": forward,
          "deploy": {"parallel_iou": par_iou, "volume_iou": vol_iou,
                     "volume_iou_first_8_planes": vol_iou_8, "volume_voxels_per_plane": per_plane,
                     "volume_vs_cpu_f32": vol_held,
                     "parallel_slices_per_s": rates["student"],
                     "classical_slices_per_s": rates["classical"],
                     "driver_phase_slices_per_s": driver_out["slices_per_s"],
                     "parallel_launches": deploy_launches,
                     "parallel_timing": timing,
                     "volume_volumes_per_s": n_pat / vol_rec["wall_s"],
                     "volume_timings_s": vol_rec["timings_s"],
                     "classical_volumes_per_s": volume_out["volumes_per_s"]},
          "seconds": time.perf_counter() - phase_t0, "steps_s": phase_step.spent,
          "launches": launches, "nvidia_smi": smi})
    return launches


def operate_phase(tmp: Path, driver_out: dict, smi: str, kernels: dict, reset) -> dict:
    """The service on the card under load and under faults (phase 10 of the
    docstring). Returns the kernels' launches of its main path: the graph
    replays of both servers plus the driver drill's wrapper launches."""
    import urllib.error
    import urllib.request

    from nm03_capstone_project_tpu_torch.cli import parallel as parallel_cli
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.obs import flightrec
    from nm03_capstone_project_tpu_torch.obs.ledger import trace_events_from_capture
    from nm03_capstone_project_tpu_torch.obs.slo import SLOObjective
    from nm03_capstone_project_tpu_torch.resilience import FaultPlan, ResilienceConfig
    from nm03_capstone_project_tpu_torch.serving import loadgen
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    phase_t0 = time.perf_counter()
    cohort, dmasks, dfiles = driver_out["cohort"], driver_out["masks"], driver_out["files"]
    dicom = [(pid, f.stem, f.read_bytes()) for pid in find_patient_dirs(cohort)
             for f in load_dicom_files_for_patient(cohort, pid)]
    cfg = PipelineConfig(canvas=DRIVER_COHORT[2])
    buckets = {b: next(x for x in SERVE_BUCKETS if x >= b) for b in range(1, SERVE_BUCKETS[-1] + 1)}

    def get(url: str):
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def counter(app, name, **labels):
        m = app.registry.get(name, **labels)
        return 0 if m is None else m.value

    def capture_masks(app) -> dict:
        """Record each computed or cached 200's mask digest by trace id."""
        seen, real = {}, app.segment_cached

        def segment_cached(*args, **kw):
            out = real(*args, **kw)
            if out[0] is not None:
                seen[out[0]["trace_id"]] = (out[0]["shape"], out[0]["mask_sha256"])
            return out

        app.segment_cached = segment_cached
        return seen

    def check_masks(seen: dict, result, n_sent: int):
        """Every 200 of a loadgen run against the driver's (= golden) mask."""
        checked = 0
        for rec in result.requests:
            if rec["status"] != "ok":
                continue
            i = int(rec["id"].rsplit("-", 1)[1]) % len(dicom)
            pid, stem, _ = dicom[i]
            shape, sha = seen[rec["id"]]
            m = dmasks[(pid, stem)]
            require(sha == hashlib.sha256(np.ascontiguousarray(
                m[: shape[0], : shape[1]]).tobytes()).hexdigest(),
                f"served {pid}/{stem}: mask != the driver's")
            checked += 1
        require(checked == result.statuses["ok"] <= n_sent, "unchecked 200s")
        return checked

    def load(url: str, n: int, concurrency: int, rate: float, output: str):
        result = loadgen.LoadResult()
        payloads = [(body, {"Content-Type": "application/dicom"}) for _, _, body in dicom]
        summary = loadgen.run_load([f"{url}/v1/segment?output={output}"], payloads, n,
                                   concurrency, rate, 120.0, result)
        keep = ("mode", "requests_total", "requests_ok", "statuses", "throughput_rps",
                "latency_ms", "batch_sizes", "queue_wait_ms")
        return {k: summary[k] for k in keep}, result

    def rows_of(batch_sizes: dict):
        """Real and dead rows the loadgen's observed batch sizes imply."""
        real = padded = 0
        for b, n in batch_sizes.items():
            b = int(b)
            require(n % b == 0, f"{n} riders of batch size {b}")
            real += n
            padded += n // b * (buckets[b] - b)
        return real, padded

    # -- the server under its fault plan, the SLO and the ledger sampler ----
    flight_dir = tmp / "flight"
    flight_dir.mkdir()
    flightrec.configure(str(flight_dir))
    app = ServingApp(
        cfg=cfg, buckets=SERVE_BUCKETS, result_cache_bytes=1 << 30,
        fault_plan=FaultPlan.from_spec(OPERATE_PLAN),
        resilience=ResilienceConfig(dispatch_timeout_s=OPERATE_DEADLINE_S),
        lane_probe_interval_s=OPERATE_PROBE_S,
        slo=SLOObjective(availability_pct=OPERATE_SLO[0], latency_target_s=OPERATE_SLO[1] / 1e3),
        ledger_profile_interval_s=OPERATE_SAMPLER[0], ledger_profile_ms=OPERATE_SAMPLER[1],
    )
    httpd, _, port = serve_in_thread(app)
    base = f"http://127.0.0.1:{port}"
    try:
        reset()
        app.executor.reset_replays()  # the main path's run: replays from here count
        seen = capture_masks(app)

        # the drill: phantoms one at a time; dispatch 0 meets the two
        # transient fires, dispatch OPERATE_HANG_INDEX the hang
        c = cfg.canvas
        hdrs = {"Content-Type": "application/octet-stream", "X-Nm03-Height": str(c),
                "X-Nm03-Width": str(c - 16)}
        drill = []
        for i in range(OPERATE_HANG_INDEX + 1):
            img = phantom_slice(c, c - 16, seed=100 + i).astype("<f4").tobytes()
            status, payload, headers, dt = http_post(base + "/v1/segment?output=mask", img,
                                                     hdrs)
            drill.append({"status": status, "ms": dt * 1e3})
        want = [200] * OPERATE_HANG_INDEX + [504]
        require([d["status"] for d in drill] == want, f"drill statuses {drill}")
        t_fault = time.perf_counter()
        status, body, _ = get(base + "/readyz")
        st = json.loads(body)
        require(status == 503 and st["degraded"] and st["degraded_cause"] == "deadline",
                f"/readyz after the hang: {status} {st.get('degraded')}")
        while get(base + "/readyz")[0] != 200:
            require(time.perf_counter() - t_fault < 30, "the probe never reinstated the lane")
            time.sleep(0.05)
        reinstate_s = time.perf_counter() - t_fault
        # the repeated body: its stored entry reads corrupt once, is evicted
        # and recomputed, then served from the store
        img = phantom_slice(c, c - 16, seed=101).astype("<f4").tobytes()
        repeats = [http_post(base + "/v1/segment?output=mask", img, hdrs) for _ in range(2)]
        require([r[0] for r in repeats] == [200, 200]
                and [r[2].get("X-Nm03-Cache") for r in repeats] == ["fill", "hit"]
                and repeats[0][1]["mask_sha256"] == repeats[1][1]["mask_sha256"],
                f"corrupt entry: {[(r[0], r[2].get('X-Nm03-Cache')) for r in repeats]}")
        dumps = sorted(p.name for p in flight_dir.glob("*.json"))
        require(len(dumps) == 2 and any("lane0_quarantine_deadline" in d for d in dumps)
                and any("degraded_deadline" in d for d in dumps), f"flight dumps {dumps}")

        # traffic: the cohort from 16 clients, then an open loop below it
        rows0 = (counter(app, "serving_batch_rows_total", kind="real"),
                 counter(app, "serving_batch_rows_total", kind="padded"))
        closed, closed_res = load(base, len(dicom), SERVE_CONCURRENCY, 0.0, "jpeg")
        require(closed["statuses"] == {"ok": len(dicom)}, f"closed loop {closed['statuses']}")
        checked = check_masks(seen, closed_res, len(dicom))
        real, padded = rows_of(closed["batch_sizes"])
        rows = (counter(app, "serving_batch_rows_total", kind="real") - rows0[0],
                counter(app, "serving_batch_rows_total", kind="padded") - rows0[1])
        require(rows == (real, padded), f"rows {rows} != the batch arithmetic {(real, padded)}")
        rate = round(OPERATE_OPEN_SHARE * closed["throughput_rps"], 1)
        box = {}
        opener = threading.Thread(target=lambda: box.update(
            zip(("summary", "result"), load(base, OPERATE_OPEN_REQUESTS, 0, rate, "mask"))))
        opener.start()
        time.sleep(1.0)

        def debug_profile():
            """One /debug/profile capture's kernel names (409 while the
            sampler holds the profiler: asked again)."""
            tries = []
            while True:
                status, body, _ = get(base + "/debug/profile?ms=100")
                tries.append(status)
                if status != 409 or len(tries) >= 20:
                    break
                time.sleep(0.25)
            profile_tries.append(tries)
            require(status == 200, f"/debug/profile: {tries}")
            return {e.get("name", "") for e in trace_events_from_capture(json.loads(body))
                    if e.get("cat") == "kernel"}

        def has_replays(names):
            return (any("fused_kernel" in n for n in names)
                    and any("grow_kernel" in n for n in names))

        bursts = itertools.count()

        def burst():
            """64 phantom slices no earlier request sent (the result tier
            holds every cohort body by now), from 4 clients."""
            k = next(bursts)
            jobs = [(i, phantom_slice(c, c - 16, seed=1000 + 64 * k + i).astype("<f4")
                     .tobytes(), hdrs) for i in range(64)]
            res, _ = client_run(base + "/v1/segment?output=mask", jobs, 4)
            require(all(r[0] == 200 for r in res.values()), "a burst's slice failed")

        # a capture that missed the replays' kernels is asked for again, up
        # to PROFILE_TRIES captures, each beside its own burst after the
        # first (the open loop's); every capture missing fails the phase
        profile_tries, profile_missed = [], []
        names = debug_profile()
        opener.join(timeout=300)
        require(not opener.is_alive(), "the open loop hung")
        while not has_replays(names) and len(profile_missed) < PROFILE_TRIES - 1:
            profile_missed.append(sorted(names)[:12])
            burster = threading.Thread(target=burst)
            burster.start()
            time.sleep(0.3)
            names = debug_profile()
            burster.join(timeout=300)
        if not has_replays(names):
            profile_missed.append(sorted(names)[:12])
        require(len(profile_missed) < PROFILE_TRIES,
                f"{PROFILE_TRIES} /debug/profile captures missed the kernels: {profile_missed}")
        opened = box["summary"]
        require(opened["statuses"] == {"ok": OPERATE_OPEN_REQUESTS},
                f"open loop {opened['statuses']}")
        checked += check_masks(seen, box["result"], OPERATE_OPEN_REQUESTS)
        for path in ("/debug/flightrec", "/debug/result-cache"):
            require(get(base + path)[0] == 200, f"{path} did not answer 200")

        # the planes: ledger, saturation, SLO, and what the plan did
        time.sleep(OPERATE_SAMPLER[0] + 0.5)  # one more sample after the traffic
        st = json.loads(get(base + "/readyz")[1])
        metrics_text = get(base + "/metrics")[1].decode()
        led, sat, slo = st["ledger"], st["saturation"], st["slo"]
        busy = app.executor.busy_seconds
        require(abs(led["device_seconds_total"] - busy) <= 1e-6 * max(busy, 1.0),
                f"ledger {led['device_seconds_total']} != executor busy {busy}")
        shares = led["stage_shares"]
        # a pie whose samples all missed the replays' kernels gets another
        # sample beside a burst, up to PROFILE_TRIES pies
        pie_missed = []
        while not (shares.get("median7", 0) > 0 and shares.get("grow", 0) > 0):
            pie_missed.append(dict(shares))
            require(len(pie_missed) < PROFILE_TRIES,
                    f"{PROFILE_TRIES} pies missed the graph replays' kernels: {pie_missed}")
            burst()
            time.sleep(OPERATE_SAMPLER[0] + 0.5)
            st = json.loads(get(base + "/readyz")[1])
            led, sat, slo = st["ledger"], st["saturation"], st["slo"]
            shares = led["stage_shares"]
        require(abs(sum(shares.values()) - 1.0) <= 5e-4 * len(shares),
                f"stage shares sum {sum(shares.values())}")
        require(0 < sat["busy_fraction"] <= 1, f"busy fraction {sat['busy_fraction']}")
        lane0 = sat["lanes"][0]
        require(lane0["peak_flops"] == 67e12 and lane0["mfu"] is not None,
                f"saturation lane {lane0}")
        total = sat["rows"]["real"] + sat["rows"]["padded"]
        require(total > 0 and abs(sat["padding_waste_ratio"]
                                  - sat["rows"]["padded"] / total) < 1e-4,
                f"padding waste {sat['padding_waste_ratio']} vs rows {sat['rows']}")
        for gauge in ("slo_burn_rate_fast", "slo_burn_rate_slow", "slo_error_budget_remaining",
                      "slo_objective_info"):
            require(gauge in metrics_text, f"{gauge} missing from /metrics")
        require(slo["error_budget_remaining"] <= 1.0, f"slo {slo}")
        fired = {f"{s}/{k}": counter(app, "resilience_faults_injected_total", site=s, kind=k)
                 for s, k in (("dispatch", "transient"), ("dispatch", "hang"),
                              ("cache", "corrupt_entry"))}
        lane_counts = {
            "quarantines": counter(app, "serving_lane_quarantines_total", lane="0",
                                   cause="deadline"),
            "reinstated": counter(app, "serving_lane_reinstated_total", lane="0"),
            "retries": counter(app, "resilience_retries_total", cause="serve_dispatch"),
        }
        require(fired == {"dispatch/transient": 2, "dispatch/hang": 1,
                          "cache/corrupt_entry": 1}, f"faults fired {fired}")
        require(lane_counts == {"quarantines": 1, "reinstated": 1, "retries": 2},
                f"lane counters {lane_counts}")
        replay_a = app.executor.replay_launches()
        require(replay_a.get("fused", 0) > 0 and replay_a.get("grow", 0) > 0,
                f"server replays {replay_a}")
        require(sum(fn.launches for fn in kernels.values()) == 0,
                "serving ran a kernel wrapper outside a graph")
    finally:
        app.begin_drain(reason="chip_smoke")
        httpd.shutdown()
        httpd.server_close()
        app.close()
        flightrec.configure(None)

    # -- the same closed loop on a fresh server, the sampler off ------------
    # (the same supervision: only the sampler and the plan differ)
    bapp = ServingApp(cfg=cfg, buckets=SERVE_BUCKETS, result_cache_bytes=1 << 30,
                      resilience=ResilienceConfig(dispatch_timeout_s=OPERATE_DEADLINE_S),
                      lane_probe_interval_s=OPERATE_PROBE_S)
    bhttpd, _, bport = serve_in_thread(bapp)
    try:
        bapp.executor.reset_replays()
        seen = capture_masks(bapp)
        closed_off, res_off = load(f"http://127.0.0.1:{bport}", len(dicom), SERVE_CONCURRENCY,
                                   0.0, "jpeg")
        require(closed_off["statuses"] == {"ok": len(dicom)},
                f"closed loop, sampler off: {closed_off['statuses']}")
        checked += check_masks(seen, res_off, len(dicom))
        replay_b = bapp.executor.replay_launches()
        st_off = bapp.status()
        require(st_off["ledger"]["profile_samples"]["taken"] == 0,
                f"the sampler ran while off: {st_off['ledger']['profile_samples']}")
        off_planes = {"busy_fraction": st_off["saturation"]["busy_fraction"],
                      "device_seconds_mean": st_off["ledger"]["requests"]["device_seconds_mean"],
                      "executor_busy_s": bapp.executor.busy_seconds}
    finally:
        bapp.begin_drain(reason="chip_smoke")
        bhttpd.shutdown()
        bhttpd.server_close()
        bapp.close()

    # -- the driver drill: one plan over the cohort, counts pinned on the CPU
    out = tmp / "drill"
    rj = tmp / "drill.json"
    reset()
    rc = parallel_cli.main(["--base-path", str(cohort), "--output", str(out), "--results-json",
                            str(rj), "--canvas", str(cfg.canvas),
                            "--fault-plan", json.dumps(DRIVER_DRILL_PLAN)])
    drill_launches = {k: fn.launches for k, fn in kernels.items()}
    require(rc == 0, f"the drill's parallel CLI exited {rc}")
    rec = json.loads(rj.read_text())
    counts = {"slices_ok": rec["summary"]["slices_ok"], "retries": {}, "faults": {}}
    for m in rec["metrics"]["metrics"]:
        if m["name"] == "resilience_retries_total":
            counts["retries"][m["labels"]["cause"]] = m["value"]
        elif m["name"] == "resilience_faults_injected_total":
            counts["faults"][f"{m['labels']['site']}/{m['labels']['kind']}"] = m["value"]
    require(counts == DRIVER_DRILL_COUNTS, f"drill counts {counts} != {DRIVER_DRILL_COUNTS}")
    drill_files = files_of(out)
    require(drill_files and all(dfiles.get(k) == v for k, v in drill_files.items()),
            "an exported pair of the drill differs from the clean run's")
    require(len(drill_files) == 2 * counts["slices_ok"], f"{len(drill_files)} drill files")
    require(drill_launches["fused"] > 0 and drill_launches["grow"] > 0,
            f"drill launches {drill_launches}")

    # SIGTERM from the export path after a few pairs, then --resume
    kill_out = tmp / "sigterm"
    plan = {"faults": [{"site": "export", "kind": "sigterm", "after": DRIVER_SIGTERM_AFTER}]}
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.parallel", "--base-path",
         str(cohort), "--output", str(kill_out), "--canvas", str(cfg.canvas),
         "--fault-plan", json.dumps(plan)],
        capture_output=True, text=True, timeout=600,
    )
    killed_s = time.perf_counter() - t0
    require(killed.returncode == -15, f"the SIGTERM drill exited {killed.returncode}: "
            f"{killed.stderr[-2000:]}")
    partial = len(files_of(kill_out))
    require(0 < partial < len(dfiles), f"{partial} files before the SIGTERM")
    rc = parallel_cli.main(["--base-path", str(cohort), "--output", str(kill_out),
                            "--canvas", str(cfg.canvas), "--resume"])
    require(rc == 0, f"--resume exited {rc}")
    require(files_of(kill_out) == dfiles, "after --resume the JPEG pairs differ from the clean run")
    require((kill_out / "manifest.json").read_bytes()
            == (tmp / "parallel" / "manifest.json").read_bytes(),
            "after --resume the manifest differs from the clean run's")

    launches = {k: replay_a.get(k, 0) + replay_b.get(k, 0) + drill_launches[k]
                for k in kernels}
    emit({"phase": "operate",
          "drill": {"statuses": [d["status"] for d in drill], "hang_ms": drill[-1]["ms"],
                    "deadline_s": OPERATE_DEADLINE_S, "reinstate_s": reinstate_s,
                    "faults": fired, "lane": lane_counts, "flight_dumps": dumps},
          "sampler_on": {"closed": closed, "open": opened, "open_rate_rps": rate},
          "sampler_off": {"closed": closed_off, **off_planes},
          "masks_checked": checked,
          "stage_pie": {"shares": shares, "seconds": led["stage_seconds"],
                        "samples": led["profile_samples"]},
          "saturation": {"busy_fraction": sat["busy_fraction"], "mfu": sat["mfu"],
                         "peak_flops": lane0["peak_flops"],
                         "padding_waste_ratio": sat["padding_waste_ratio"],
                         "window_occupancy_ratio": sat["window_occupancy_ratio"],
                         "rows": sat["rows"], "closed_loop_rows": {"real": real,
                                                                    "padded": padded}},
          "ledger": {"accounts": led["accounts"], "executor_busy_s": busy,
                     "requests": led["requests"]},
          "hbm_bytes": led["hbm_bytes"], "slo": slo,
          "debug_profile_tries": profile_tries, "debug_profile_missed": len(profile_missed),
          "pie_missed": len(pie_missed),
          "driver_drill": {"counts": counts, "files": len(drill_files),
                           "sigterm_after": DRIVER_SIGTERM_AFTER, "files_before_kill": partial,
                           "killed_run_s": killed_s},
          "seconds": time.perf_counter() - phase_t0,
          "launches": launches, "nvidia_smi": smi})
    return launches


def telemetry_run(main_fn, argv: list, out: Path, kernels: dict, reset, launched: tuple,
                  feed_stall: bool) -> dict:
    """One driver CLI run with the telemetry flags, apart from the
    throughput turns: ``--metrics-out --log-json --heartbeat-s 1
    --profile-dir``. Its events and snapshot must pass
    ``scripts/check_telemetry.py --expect-patients`` (every cohort patient),
    the batch drivers' results JSON must carry ``feed_stall`` with a ratio
    in [0, 1], and the profile must name the kernels the run launched. A
    profile that names none of them (a profiler window that missed, as
    ``device_ms`` meets one) is taken again by a run with ``--profile-dir``
    alone, up to ``PROFILE_TRIES`` profiles; ``profile_missed`` says how
    many missed, and the run fails when every profile missed."""
    paths = {k: out.parent / f"{out.name}.{k}" for k in ("results", "metrics", "events")}
    prof = out.parent / f"{out.name}.profile"
    reset()
    t0 = time.perf_counter()
    rc = main_fn([*argv, "--output", str(out), "--results-json", str(paths["results"]),
                  "--metrics-out", str(paths["metrics"]), "--log-json", str(paths["events"]),
                  "--heartbeat-s", "1", "--profile-dir", str(prof)])
    wall = time.perf_counter() - t0
    require(rc == 0, f"telemetry run {out.name} exited {rc}")
    checker = Path(__file__).resolve().parent / "scripts" / "check_telemetry.py"
    res = subprocess.run(
        [sys.executable, str(checker), "--events", str(paths["events"]),
         "--metrics", str(paths["metrics"]), "--expect-patients", str(DRIVER_COHORT[0])],
        capture_output=True, text=True, timeout=120)
    require(res.returncode == 0, f"check_telemetry on {out.name}: {res.stdout}{res.stderr}")
    rec = json.loads(paths["results"].read_text())
    events = [json.loads(line)["event"] for line in paths["events"].read_text().splitlines()]
    out_rec = {"wall_s": wall, "check_telemetry": res.stdout.strip(),
               "events": {e: events.count(e) for e in sorted(set(events))},
               "launches": {k: fn.launches for k, fn in kernels.items()}}
    if feed_stall:
        fs = rec.get("feed_stall") or {}
        ratio = fs.get("feed_stall_ratio")
        require(ratio is not None and 0.0 <= ratio <= 1.0, f"{out.name}: feed_stall {fs}")
        out_rec["feed_stall"] = fs
    missed = []
    for attempt in range(PROFILE_TRIES):
        if attempt:
            prof = out.parent / f"{out.name}.profile{attempt}"
            rc = main_fn([*argv, "--output", str(out.parent / f"{out.name}.again{attempt}"),
                          "--profile-dir", str(prof)])
            require(rc == 0, f"telemetry run {out.name}, profile {attempt}: exited {rc}")
        trace = (prof / "nm03.pt.trace.json").read_text()
        names = {k: f"{k}_kernel" in trace for k in ("fused", "grow", "grow3d")}
        if all(names[k] for k in launched):
            break
        missed.append(names)
    require(len(missed) < PROFILE_TRIES,
            f"{out.name}: {PROFILE_TRIES} profiles missed the kernels: {missed}")
    out_rec["profile_names"] = names
    out_rec["profile_bytes"] = len(trace)
    out_rec["profile_missed"] = len(missed)
    return out_rec


def fleet_phase(tmp: Path, driver_out: dict, smi: str) -> dict:
    """Three port replicas on the card behind the fleet router (phase 11 of
    the docstring). Returns the fused, grow and median launches the
    replicas' graph replays made on the main path (the clean fleet run and
    the SIGKILL drill), read from each replica's own /readyz and /metrics."""
    import contextlib
    import io
    import os
    import signal
    import urllib.error
    import urllib.request

    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.fleet.manager import rolling_restart
    from nm03_capstone_project_tpu_torch.fleet.router import FleetApp
    from nm03_capstone_project_tpu_torch.fleet.router import serve_in_thread as fleet_serve
    from nm03_capstone_project_tpu_torch.obs import RunContext
    from nm03_capstone_project_tpu_torch.obs.trace import export_chrome_trace
    from nm03_capstone_project_tpu_torch.resilience import FaultPlan
    from nm03_capstone_project_tpu_torch.serving import loadgen, top

    phase_t0 = time.perf_counter()
    root = tmp / "fleet"
    root.mkdir()
    repo = Path(__file__).resolve().parent
    size = DRIVER_COHORT[2]
    cohort, dfiles = driver_out["cohort"], driver_out["files"]
    dicom = [(pid, f.stem, f.read_bytes()) for pid in find_patient_dirs(cohort)
             for f in load_dicom_files_for_patient(cohort, pid)]
    n, m = len(dicom), min(FLEET_SLICES, len(dicom))  # the cohort, and the slices a run sends

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    # the driver's JPEG pair of each slice: what every answer must carry
    want = [(sha(dfiles[f"{p}/{s}_original.jpg"]), sha(dfiles[f"{p}/{s}_processed.jpg"]))
            for p, s, _ in dicom]
    payloads = [(body, {"Content-Type": "application/dicom"}) for _, _, body in dicom]
    env = dict(os.environ)
    env.pop("NM03_FAULT_PLAN", None)
    procs = []  # every process this phase starts, stopped in the finally

    def get_json(url: str):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def spawn_replica(tag: str, port: int):
        """A port server on the card (no --device: the default) on ``port``
        (a :func:`stable_port`, so the killed replica and the rolling
        restart relaunch on theirs), written to its port file once its
        graphs are captured."""
        port_file = root / f"{tag}.port"
        log = root / f"{tag}.jsonl"
        argv = [sys.executable, "-m", "nm03_capstone_project_tpu_torch.serving.server",
                "--port", str(port), "--port-file", str(port_file), "--log-json", str(log),
                "--canvas", str(size), "--buckets", ",".join(map(str, SERVE_BUCKETS)),
                "--heartbeat-s", "0", "--flight-dir", str(root), "--request-timeout-s", "300"]
        # nm03-lint: disable=NM351 a replica's stdout log stream, not an artifact: read only after the process ends
        with open(root / f"{tag}.out", "w") as out:
            proc = subprocess.Popen(argv, cwd=repo, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
        procs.append(proc)
        return proc, port_file, log

    def wait_port(proc, port_file: Path, tag: str) -> int:
        deadline = time.monotonic() + FLEET_START_TIMEOUT_S
        while not port_file.exists():
            require(proc.poll() is None, f"replica {tag} exited {proc.returncode}: "
                    f"{(root / f'{tag}.out').read_text()[-2000:]}")
            require(time.monotonic() < deadline, f"replica {tag} never became ready")
            time.sleep(0.1)
        return int(port_file.read_text())

    def replica_launches(url: str) -> dict:
        """Graph replays x the launches each graph holds, from the
        replica's own /metrics.json and /readyz."""
        _, st = get_json(url + "/readyz")
        _, snap = get_json(url + "/metrics.json")
        graphs = st["cuda_graphs"]["lanes"]
        out = launch_dict(fused=0, grow=0, median=0)
        for m in snap["metrics"]:
            if m["name"] == "serving_graph_replays_total":
                g = graphs.get(m["labels"]["lane"], {}).get(m["labels"]["bucket"], {})
                for k, c in g.get("kernels", {}).items():
                    out[k] += int(m["value"]) * c
        return out

    class ReadyzPoller:
        """Samples the fleet's /readyz every 0.1 s: statuses and capacity."""

        def __init__(self, url: str):
            self.url, self.samples, self._stop = url, [], threading.Event()
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

        def _run(self):
            while not self._stop.wait(0.1):
                with contextlib.suppress(Exception):
                    status, st = get_json(self.url + "/readyz")
                    self.samples.append((status, st.get("capacity"),
                                         (st.get("replicas") or {}).get("ejected")))

        def stop(self):
            self._stop.set()
            self._t.join(timeout=10)
            return self.samples

    step = StepTimer()
    httpd = app = None
    try:
        # -- setup: three replicas, each its own process on the card -------
        t0 = time.perf_counter()
        chosen = []
        for _ in range(FLEET_REPLICAS):
            chosen.append(stable_port(chosen))
        started = [spawn_replica(f"r{i}", port) for i, port in enumerate(chosen)]
        ports = [wait_port(p, pf, f"r{i}") for i, (p, pf, _) in enumerate(started)]
        start_s = time.perf_counter() - t0
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        labels = [f"127.0.0.1:{p}" for p in ports]
        for i, url in enumerate(urls):
            status, st = get_json(url + "/readyz")
            rep = st["replica"]
            require(status == 200 and st["cuda_graphs"]["enabled"]
                    and "device cuda" in (root / f"r{i}.out").read_text(),
                    f"replica {i} is not on the card: {status} {st.get('cuda_graphs')}")
            require(rep["relaunch_argv"][3:5] == ["--port", str(ports[i])]
                    and rep["cwd"] == str(repo), f"replica {i} identity {rep}")

        router_log, router_metrics = root / "router.jsonl", root / "router_metrics.json"
        app = FleetApp(labels, obs=RunContext.create("fleet", metrics_out=str(router_metrics),
                                                      log_json=str(router_log)),
                       health_interval_s=0.25, probe_interval_s=0.5, health_timeout_s=2.0,
                       proxy_timeout_s=120.0)
        # every answer the router returns, by trace id: the JPEG pair's digests
        answers, real_proxy = {}, app.proxy_segment

        def proxy_segment(body, headers, query="", trace_id=None, **kw):
            status, data, hdrs = real_proxy(body, headers, query, trace_id=trace_id, **kw)
            if status == 200:
                p = json.loads(data)
                answers[trace_id] = (sha(base64.b64decode(p["original_jpeg_b64"])),
                                     sha(base64.b64decode(p["processed_jpeg_b64"])))
            return status, data, hdrs

        app.proxy_segment = proxy_segment
        httpd, _, fport = fleet_serve(app)
        fleet_url = f"http://127.0.0.1:{fport}"

        def total(name: str, **labels_) -> float:
            return sum(m["value"] for m in app.obs.metrics_snapshot()["metrics"]
                       if m["name"] == name
                       and all(m["labels"].get(k) == v for k, v in labels_.items()))

        def load(url: str, n_req: int, concurrency: int, result=None):
            result = result if result is not None else loadgen.LoadResult()
            s = loadgen.run_load([f"{url}/v1/segment"], payloads, n_req, concurrency, 0.0,
                                 120.0, result)
            return s, result

        def check_answers(result, n_sent: int, where: str) -> int:
            checked = 0
            for rec in result.requests:
                if rec["status"] != "ok":
                    continue
                i = int(rec["id"].rsplit("-", 1)[1]) % n
                got = answers.pop(rec["id"], None)
                require(got == want[i], f"{where}: {dicom[i][0]}/{dicom[i][1]} answered "
                        "a JPEG pair other than the driver's")
                checked += 1
            require(checked == n_sent, f"{where}: {checked} answers checked of {n_sent}")
            return checked

        def rates(s: dict) -> dict:
            return {"requests_per_s": s["throughput_rps"], "p50_ms": s["latency_ms"]["p50"],
                    "p99_ms": s["latency_ms"]["p99"], "statuses": s["statuses"],
                    "replicas_observed": s["replicas_observed"]}

        def wait_healthy(target: str, what: str, timeout: float = 120.0):
            deadline = time.monotonic() + timeout
            while app.replicas.state(target) != "healthy":
                require(time.monotonic() < deadline, f"{what}: never reinstated")
                time.sleep(0.05)

        step("start")
        # -- the baseline: the cohort straight to one replica --------------
        direct, _ = load(urls[0], m, SERVE_CONCURRENCY)
        require(direct["statuses"] == {"ok": m}, f"direct run {direct['statuses']}")
        step("direct")

        # -- the main path: the cohort through the router, then the drill --
        before = [replica_launches(u) for u in urls]
        clean, clean_res = load(fleet_url, m, SERVE_CONCURRENCY)
        require(clean["statuses"] == {"ok": m}, f"fleet run {clean['statuses']}")
        check_answers(clean_res, m, "fleet run")
        require(set(clean["replicas_observed"]) == set(labels),
                f"fleet run spread {clean['replicas_observed']}")

        step("fleet_run")
        victim = FLEET_REPLICAS - 1
        vproc, vtarget = started[victim][0], app.replicas.targets[victim]
        poller = ReadyzPoller(fleet_url)
        drill_res, box = loadgen.LoadResult(), {}
        loader = threading.Thread(
            target=lambda: box.update(summary=load(fleet_url, m, SERVE_CONCURRENCY,
                                                   drill_res)[0]), daemon=True)
        loader.start()
        deadline = time.monotonic() + 120
        while len(drill_res.latencies_s) < m * FLEET_KILL_SHARE:
            require(loader.is_alive() and time.monotonic() < deadline,
                    "the drill's loadgen ended before a third was answered")
            time.sleep(0.005)
        killed_at = len(drill_res.latencies_s)
        victim_launches = replica_launches(urls[victim])  # its last read before it dies
        # frozen mid-batch first, so requests park on it, then killed
        os.kill(vproc.pid, signal.SIGSTOP)
        time.sleep(FLEET_STOP_S)
        os.kill(vproc.pid, signal.SIGKILL)
        vproc.wait(timeout=30)
        loader.join(timeout=300)
        require(not loader.is_alive(), "the drill's loadgen hung")
        samples = poller.stop()
        drill = box["summary"]
        require(drill["statuses"] == {"ok": m}, f"SIGKILL drill statuses {drill['statuses']}")
        check_answers(drill_res, m, "SIGKILL drill")
        survivors = [replica_launches(u) for u in urls[:victim]]
        fleet_launches = {k: sum(r[k] for r in survivors) + victim_launches[k]
                          - sum(b[k] for b in before) for k in ("fused", "grow", "median")}
        require(fleet_launches["fused"] > 0 and fleet_launches["grow"] > 0,
                f"the replicas launched {fleet_launches}")
        failovers = total("fleet_failovers_total")
        require(failovers >= 1 and total("fleet_failovers_total", replica=labels[victim]) >= 1,
                f"no failover off the killed replica ({failovers})")
        require(app.replicas.state(vtarget) == "ejected", "the killed replica is not ejected")
        require(set(drill["replicas_observed"]) == set(labels),
                f"drill replicas observed {drill['replicas_observed']}")
        require({s for s, _, _ in samples} == {200}, "the fleet's /readyz left 200")
        dip = min(c for _, c, _ in samples if c is not None)
        require(abs(dip - 2 / 3) < 1e-3, f"the fleet's capacity dipped to {dip}, not 2/3")

        step("sigkill")
        # -- one timeline: the router's stream and the three replicas' -----
        merged = root / "fleet.trace.json"
        n_traces = export_chrome_trace([str(router_log)] + [str(lg) for _, _, lg in started],
                                       str(merged))
        events = json.loads(merged.read_text())["traceEvents"]
        procs_named = {e["args"]["name"] for e in events
                       if e["ph"] == "M" and e["name"] == "process_name"}
        require(procs_named == {"nm03-fleet"} | {f"replica {lb}" for lb in labels},
                f"merged trace processes {sorted(procs_named)}")
        b_events = [e for e in events if e["ph"] == "B"]
        died = [e for e in b_events if e["name"] == "proxy_hop"
                and e["args"].get("replica") == labels[victim]
                and e["args"].get("outcome") == "io_error"]
        require(died and any(e["name"] == "failover" for e in b_events),
                "no failover hop in the merged trace")
        failed_over = set(died[0]["args"]["trace_ids"])
        require(any(e["pid"] != died[0]["pid"] and failed_over & set(e["args"]["trace_ids"])
                    for e in b_events), "the failed-over request has no replica span tree")
        checker = repo / "scripts" / "check_telemetry.py"
        res = subprocess.run([sys.executable, str(checker), "--expect-fleet-trace", str(merged)],
                             capture_output=True, text=True, timeout=120)
        require(res.returncode == 0, f"--expect-fleet-trace: {res.stderr}")

        step("trace")
        # -- the killed replica comes back: probation, then reinstatement --
        t0 = time.perf_counter()
        revived = spawn_replica("r%d_revived" % victim, ports[victim])
        wait_port(revived[0], revived[1], "r%d_revived" % victim)
        wait_healthy(vtarget, "the revived replica")
        revive_s = time.perf_counter() - t0
        vl = labels[victim]
        drill_counts = {
            "ejections": total("fleet_replica_ejections_total", replica=vl),
            "probes": total("fleet_probes_total", replica=vl),
            "reinstated": total("fleet_replica_reinstated_total", replica=vl),
        }
        require(drill_counts == {"ejections": 1, "probes": 1, "reinstated": 1},
                f"the killed replica's ejection/probation/reinstatement {drill_counts}")

        step("revive")
        # -- the fault plan's fleet rules, each once -----------------------
        ej0, re0 = total("fleet_replica_ejections_total"), total("fleet_replica_reinstated_total")
        app.fault_plan = FaultPlan.from_spec({"faults": [
            {"site": "fleet", "kind": "replica_unreachable", "stem": labels[0], "count": 1}]})
        deadline = time.monotonic() + 30
        while total("fleet_replica_ejections_total") < ej0 + 1:
            require(time.monotonic() < deadline, "replica_unreachable never ejected")
            time.sleep(0.02)
        wait_healthy(app.replicas.targets[0], "replica_unreachable")
        app.fault_plan = FaultPlan.from_spec({"faults": [
            {"site": "fleet", "kind": "proxy_io_error", "count": 1}]})
        plan_res = loadgen.LoadResult()
        plan_run, _ = load(fleet_url, 8, 1, plan_res)
        require(plan_run["statuses"] == {"ok": 8} and plan_run["failovers_observed"] == 1,
                f"proxy_io_error run {plan_run['statuses']} {plan_run['failovers_observed']}")
        check_answers(plan_res, 8, "proxy_io_error run")
        for t in app.replicas.targets:
            wait_healthy(t, "proxy_io_error")
        app.fault_plan = None
        fault_counts = {
            "replica_unreachable": total("resilience_faults_injected_total", site="fleet",
                                         kind="replica_unreachable"),
            "proxy_io_error": total("resilience_faults_injected_total", site="fleet",
                                    kind="proxy_io_error"),
            "ejections": total("fleet_replica_ejections_total") - ej0,
            "reinstated": total("fleet_replica_reinstated_total") - re0,
        }
        require(fault_counts == {"replica_unreachable": 1, "proxy_io_error": 1,
                                 "ejections": 2, "reinstated": 2},
                f"the fault plan's drill {fault_counts}")

        step("fault_plan")
        # -- nm03-top over the fleet ----------------------------------------
        fsample, per = top.fetch_fleet_sample(fleet_url, 10.0)
        view = top.build_fleet_view(fsample, per)
        require(len(view["replicas"]) == 3
                and all(r["state"] == "healthy" for r in view["replicas"]),
                f"top fleet view {view['replicas']}")
        screen = io.StringIO()
        with contextlib.redirect_stdout(screen):
            top_rc = top.main(["--url", fleet_url, "--fleet", "--once"])
        require(top_rc == 0 and all(lb in screen.getvalue() for lb in labels),
                f"nm03-top --fleet exited {top_rc}")

        step("top")
        # -- the rolling restart under load ---------------------------------
        old_pids = [get_json(u + "/readyz")[1]["replica"]["pid"] for u in urls]
        poller = ReadyzPoller(fleet_url)
        stop, rounds = threading.Event(), []

        def traffic():
            while not stop.is_set():
                s, r = load(fleet_url, FLEET_RESTART_LOAD[0], FLEET_RESTART_LOAD[1])
                rounds.append((s, r))

        loader = threading.Thread(target=traffic, daemon=True)
        loader.start()
        time.sleep(0.5)

        def spawn(argv, **kw):
            # nm03-lint: disable=NM351 a relaunched replica's stdout log stream, not an artifact
            with open(root / f"restart{len(procs)}.out", "w") as out:
                proc = subprocess.Popen(argv, cwd=kw.get("cwd"), env=env, stdout=out,
                                        stderr=subprocess.STDOUT, start_new_session=True)
            procs.append(proc)
            return proc

        t0 = time.perf_counter()
        report = rolling_restart(labels, drain_timeout_s=120, warm_timeout_s=300, poll_s=0.1,
                                 fleet_url=fleet_url, spawn=spawn, emit=lambda m: None)
        restart_s = time.perf_counter() - t0
        stop.set()
        loader.join(timeout=300)
        samples = poller.stop()
        require(report["ok"] and all(e["ok"] for e in report["replicas"]), f"restart {report}")
        new_pids = [e["new_pid"] for e in report["replicas"]]
        require(all(a != b for a, b in zip(old_pids, new_pids)), f"pids {old_pids} {new_pids}")
        sent = 0
        for s, r in rounds:
            require(s["statuses"] == {"ok": s["requests_total"]},
                    f"a request failed during the rolling restart: {s['statuses']}")
            sent += check_answers(r, s["requests_total"], "rolling restart")
        require(sent > 0, "no traffic during the rolling restart")
        floor = min(c for _, c, _ in samples if c is not None)
        require({s for s, _, _ in samples} == {200} and floor >= 2 / 3 - 1e-6,
                f"routed capacity fell to {floor} during the rolling restart")

        step("rolling_restart")
        httpd.shutdown()
        httpd.server_close()
        app.begin_drain()
        app.close()
        httpd = app = None
        res = subprocess.run(
            [sys.executable, str(checker), "--events", str(router_log), "--metrics",
             str(router_metrics), "--expect-gauge", "fleet_replicas_ready=3",
             "--expect-counter", "fleet_shed_total==0",
             "--expect-counter", f"fleet_replica_reinstated_total{{replica={vl}}}=1"],
            capture_output=True, text=True, timeout=120)
        require(res.returncode == 0, f"check_telemetry on the router: {res.stderr}")
        step("router_check")

        emit({"phase": "fleet", "steps_s": step.spent, "replicas": FLEET_REPLICAS, "slices": m,
              "concurrency": SERVE_CONCURRENCY, "start_s": start_s,
              "direct": rates(direct), "fleet": rates(clean),
              "sigkill": {"killed_after": killed_at, "stopped_s": FLEET_STOP_S,
                          **rates(drill), "failovers": failovers,
                          "failovers_observed": drill["failovers_observed"],
                          "capacity_dip": dip, "revive_s": revive_s, **drill_counts},
              "fault_plan": fault_counts,
              "restart": {"seconds": restart_s, "capacity_floor": floor,
                          "requests": sent,
                          "replicas": [{k: e.get(k) for k in ("replica", "old_pid", "new_pid",
                                                              "drain_s", "warm_s", "capture_s")}
                                       for e in report["replicas"]]},
              "top_rows": len(view["replicas"]),
              "trace": {"requests": n_traces, "processes": sorted(procs_named),
                        "failover_trace_ids": len(failed_over)},
              "fleet_launches": fleet_launches,
              "seconds": time.perf_counter() - phase_t0, "nvidia_smi": smi})
        return fleet_launches
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if app is not None:
            app.begin_drain()
            app.close(status="error")
        for proc in procs:  # SIGTERM drains a replica; what stays up is killed
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


LOCKDEP_BUCKETS = (1, 4)
LOCKDEP_LANES = 4
LOCKDEP_SLICES = 48  # slice requests during the studies
LOCKDEP_STUDIES = 4


def lockdep_phase(tmp: Path, driver_out: dict, smi: str, kernels: dict, reset) -> dict:
    """The lock-order witness on the card (phase 12 of the docstring).

    Returns each kernel's launches while the instrumented server answered
    (slice graph replays x the kernels a graph holds, plus the gang's
    eager launches)."""
    import os

    from nm03_capstone_project_tpu_torch.analysis import gate
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.utils import lockdep
    from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

    phase_t0 = time.perf_counter()
    size = DRIVER_COHORT[2]
    cohort, dmasks = driver_out["cohort"], driver_out["masks"]
    golden = {g["patient"]: g for g in json.loads(
        (build.PKG / "testdata" / "volume_golden.json").read_text())["patients"]}
    parts = "application/x-nm03-dicom-parts"
    slices, studies = [], {}
    for pid in find_patient_dirs(cohort):
        raws = [(f.stem, f.read_bytes()) for f in load_dicom_files_for_patient(cohort, pid)]
        slices += [(pid, stem, r) for stem, r in raws]
        studies[pid] = b"".join(len(r).to_bytes(4, "little") + r for _, r in raws)
    slices = slices[:LOCKDEP_SLICES]
    study_pids = sorted(studies)[:LOCKDEP_STUDIES]
    witness_path = tmp / "lockdep_witness.json"
    statuses = {}

    st = lockdep.install()  # before the app: only locks created after install count
    try:
        from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

        app = ServingApp(cfg=PipelineConfig(canvas=size), buckets=LOCKDEP_BUCKETS,
                         lane_devices=["cuda:0"] * LOCKDEP_LANES, volume_serving=True,
                         volume_depth_buckets=(32,), result_cache_bytes=1 << 30)
        httpd, _, port = serve_in_thread(app)
        base = f"http://127.0.0.1:{port}"
        try:
            require(app.status()["volumes"]["z_shards"] == LOCKDEP_LANES,
                    f"volumes block: {app.status()['volumes']}")
            reset()
            app.executor.reset_replays()  # the main path's run: from here on
            out = {}

            def slice_load():
                out["slices"] = client_run(
                    base + "/v1/segment?output=mask",
                    [((pid, stem), body, {"Content-Type": "application/dicom"})
                     for pid, stem, body in slices], 8)

            def study_load():
                out["studies"] = client_run(
                    base + "/v1/segment-volume?output=mask",
                    [(pid, studies[pid], {"Content-Type": parts}) for pid in study_pids], 2)

            threads = [threading.Thread(target=slice_load), threading.Thread(target=study_load)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            require(not any(t.is_alive() for t in threads), "the mixed traffic hung")
            for key in ("slices", "studies"):
                for status, payload, _, _ in out[key][0].values():
                    statuses[status] = statuses.get(status, 0) + 1
                    require(status == 200, f"HTTP {status}: {payload}")
            for (pid, stem), (_, payload, _, _) in out["slices"][0].items():
                h, w = payload["shape"]
                require(payload["mask_sha256"] == hashlib.sha256(np.ascontiguousarray(
                    dmasks[(pid, stem)][:h, :w]).tobytes()).hexdigest(),
                    f"served {pid}/{stem}: mask != the driver's")
            for pid, (_, payload, _, _) in out["studies"][0].items():
                require(payload["z_shards"] == LOCKDEP_LANES
                        and payload["mask_sha256"] == golden[pid]["mask_sha256"],
                        f"served study {pid}: z_shards {payload['z_shards']}, not the golden")
            launches = app.executor.replay_launches()
            for k, fn in kernels.items():
                launches[k] = launches.get(k, 0) + fn.launches
            require(launches.get("fused", 0) > 0 and launches.get("grow", 0) > 0,
                    f"the instrumented server did not launch every kernel: {launches}")
        finally:
            app.begin_drain(reason="lockdep")
            httpd.shutdown()
            httpd.server_close()
            app.close()
        lockdep.dump_witness(witness_path, st)
    finally:
        lockdep.uninstall()

    witness = json.loads(witness_path.read_text())
    problems = gate.check_witness(witness)
    require(problems == [], f"the witness does not gate clean: {problems}")
    require(witness["edges"] and witness["inversions"] == [], "no nesting observed")
    env = dict(os.environ, PYTHONPATH=str(Path.cwd()))

    def run_gate(path: Path):
        return subprocess.run(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.analysis.gate",
             "--skip-ruff", "--lockdep-witness", str(path)],
            capture_output=True, text=True, timeout=300, env=env)

    clean = run_gate(witness_path)
    require(clean.returncode == 0 and "lockdep: witness OK" in clean.stdout,
            f"the gate refused the card's witness: {clean.stdout[-2000:]}{clean.stderr[-2000:]}")
    # ABBA: the witness with one observed edge also taken the other way round
    e = witness["edges"][0]
    abba = dict(witness, edges=witness["edges"] + [
        {"src": e["dst"], "dst": e["src"], "count": 1, "stack": ["inverted:1 in abba"]}])
    abba_path = tmp / "lockdep_witness_abba.json"
    atomic_write_text(abba_path, json.dumps(abba))
    abba_problems = gate.check_witness(abba)
    bad = run_gate(abba_path)
    require(any("cycle" in q for q in abba_problems) and bad.returncode != 0
            and "gate: FAIL" in bad.stdout, f"the gate passed an ABBA witness: {bad.stdout[-1000:]}")
    lint = clean.stdout.splitlines()
    emit({"phase": "lockdep", "lanes": LOCKDEP_LANES, "buckets": list(LOCKDEP_BUCKETS),
          "slices": len(slices), "studies": len(study_pids), "statuses": statuses,
          "edges": len(witness["edges"]), "sites": len(witness["sites"]),
          "inversions": len(witness["inversions"]), "cycles": 0,
          "gate": next((ln for ln in lint if ln.startswith("lockdep:")), None),
          "lint": next((ln for ln in lint if ln.startswith("nm03-lint:")), None),
          "abba_problems": abba_problems, "launches": launches,
          "seconds": time.perf_counter() - phase_t0, "nvidia_smi": smi})
    return launches


def sanitize_phase(tmp: Path, driver_out: dict, smi: str, kernels: dict, reset) -> dict:
    """``--sanitize`` on the card (phase 13 of the docstring).

    Returns each kernel's launches in the sanitized parallel driver's run
    (the median kernel's from its unfused patient)."""
    from nm03_capstone_project_tpu_torch.cli import parallel as parallel_cli
    from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor
    from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom
    from nm03_capstone_project_tpu_torch.data.discovery import load_dicom_files_for_patient
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.resilience import ResilienceConfig
    from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph
    from nm03_capstone_project_tpu_torch.utils import sanitize

    phase_t0 = time.perf_counter()
    n_pat, n_sl, size = DRIVER_COHORT
    n = n_pat * n_sl
    cohort, dfiles, dmasks = driver_out["cohort"], driver_out["files"], driver_out["masks"]
    cfg = PipelineConfig(canvas=size)

    # the main path: the parallel driver's CLI with --sanitize
    out, rj, mj = tmp / "sanitize", tmp / "sanitize.json", tmp / "sanitize_metrics.json"
    reset()
    rc = parallel_cli.main(["--base-path", str(cohort), "--output", str(out), "--results-json",
                            str(rj), "--metrics-out", str(mj), "--canvas", str(size),
                            "--sanitize"])
    launches = {k: fn.launches for k, fn in kernels.items()}
    require(rc == 0, f"the sanitized parallel CLI exited {rc}")
    rec = json.loads(rj.read_text())
    require(rec["summary"]["slices_ok"] == n, f"sanitized run: {rec['summary']}")
    require(launches["fused"] > 0 and launches["grow"] > 0, f"sanitized launches {launches}")
    require(files_of(out) == dfiles, "sanitized JPEG pairs != the clean run's")
    clean_manifest = (tmp / "cli_1" / "manifest.json").read_bytes()
    require((out / "manifest.json").read_bytes() == clean_manifest,
            "sanitized manifest != the clean CLI run's")
    metrics = {m["name"]: m["value"] for m in json.loads(mj.read_text())["metrics"]
               if not m["labels"]}
    require(metrics.get("pipeline_recompiles_total") == 0,
            f"pipeline_recompiles_total {metrics.get('pipeline_recompiles_total')} after warm-up")
    require(not sanitize.active(), "the CLI left its sanitize session on")

    # the unfused patient (the median kernel) under a session of its own
    pid = "PGBM-0003"
    sanitize.enable()
    try:
        sanitize.mark_warm()  # every library is loaded by now
        reset()
        res = CohortProcessor(cohort, tmp / "sanitize_unfused", mode="parallel",
                              cfg=PipelineConfig(canvas=size, fuse_preprocess=False),
                              batch_cfg=BatchConfig()).process_patient(pid)
        unfused = {k: fn.launches for k, fn in kernels.items()}
        require(res.succeeded == n_sl and unfused["median"] > 0,
                f"sanitized unfused patient: {res.succeeded}/{n_sl}, launches {unfused}")
        require(files_of(tmp / "sanitize_unfused") == {
            k: v for k, v in dfiles.items() if k.startswith(pid + "/")},
            "sanitized unfused JPEG pairs != the clean run's")
        launches["median"] = unfused["median"]

        # a NaN planted in the first stage's input: the stage is named
        files = load_dicom_files_for_patient(cohort, pid)
        batch = pad_to_canvas([read_dicom(f).pixels for f in files], cfg.canvas_hw,
                              device="cuda")
        nan_px = batch.pixels.clone()
        nan_px[3, 40, 40] = float("nan")
        try:
            process_batch(nan_px, batch.dims, cfg)
            raise AssertionError("a NaN input passed the sanitized pipeline")
        except sanitize.NonFiniteStage as e:
            nan_eager = {"stage": e.stage, "error": str(e)}
        require(nan_eager["stage"] == "extend_edges", f"NaN named {nan_eager}")

        # the same through a CUDA graph: a capture after warm-up counts, and
        # the replay's stage flags are checked at its fetch
        g = BucketGraph(cfg, 1, "cuda:0", torch.cuda.graph_pool_handle(), torch.cuda.Stream())
        g.capture()
        st = sanitize.state()
        require(st.recompiles == 1 and st.events[0][0] == "graph",
                f"the watchdog saw {st.recompiles} recompiles: {st.events}")
        px0 = batch.pixels[:1].cpu().numpy()
        dims0 = batch.dims[:1].cpu().numpy()
        g.launch(px0, dims0)
        mask0, _ = g.fetch()
        require(np.array_equal(mask0[0], dmasks[(pid, files[0].stem)]),
                "the sanitized graph's mask != the driver's")
        bad = px0.copy()
        bad[0, 40, 40] = np.nan
        g.launch(bad, dims0)
        try:
            g.fetch()
            raise AssertionError("a NaN passed the sanitized graph replay")
        except sanitize.NonFiniteStage as e:
            nan_graph = {"stage": e.stage, "error": str(e)}
        require(nan_graph["stage"] == "extend_edges", f"graph NaN named {nan_graph}")

        # a CPU tensor handed to a guarded dispatch, inline and supervised
        uploads = {}
        for key, res_cfg in (("inline", ResilienceConfig()),
                             ("supervised", ResilienceConfig(dispatch_timeout_s=60.0))):
            proc = CohortProcessor(cohort, tmp / f"sanitize_upload_{key}", mode="sequential",
                                   cfg=cfg, resilience=res_cfg)
            px_cpu, dm_cpu = batch.pixels[0].cpu(), batch.dims[0].cpu()
            got = proc._dispatch_slice({"stem": files[0].stem, "index": 0, "pixels": px_cpu,
                                        "dims": dm_cpu, "pixels_host": px_cpu.numpy(),
                                        "dims_host": dm_cpu.numpy()}, True, pid)
            err = got.get("error")
            require(isinstance(err, sanitize.ImplicitUpload)
                    and err.site == "cli/runner.py::_dispatch_slice",
                    f"{key}: the planted upload gave {err!r}")
            uploads[key] = str(err)
    finally:
        sanitize.disable()
    emit({"phase": "sanitize", "slices": n, "byte_equal_to_clean": True,
          "pipeline_recompiles_total": metrics["pipeline_recompiles_total"],
          "wall_s": rec["wall_s"],
          "clean_wall_s": json.loads((tmp / "results_1.json").read_text())["wall_s"],
          "nan_eager": nan_eager, "nan_graph": nan_graph, "graph_capture_counted": 1,
          "uploads": uploads, "launches": launches,
          "seconds": time.perf_counter() - phase_t0, "nvidia_smi": smi})
    return launches


COMPILE_CACHE_SLICES = 2  # golden slices each server answers
COMPILE_CACHE_BUCKETS = (1, 4)
COMPILE_CACHE_REPLICAS = 2  # replicas cold together on one directory
COMPILE_CACHE_RELAUNCHES = 1  # of those, relaunched from the cache through nm03-fleet restart


def compile_cache_phase(tmp: Path, driver_out: dict, smi: str, kernels: dict, reset) -> dict:
    """The kernel-library cache on the card (phase 14 of the docstring).

    Returns the fused, grow and median launches the phase's servers made on
    its main path (every start's graph replays), read from each server's own
    /readyz and /metrics."""
    import contextlib
    import io
    import os
    import signal
    import urllib.error
    import urllib.request

    from nm03_capstone_project_tpu_torch.compilehub import scan_entries
    from nm03_capstone_project_tpu_torch.data.discovery import load_dicom_files_for_patient
    from nm03_capstone_project_tpu_torch.kernels import build

    phase_t0 = time.perf_counter()
    root = tmp / "compile_cache"
    root.mkdir()
    repo = Path(__file__).resolve().parent
    checker = repo / "scripts" / "check_telemetry.py"
    size = DRIVER_COHORT[2]
    cohort, dfiles = driver_out["cohort"], driver_out["files"]
    golden = json.loads((build.PKG / "testdata" / "driver_golden.json").read_text())[
        "slices"][:COMPILE_CACHE_SLICES]
    bodies = {}
    for g in golden:
        pid = g["patient"]
        if pid not in bodies:
            bodies[pid] = {f.stem: f.read_bytes()
                           for f in load_dicom_files_for_patient(cohort, pid)}
    env = dict(os.environ)
    for var in ("NM03_FAULT_PLAN", "NM03_COMPILE_CACHE_DIR"):
        env.pop(var, None)
    # a toolkit out of reach: nothing on PATH holds nvcc, CUDA_HOME names none
    no_nvcc = dict(env, CUDA_HOME=str(root / "no-toolkit"), PATH=os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if p and not os.path.exists(os.path.join(p, "nvcc"))))
    require(shutil.which("nvcc", path=no_nvcc["PATH"]) is None, "nvcc still on PATH")
    procs, detached = [], []  # children, and replicas the fleet CLI relaunched
    ports = []  # every port handed out: servers started together never share one

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def get_json(url: str):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def start(tag: str, cache: Path, env_=None, extra=()):
        """A port server on the card with ``--compile-cache-dir cache``."""
        port = stable_port(ports)
        ports.append(port)
        port_file = root / f"{tag}.port"
        argv = [sys.executable, "-m", "nm03_capstone_project_tpu_torch.serving.server",
                "--port", str(port), "--port-file", str(port_file),
                "--compile-cache-dir", str(cache), "--canvas", str(size),
                "--buckets", ",".join(map(str, COMPILE_CACHE_BUCKETS)),
                "--result-cache-bytes", "16m", "--heartbeat-s", "0",
                "--flight-dir", str(root), "--metrics-out", str(root / f"{tag}.metrics.json"),
                "--log-json", str(root / f"{tag}.jsonl"), *extra]
        # nm03-lint: disable=NM351 a server's stdout log stream, not an artifact: read only after the process ends
        with open(root / f"{tag}.out", "w") as out:
            proc = subprocess.Popen(argv, cwd=repo, env=env_ or env, stdout=out,
                                    stderr=subprocess.STDOUT)
        procs.append(proc)
        return {"tag": tag, "proc": proc, "port_file": port_file, "t0": time.monotonic(),
                "t0_unix": time.time()}

    def ready(*servers: dict) -> list:
        """Wait for each port file (written after warmup); each server's
        warm_s (process start to ready) and its /readyz."""
        pending = list(servers)
        while pending:
            for s in list(pending):
                if s["port_file"].exists():
                    s["warm_s"] = round(time.monotonic() - s["t0"], 3)
                    pending.remove(s)
                    continue
                require(s["proc"].poll() is None,
                        f"server {s['tag']} exited {s['proc'].returncode}: "
                        f"{(root / (s['tag'] + '.out')).read_text()[-3000:]}")
                require(time.monotonic() < s["t0"] + FLEET_START_TIMEOUT_S,
                        f"server {s['tag']} never became ready")
            time.sleep(0.05)
        for s in servers:
            s["url"] = f"http://127.0.0.1:{int(s['port_file'].read_text())}"
            status, s["readyz"] = get_json(s["url"] + "/readyz")
            require(status == 200 and s["readyz"]["cuda_graphs"]["enabled"],
                    f"server {s['tag']} is not ready on the card: {status}")
        return list(servers)

    served_s = {}  # each serve()'s seconds, by where

    def serve(url: str, where: str) -> list:
        """The golden slices one at a time: each answer's mask equal to the
        golden's and its JPEG pair to the driver's files; the answers."""
        answers, t = [], time.perf_counter()
        for g in golden:
            req = urllib.request.Request(
                url + "/v1/segment", data=bodies[g["patient"]][g["stem"]], method="POST",
                headers={"Content-Type": "application/dicom"})
            with urllib.request.urlopen(req, timeout=120) as r:
                require(r.status == 200, f"{where}: {g['patient']}/{g['stem']} {r.status}")
                p = json.loads(r.read())
            key = f"{g['patient']}/{g['stem']}"
            got = (p["mask_sha256"], p["mask_pixels"], p["grow_converged"],
                   sha(base64.b64decode(p["original_jpeg_b64"])),
                   sha(base64.b64decode(p["processed_jpeg_b64"])))
            require(got == (g["mask_sha256"], g["area"], g["converged"],
                            sha(dfiles[f"{key}_original.jpg"]),
                            sha(dfiles[f"{key}_processed.jpg"])),
                    f"{where}: {key} differs from the golden or the driver's pair")
            answers.append(got)
        served_s[where] = round(time.perf_counter() - t, 3)
        return answers

    def launches_of(url: str) -> dict:
        _, st = get_json(url + "/readyz")
        _, snap = get_json(url + "/metrics.json")
        graphs = st["cuda_graphs"]["lanes"]
        out = launch_dict(fused=0, grow=0, median=0)
        for m in snap["metrics"]:
            if m["name"] == "serving_graph_replays_total":
                g = graphs.get(m["labels"]["lane"], {}).get(m["labels"]["bucket"], {})
                for k, c in g.get("kernels", {}).items():
                    out[k] += int(m["value"]) * c
        return out

    def stop(s: dict, hits: int, misses: int, extra=()) -> float:
        """SIGTERM (the drain writes the metrics snapshot), then the
        telemetry checker's exact counter forms on it; the seconds from
        the signal to the server's exit."""
        t = time.perf_counter()
        s["proc"].send_signal(signal.SIGTERM)
        require(s["proc"].wait(timeout=120) == 0, f"server {s['tag']} did not drain cleanly")
        drain_s = round(time.perf_counter() - t, 3)
        res = subprocess.run(
            [sys.executable, str(checker), "--metrics", str(root / f"{s['tag']}.metrics.json"),
             "--expect-counter", f"compile_cache_hits_total=={hits}",
             "--expect-counter", f"compile_cache_misses_total=={misses}", *extra],
            capture_output=True, text=True, timeout=120)
        require(res.returncode == 0, f"check_telemetry on {s['tag']}: {res.stdout} {res.stderr}")
        return drain_s

    def hub_of(s: dict) -> dict:
        hub = s["readyz"]["compile_hub"]
        return {"warm_s": s["warm_s"],
                # spawn to the app's identity: interpreter, imports, construction
                "until_app_s": round(s["readyz"]["replica"]["start_unix"] - s["t0_unix"], 3),
                "hits": hub.get("cache_hits"), "misses": hub.get("cache_misses"),
                "libraries": hub["libraries"], "capture_s": hub["capture_seconds"],
                "cache_load_s": hub.get("cache_load_seconds")}

    def cache_cli(*argv) -> tuple:
        """``nm03-torch-cache`` run in this process (its ``main``): its exit
        code and its JSON report. A subprocess would import torch and
        derive this tree's keys again, seconds a call on the card's host."""
        from nm03_capstone_project_tpu_torch.compilehub import cache_cli as cli

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["--format", "json", *argv])
        text = printed.getvalue()
        return rc, (json.loads(text) if text.strip() else None)

    def sources(s: dict) -> dict:
        return {n: r["source"] for n, r in s["readyz"]["compile_hub"]["libraries"].items()}

    def stop_detached(pid: int) -> None:
        """SIGTERM a replica the fleet CLI relaunched (not our child), and
        wait until it is gone or a zombie."""
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
            except (OSError, IndexError):
                return
            if state == "Z":
                return
            time.sleep(0.1)
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)

    launches = launch_dict(fused=0, grow=0, median=0)

    def count(url: str) -> None:
        for k, v in launches_of(url).items():
            launches[k] += v

    out, step = {}, StepTimer()
    n_libs = len(build.SOURCES)
    try:
        reset()  # the main path's run: the servers' own counts are read below
        # -- 1. cold: an empty directory ------------------------------------
        cache = root / "cache"
        cold, = ready(start("cold", cache))
        require(cold["readyz"]["replica"]["compile_cache_hits"] == 0, "cold: hits")
        require(sources(cold) == dict.fromkeys(build.SOURCES, "built"), f"cold {sources(cold)}")
        rows = scan_entries(cache)
        require([r["status"] for r in rows] == ["ok"] * n_libs, f"cold entries {rows}")
        answers = serve(cold["url"], "cold")
        count(cold["url"])
        out["cold"] = hub_of(cold)
        out["cold"]["stop_s"] = stop(cold, 0, n_libs)
        step("cold")

        # -- 2. warm, with nvcc out of reach, on its own ---------------------
        warm, = ready(start("warm", cache, env_=no_nvcc))
        require(warm["readyz"]["replica"]["compile_cache_hits"] == n_libs, "warm: replica hits")
        require(sources(warm) == dict.fromkeys(build.SOURCES, "cache"), f"warm {sources(warm)}")
        require(warm["readyz"]["compile_hub"]["builds"] == 0, "warm: a library was built")
        require(serve(warm["url"], "warm") == answers, "warm answers != cold answers")
        count(warm["url"])
        out["warm"] = hub_of(warm)
        out["warm"]["stop_s"] = stop(warm, n_libs, 0)
        step("warm")

        # -- 3, 4 and 5 at once, each on its own directory ------------------
        # 3: one flipped byte in the median library's entry, on a copy of
        # the directory; 4: that entry gone and a cache/io_error plan that
        # aborts its store, on another copy; 5: replicas cold together on
        # an empty directory, racing to publish. Their warm_s are taken
        # four starts at once, not the start cost of one
        broken, faulty = root / "cache_corrupt", root / "cache_fault"
        shutil.copytree(cache, broken)
        shutil.copytree(cache, faulty)
        name = build.persist_key("median").filename()
        (faulty / name).unlink()
        raw = bytearray((broken / name).read_bytes())
        raw[-4096] ^= 0x01
        # nm03-lint: disable=NM351 the flipped byte in place is the drill: bit rot in a published entry
        (broken / name).write_bytes(bytes(raw))
        rc, report = cache_cli("--dir", str(broken), "verify")
        require(rc == 1 and len(report["corrupt"]) == 1, f"verify after the flip: {rc} {report}")
        plan = json.dumps({"seed": 3, "faults": [{"site": "cache", "kind": "io_error"}]})
        shared = root / "shared"
        corrupt, fault, *reps = ready(
            start("corrupt", broken), start("store_fault", faulty, extra=("--fault-plan", plan)),
            *[start(f"r{i}", shared) for i in range(COMPILE_CACHE_REPLICAS)])
        step("four_starts")
        for s_ in (corrupt, fault):
            require(sources(s_) == {**dict.fromkeys(build.SOURCES, "cache"), "median": "built"},
                    f"{s_['tag']} {sources(s_)}")
            require(serve(s_["url"], s_["tag"]) == answers, f"{s_['tag']} answers differ")
            count(s_["url"])
        out["corrupt"] = {**hub_of(corrupt), "verify_before": report["corrupt"]}
        out["store_fault"] = hub_of(fault)
        out["corrupt"]["stop_s"] = stop(corrupt, n_libs - 1, 1)
        out["store_fault"]["stop_s"] = stop(fault, n_libs - 1, 1, (
            "--expect-counter", "resilience_faults_injected_total{site=cache,kind=io_error}==1"))
        rc, report = cache_cli("--dir", str(broken), "verify")
        require(rc == 0 and report["ok"] == n_libs, f"verify after the rebuild: {rc} {report}")
        tmps = list(faulty.glob("*.tmp"))
        require(len(tmps) == 1 and not (faulty / name).exists(),
                f"after the aborted store: {tmps}")
        old = time.time() - 3600  # past the ten-minute grace for a live writer's tmp
        os.utime(tmps[0], (old, old))
        rc, report = cache_cli("--dir", str(faulty), "gc")
        require(rc == 0 and report["removed"] == [tmps[0].name] and report["kept"] == n_libs - 1,
                f"gc: {rc} {report}")
        out["store_fault"]["gc"] = report
        step("corrupt_and_store_fault")
        for s in reps:
            hub = s["readyz"]["compile_hub"]
            require(hub["cache_hits"] + hub["cache_misses"] == n_libs, f"{s['tag']} {hub}")
            require(serve(s["url"], s["tag"]) == answers, f"{s['tag']} answers differ")
            count(s["url"])
        rc, report = cache_cli("--dir", str(shared), "verify")
        require(rc == 0 and report["ok"] == n_libs and report["entries"] == n_libs,
                f"verify after the concurrent cold start: {rc} {report}")
        step("together")
        out["together"] = {"seconds": max(s["warm_s"] for s in reps), "replicas": [
            {"warm_s": s["warm_s"], "hits": s["readyz"]["compile_hub"]["cache_hits"],
             "misses": s["readyz"]["compile_hub"]["cache_misses"]} for s in reps]}

        # -- 6. a relaunch from the cache through nm03-fleet restart, on its
        # own (the fleet phase walks three)
        walked = reps[:COMPILE_CACHE_RELAUNCHES]
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.fleet.cli", "restart",
             "--replicas", ",".join(s["url"] for s in walked), "--compile-cache-dir", str(shared),
             "--format", "json", "--warm-timeout-s", "300"],
            cwd=repo, env=env, capture_output=True, text=True, timeout=900)
        restart_s = time.perf_counter() - t0
        report = json.loads(res.stdout) if res.stdout.strip() else {}
        detached += [e["new_pid"] for e in report.get("replicas", []) if e.get("new_pid")]
        require(res.returncode == 0 and report.get("ok"), f"fleet restart: {res.stderr[-3000:]}")
        restarted = []
        require(len(report["replicas"]) == len(walked), f"fleet restart walked {report}")
        for e, s in zip(report["replicas"], walked):
            require(e["compile_cache_hits"] == n_libs and e["builds"] == 0,
                    f"relaunch of {e['replica']}: {e}")
            _, st = get_json(s["url"] + "/readyz")
            require(st["replica"]["pid"] == e["new_pid"], f"{e['replica']} pid")
            require(serve(s["url"], f"relaunched {e['replica']}") == answers,
                    f"relaunched {e['replica']} answers differ")
            count(s["url"])
            hub = st["compile_hub"]
            lib_s = sum(r["load_s"] for r in hub["libraries"].values())
            cap_s = sum(v or 0.0 for v in hub["capture_seconds"].values())
            until_app = st["replica"]["start_unix"] - e["spawned_unix"]
            restarted.append({
                "replica": e["replica"], "drain_s": e["drain_s"], "warm_s": e["warm_s"],
                "compile_cache_hits": e["compile_cache_hits"], "builds": e["builds"],
                "until_app_s": round(until_app, 3), "libraries_load_s": round(lib_s, 4),
                "capture_s": round(cap_s, 4),
                "rest_s": round(e["warm_s"] - until_app - lib_s - cap_s, 3)})
        out["restart"] = {"seconds": restart_s, "replicas": restarted}
        step("restart")
        emit({"phase": "compile_cache", **out, "steps_s": step.spent, "serve_s": served_s,
              "compile_cache_launches": launches,
              "seconds": time.perf_counter() - phase_t0, "nvidia_smi": smi})
        require(launches["fused"] > 0 and launches["grow"] > 0, f"launches {launches}")
        return launches
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        for pid in detached:
            stop_detached(pid)


def select_ops(x, k: int) -> float:
    """Operations the select kernel's first design (a bisection on the
    key's bits) ran on ``x`` at window k, kept as ``first_design_bound_ms``
    beside the new design's floor, so that old and new times share one
    yardstick: per output the
    k*k-sample scan for its extreme keys and first NaN (3 a sample), then
    k*k compares and adds for each bisection step, one a bit from the
    highest where the window's least and greatest keys differ (none for a
    window of one value). Counted on the card from this input's windows."""
    import torch.nn.functional as F

    r = k // 2
    xp = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (r, r, r, r), mode="replicate")
    hi = F.max_pool2d(xp, k, stride=1)
    lo = -F.max_pool2d(-xp, k, stride=1)

    def keys(v):
        u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)

    diff = (keys(lo) ^ keys(hi)).double()
    steps = torch.where(diff > 0, torch.floor(torch.log2(diff.clamp(min=1))) + 1,
                        torch.zeros_like(diff))
    return float(3 * k * k * x.numel() + 2 * k * k * steps.sum())


def _windows(x, k: int, b: int):
    """Slice b's k x k clamp-to-edge windows, (H W, k*k), row-major."""
    import torch.nn.functional as F

    r = k // 2
    xp = F.pad(x[b][None, None], (r, r, r, r), mode="replicate")
    return F.unfold(xp, k)[0].t().contiguous()


def bisection_passes(x, k: int):
    """The passes of the select and wide kernels' bisection (``csrc/
    median.cu``) on ``x``'s windows at k: ``(passes, warp passes,
    outputs, wide warp passes)``, summed over the outputs.

    The passes run the kernels' rule on each window's sorted keys: l =
    least key, u = greatest + 1; cand = l + (u - l) / 2; below = keys <
    cand; l = the least key >= cand if below <= k*k/2, else u = the
    greatest key < cand, + 1; until u - l = 1. A NaN window runs none.
    The warp passes are the sum over the select's warps (32 outputs of a
    row) of their slowest lane's passes, times 32: what the warps issue;
    the wide warp passes the same over the wide kernel's warps (4 outputs
    of a row, 8 columns apart), times 4."""
    rank = (k * k) // 2
    passes, warp, outputs, wide = 0.0, 0.0, 0, 0.0
    for b in range(x.shape[0]):
        w = _windows(x, k, b).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        w = torch.where(w >= 0x80000000, (~w) & 0xFFFFFFFF, w | 0x80000000)
        w = torch.sort(w, dim=1).values
        lo, hi = w[:, 0], w[:, -1]
        nan = (lo < 0x007FFFFF) | (hi > 0xFF800000)
        l, u = lo.clone(), hi + 1
        n = torch.zeros_like(lo)
        run = (u - l > 1) & ~nan
        while bool(run.any()):
            cand = l + (u - l) // 2
            below = torch.searchsorted(w, cand[:, None]).squeeze(1)
            succ = w.gather(1, below.clamp(max=k * k - 1)[:, None]).squeeze(1)
            pred = w.gather(1, (below - 1).clamp(min=0)[:, None]).squeeze(1)
            up = below <= rank
            l = torch.where(run & up, succ, l)
            u = torch.where(run & ~up, pred + 1, u)
            n += run.long()
            run = run & (u - l > 1)
        h, wd = x.shape[-2:]
        rows = torch.nn.functional.pad(n.view(h, wd), (0, (-wd) % 32)).view(h, -1, 32)
        passes += float(n.sum())
        warp += float(rows.max(dim=2).values.sum()) * 32
        wide += float(rows.view(h, -1, 4, 8).max(dim=2).values.sum()) * 4
        outputs += n.numel()
    return passes, warp, outputs, wide


def select_design_ops(x, k: int, passes=None) -> dict:
    """Operations the select kernel (``csrc/median.cu``) runs on ``x`` at
    window k, from this input's windows, and its passes (``passes``:
    :func:`bisection_passes` of ``x`` at k where already counted).

    Per output: the sort of the column segments, shared by a CTA's 8 x 32
    outputs (each key of the staged (8 + k - 1) x (32 + k - 1) tile
    compared with the k keys of its first segment, then two a further
    segment; a compare and an add each), the extreme keys (2 k), and per
    pass of the bisection (:func:`bisection_passes`), for each of the k
    segments, ceil(log2(k + 1)) probes (a compare and a select) and the
    sum, least and greatest (3). The count does not need the planes to fit
    a block, so it is also the least count of a known exact design past
    the select's last window."""
    lv = k.bit_length()
    passes, warp, outputs = (passes or bisection_passes(x, k))[:3]
    ih, iw = 8 + k - 1, 32 + k - 1
    sort = 2 * iw * (ih * k + 2 * (8 * k - ih)) / (8 * 32)
    per_pass = k * (2 * lv + 3)
    return {"ops": outputs * (sort + 2 * k) + passes * per_pass,
            "passes_per_output": passes / outputs, "warp_passes_per_output": warp / outputs}


def bitonic_pairs(k: int) -> int:
    """Compare-exchanges of the wide kernel's bitonic sort of a k-key
    segment (``csrc/median.cu``): over every stage, the pairs whose upper
    place is below k (the others meet +inf and are skipped)."""
    n, pairs, size = 1 << max(0, (k - 1).bit_length()), 0, 2
    while size <= n:
        d = size // 2
        while d:
            for p in range(n // 2):
                i = ((p & ~(d - 1)) << 1) | (p & (d - 1))
                pairs += (i ^ (size - 1) if d == size // 2 else i | d) < k
            d //= 2
        size *= 2
    return pairs


def wide_upkeep_ops(x, k: int, rows: int) -> float:
    """Operations of the wide kernel's walk down its bands on ``x`` at k:
    for each tile column of each row but a band's first, where the key
    that leaves and the key that enters differ, two binary searches
    (ceil(log2(k + 1)) probes, a compare and an add each) and a move of
    each key between the two places, plus the entering key's write.
    Counted on the card from this input: the places are the counts below
    each key in the column's segment of the row above."""
    b, h, w = x.shape
    r, lv, iw = k // 2, k.bit_length(), 32 + k - 1
    first = torch.zeros(h, dtype=torch.bool, device=x.device)
    first[::rows] = True
    total = 0.0
    for sl in range(b):
        u = x[sl].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        key = torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
        ys = torch.arange(h, device=x.device)
        ko = key[(ys - 1 - r).clamp(0, h - 1)]  # (h, w): the key leaving row y's segment
        kn = key[(ys + r).clamp(0, h - 1)]  # and the one entering
        cost = torch.zeros((h, w), dtype=torch.float64, device=x.device)
        for y in range(1, h):
            seg = key[(torch.arange(k, device=x.device) + y - 1 - r).clamp(0, h - 1)]
            p = (seg < ko[y]).sum(0)
            q = (seg < kn[y]).sum(0) - (ko[y] < kn[y]).long()
            moved = ko[y] != kn[y]
            cost[y] = torch.where(moved, 4 * lv + (p - q).abs() + 1, 0).double()
        cost[first] = 0
        col = cost.sum(0)  # a canvas column's upkeep over the rows
        tile_cols = torch.arange(iw, device=x.device) - r
        for x0 in range(0, w, 32):
            total += float(col[(tile_cols + x0).clamp(0, w - 1)].sum())
    return total


def wide_design_ops(x, k: int, rows: int, passes=None) -> dict:
    """Operations the wide kernel (``csrc/median.cu``) runs on ``x`` at
    window k in bands of ``rows`` rows, from this input's windows, and its
    passes: each tile's sort of its strip's 32 + k - 1 column segments (a
    compare-exchange of the bitonic network, :func:`bitonic_pairs`, a min
    and a max), the walk down the band (:func:`wide_upkeep_ops`), and per
    output the extreme keys (2 k) and per pass of the bisection
    (:func:`bisection_passes`), for each of its k segments, ceil(log2(k +
    1)) probes (a compare and an add) and the sum, least and greatest
    (3): the select's count with the segments shared down the rows
    instead of across a 2D tile.

    The count is least at one band a slice (``rows`` = the height): a
    band's first row sorts each column (2 x :func:`bitonic_pairs` a
    column) where a later row moves a key (at most 4 ceil(log2(k + 1)) + k
    + 1), and the sort costs more for every k (tests). The wrapper picks
    shorter bands to fill the card."""
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm

    passes, warp, outputs, wide = passes or bisection_passes(x, k)
    b, h, w = x.shape
    tiles = b * -(-h // rows) * -(-w // hm.WIDE_COLS)
    sort = tiles * 2 * bitonic_pairs(k) * (hm.WIDE_COLS + k - 1)
    upkeep = wide_upkeep_ops(x, k, rows)
    ops = sort + upkeep + outputs * 2 * k + passes * k * (2 * k.bit_length() + 3)
    return {"ops": ops, "sort_ops_per_output": sort / outputs,
            "upkeep_ops_per_output": upkeep / outputs, "passes_per_output": passes / outputs,
            "warp_passes_per_output": wide / outputs, "rows": rows, "tiles": tiles}


def signed_keys_input(shape, seed: int):
    """Signed zeros, ±1 and negatives on ``shape`` (b, h, w) with w > 255; in
    slice 0 a NaN at (10, 200) and a negative NaN at (2, 255), so that at k
    = 223 some windows hold neither, some the first, some both (the second
    first in row-major order)."""
    rng = np.random.default_rng(seed)
    z = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, -3.5], np.float32), size=shape,
                   p=[0.25, 0.25, 0.2, 0.2, 0.1])  # the rank in the -0.0s, +0.0s above
    z = np.where(z < -2, z + rng.random(shape).astype(np.float32), z)  # distinct negatives
    z[0, 10, 200] = np.float32("nan")
    z[0, 2, 255] = np.array(0xFFC00000, np.uint32).view(np.float32)
    return torch.from_numpy(z)


def key_sort_median(x, k: int):
    """The k x k clamp-to-edge median of ``x`` by the order-preserving keys
    of the select and wide kernels: the rank-(k*k // 2) key of each
    window's keys, a NaN window's first NaN in row-major order. Independent
    of the kernels' bisection; on the card its ±0 order is the plain
    network's (``torch.minimum`` gives -0.0 both ways)."""
    out = torch.empty_like(x)
    for b in range(x.shape[0]):
        wins, meds = _windows(x, k, b), []
        for w in wins.split(1024):
            u = w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            key = torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
            mid = key.kthvalue((k * k) // 2 + 1, dim=1).values
            bits = torch.where(mid >= 0x80000000, mid & 0x7FFFFFFF, (~mid) & 0xFFFFFFFF)
            med = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
            nan = torch.isnan(w)
            first = w.gather(1, nan.to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0]
            meds.append(torch.where(nan.any(dim=1), first, med.view(torch.float32)))
        out[b] = torch.cat(meds).view(x.shape[-2:])
    return out


def median_library_ms(x, k: int, repeats: int = 5) -> float:
    """``torch.median(dim=-1)`` over the replicate-padded, unfolded k x k
    windows of every slice of ``x``: the one PyTorch call that computes
    the median filter (a yardstick; the port never calls it). The
    unfolding is set-up, outside the time."""
    w = torch.cat([_windows(x, k, b) for b in range(x.shape[0])])
    ms = cuda_ms(lambda: torch.median(w, dim=-1), repeats=repeats)
    del w
    return ms


def grow_design_ops(img, seeds, valid, low, high, block_iters, max_iters, tiles) -> float:
    """Word-steps the global grow kernel (``csrc/grow.cu``) computes on this
    input, times 9 operations a word (the first design's count stepped
    every word at every step): per super-step, each
    tile of a running slice that is not quiet (its popcount or a
    neighbour's changed in the last super-step) steps its held words, at
    step t of s the held rows within s - t of its own. The region follows
    the plain schedule, connectivity 4 (the pipeline's)."""
    import torch.nn.functional as F
    from nm03_capstone_project_tpu_torch.ops.morphology import dilate
    from nm03_capstone_project_tpu_torch.ops.region_growing import grow_band

    b, h, w = img.shape
    ww = (w + 31) // 32
    tr, tw, halo = tiles.rows, tiles.words, tiles.halo
    ty, tx = -(-h // tr), -(-ww // tw)
    band = grow_band(img, low, high, valid)
    region = seeds.bool() & band

    def tile_counts(r):
        pad = F.pad(r.to(torch.int32), (0, tx * tw * 32 - w, 0, ty * tr - h))
        return pad.view(b, ty, tr, tx, tw * 32).sum(dim=(2, 4))

    def cost(s):  # word-steps of one tile's super-step of s steps, (ty, tx)
        out = torch.zeros((ty, tx), dtype=torch.float64)
        for yi in range(ty):
            r0, r1 = yi * tr, min(h, yi * tr + tr)
            hr0, hr1 = max(0, r0 - halo), min(h, r1 + halo)
            up, nown = r0 - hr0, r1 - r0
            rows = sum(min(hr1 - hr0, up + nown + s - t) - max(0, up - (s - t))
                       for t in range(1, s + 1))
            for xi in range(tx):
                c0, c1 = xi * tw, min(ww, xi * tw + tw)
                out[yi, xi] = rows * (min(ww, c1 + 1) - max(0, c0 - 1))
        return out.to(img.device)

    costs = {}
    counts = tile_counts(region)
    changed = torch.ones((b, ty, tx), dtype=torch.bool, device=img.device)
    act = torch.ones(b, dtype=torch.bool, device=img.device)
    prev = region.sum(dim=(-2, -1))
    total, j = 0.0, 0
    while True:
        done = 0
        while done < block_iters:
            s = min(halo, block_iters - done)
            if s not in costs:
                costs[s] = cost(s)
            near = F.max_pool2d(changed.float()[:, None], 3, stride=1, padding=1)[:, 0] > 0
            stepped = near & act[:, None, None]
            total += float((stepped * costs[s]).sum())
            nxt = region
            for _ in range(s):
                nxt = dilate(nxt, 3, "cross") & band
            region = torch.where(act[:, None, None], nxt, region)
            new = tile_counts(region)
            changed = (new != counts) & stepped
            counts = new
            done += s
        count = region.sum(dim=(-2, -1))
        act = act & (count != prev) & ((j + 1) * block_iters < max_iters)
        if not bool(act.any()):
            return 9.0 * total
        prev = count
        j += 1


def envelope_phantoms(h: int, w: int, seed: int, lesion_radius: float = 0.12):
    """Two phantoms on an h x w canvas on the card, one of full size, one smaller."""
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice

    dims = [(h, w), (h - h // 8, w - w // 5)]
    return pad_to_canvas([phantom_slice(a, b, seed=seed + i, lesion_radius=lesion_radius)
                          for i, (a, b) in enumerate(dims)], (h, w), device="cuda")


def envelope_grow_inputs(bt, pre_kw: dict):
    """The grow kernel's inputs from a phantom batch: the plain preprocess,
    the seeds and the valid mask."""
    from nm03_capstone_project_tpu_torch.core import valid_mask
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
    from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask

    hw = tuple(bt.pixels.shape[-2:])
    pre = hm._fused_preprocess_plain(extend_edges(bt.pixels, bt.dims), **pre_kw)
    return pre, seed_mask(bt.dims, hw), valid_mask(bt.dims, hw)


def envelope_huge_inputs(pre_kw: dict):
    """The grow's inputs at 20,000 x 20,000: two phantoms at 5000 x 5000
    upsampled on the card (a phantom that size would take the host tens of
    seconds)."""
    side, up = ENVELOPE_HUGE
    return tuple(t.repeat_interleave(up, dim=-2).repeat_interleave(up, dim=-1)
                 for t in envelope_grow_inputs(envelope_phantoms(side, side, 10), pre_kw))


def envelope_limit_input():
    """The select kernel's batch at MAX_SELECT_WINDOW: random, seeded."""
    gen = torch.Generator(device="cpu").manual_seed(63)
    return (torch.rand(ENVELOPE_LIMIT, generator=gen) * 4000 + 0.68).to("cuda")


def envelope_wide_inputs(pre_kw: dict):
    """The wide route's main path: ``(golden, phantom batch, fused input,
    median input)`` of testdata/envelope_wide_golden.json's phantoms."""
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges

    golden = json.loads((build.PKG / "testdata" / "envelope_wide_golden.json").read_text())
    c = ENVELOPE_WIDE_PIPELINE[0]
    bt = envelope_phantoms(c, c, golden["case"]["seeds"][0], golden["case"]["lesion_radius"])
    fx = extend_edges(bt.pixels, bt.dims)
    mx = clip_intensity(normalize(fx, pre_kw["norm_low"], pre_kw["norm_high"],
                                  pre_kw["norm_min"], pre_kw["norm_max"]),
                        pre_kw["clip_low"], pre_kw["clip_high"])
    return golden, bt, fx, mx


def envelope_device_times(median_x, fused_x, pre_kw: dict) -> dict:
    """The envelope routes' own device times (:func:`device_ms`), taken
    early, right after the ``grow`` phase: late in this script, and in one
    process after about a million plain-op launches, the profiler's windows
    have come back with few or none of the kernels' records, never this
    early (``PERF.md`` §7). ``{row: (ms, method, missed windows)}`` for the
    select at each ENVELOPE_WINDOWS on the main batch and at
    MAX_SELECT_WINDOW, the wide route at k = 65, the split route at k = 17
    (its select and sharpen kernels, summed a call) and the sharpen kernel
    alone on its median image at 9 and 33 taps and, at 9, the earlier design
    (:func:`sharpen_earlier_design`) and on the canvas-3072
    ``process_batch``'s median image, and the global grow at 4096 x 4096 and
    20,000 x 20,000."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges

    t0 = time.perf_counter()
    sel, gg = hm.vector_median_select_kernel, hg.region_grow_global_kernel
    times = {}
    for k in ENVELOPE_WINDOWS:
        times[f"select_k{k}"] = device_ms(lambda: hm.vector_median_filter_kernel(median_x, k),
                                          "select_kernel", sel, repeats=5)
    lim_x, klim = envelope_limit_input(), hm.MAX_SELECT_WINDOW
    times[f"select_k{klim}"] = device_ms(lambda: hm.vector_median_filter_kernel(lim_x, klim),
                                         "select_kernel", sel, repeats=5)
    mx, wk = envelope_wide_inputs(pre_kw)[3], ENVELOPE_WIDE_PIPELINE[1]
    times[f"wide_k{wk}"] = device_ms(lambda: hm.vector_median_filter_kernel(mx, wk),
                                     "wide_kernel", hm.vector_median_wide_kernel, repeats=5)
    kw = dict(pre_kw, median_window=ENVELOPE_WINDOWS[0])
    shp = hm.sharpen_filter_kernel
    times["split"] = device_ms(lambda: hm.fused_preprocess_kernel(fused_x, **kw),
                               ("select_kernel", "sharpen_kernel"), shp, repeats=5)
    med = split_median(fused_x, kw)
    for row, ks in (("sharpen", kw["sharpen_kernel"]), ("sharpen_33", ENVELOPE_TAPS)):
        times[row] = device_ms(lambda: shp(med, kw["sharpen_gain"], kw["sharpen_sigma"], ks),
                               "sharpen_kernel", shp, repeats=5)
    earlier = sharpen_earlier_design(med, kw)
    times["sharpen_earlier"] = device_ms(earlier, "sharpen_kernel", earlier, repeats=5)
    del med
    # the canvas-3072 process_batch's median image (envelope_phase's inputs)
    c, k = ENVELOPE_PIPELINE
    bt = envelope_phantoms(c, c, 30)
    ckw = preprocess_kwargs(PipelineConfig(canvas=c, median_window=k))
    big = split_median(extend_edges(bt.pixels, bt.dims), ckw)
    times["sharpen_3072"] = device_ms(lambda: shp(big, ckw["sharpen_gain"], ckw["sharpen_sigma"],
                                                  ckw["sharpen_kernel"]), "sharpen_kernel", shp,
                                      repeats=5)
    times["sharpen_3072_shape"] = list(big.shape)
    del big, bt
    cfg = PipelineConfig(canvas=256)
    for name, (img, seeds, valid), repeats in (
            ("grow_4096", envelope_grow_inputs(envelope_phantoms(4096, 4096, 10), pre_kw), 5),
            ("grow_huge", envelope_huge_inputs(pre_kw), 3)):
        gkw = dict(valid=valid, block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters)
        times[name] = device_ms(lambda: hg.region_grow_kernel(img, seeds, cfg.grow_low,
                                                              cfg.grow_high, **gkw),
                                "grow_global_kernel", gg, repeats=repeats)
    times["seconds"] = time.perf_counter() - t0
    return times


def sharpen_earlier_design(med, kw: dict):
    """One launch of the earlier sharpen design on ``med`` at the main path's
    taps: ``nm03_sharpen``'s staged plan (32 x 64 tiles, one tile a CTA),
    which the wrapper runs only past the windowed plan's taps. A callable
    that counts its own launches (``.launches``) and no wrapper's."""
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm

    b, h, w = med.shape
    ks, rows, cols = kw["sharpen_kernel"], hm.SHARPEN_ROWS, hm.SHARPEN_COLS
    out = torch.empty_like(med)
    taps = hm._device_taps(float(kw["sharpen_sigma"]), ks, med.device)
    tiles = b * -(-h // rows) * -(-w // cols)

    def launch():
        err = build.load("fused").nm03_sharpen(
            med.data_ptr(), out.data_ptr(), taps.data_ptr(), None, b, h, w, ks,
            kw["sharpen_gain"], rows, cols, hm.PLANS.index("staged"), tiles,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "nm03_sharpen (staged)")
        launch.launches += 1
        return out

    launch.launches = 0
    return launch


def split_median(fused_x, kw: dict):
    """The split route's median image: the window's median kernel with
    normalize and clip on load, as ``fused_preprocess_kernel`` launches it."""
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm

    pro = hm.Prologue.of(kw["norm_low"], kw["norm_high"], kw["norm_min"], kw["norm_max"],
                         kw["clip_low"], kw["clip_high"])
    return hm.vector_median_filter_kernel(fused_x, kw["median_window"], pro)


def envelope_phase(median_x, fused_x, pre_kw: dict, smi: str, kernels: dict, reset, times):
    """The routes past the generated plans and past one cluster, each held
    bitwise against its plain version on the card; then ``process_batch``
    at canvas 3072 with k = 17, the main path of the select, split and
    global routes, and at canvas 256 with k = 65, the wide route's (and
    the split route's again).

    ``median_x`` and ``fused_x`` are the main batch's median and fused
    inputs, ``times`` the routes' device times (:func:`envelope_device_times`).
    Returns ``(results, launches)``: the five new rows' numbers
    (``median_select`` at k = 17, ``median_wide`` at k = 65, the
    ``fused_split`` route at k = 17, the ``sharpen`` kernel at 9 taps on
    its median image, ``grow_global`` at 4096 x 4096) and the launches of
    the main runs (the wide route's and its second sharpen from its own)."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
    from nm03_capstone_project_tpu_torch.ops.median import (
        vector_median_filter,
        vector_median_filter_sort,
    )
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
    from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
    from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    t_phase = time.perf_counter()
    step = StepTimer(t_phase)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(14)
    sel = hm.vector_median_select_kernel
    results, line = {}, {"phase": "envelope"}

    def same_bits(a, b) -> bool:
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def timed_once(fn):
        """``(fn(), its milliseconds)``, CUDA events around one call: a plain
        median at a wide window takes seconds, so its check's one call is
        also its row's plain time."""
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)

    # -- the median past the plans: exact selection -------------------------
    cases = []
    rand_x = (torch.rand(MAIN_SHAPE, generator=gen) * 4000 + 0.68).to(dev)
    for k in ENVELOPE_WINDOWS:
        for name, x in (("main", median_x), ("random", rand_x)):
            require(hm.median_launch_shape(*x.shape, k).route == "select", f"k={k} route")
            before = (sel.launches, hm.vector_median_filter_kernel.launches)
            got, want = hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k)
            torch.cuda.synchronize()
            require(same_bits(got, want), f"median select != plain ({name}, k={k})")
            require((sel.launches, hm.vector_median_filter_kernel.launches)
                    == (before[0] + 1, before[1]), f"k={k}: not one select launch")
            cases.append(f"{name}:k{k}")
    xb = (torch.rand(ENVELOPE_BATCH, generator=gen) * 4000 + 0.68).to(dev)
    split = {}
    for k in (7, ENVELOPE_WINDOWS[0]):
        before = sel.launches + hm.vector_median_filter_kernel.launches
        got, want = hm.vector_median_filter_kernel(xb, k), vector_median_filter(xb, k)
        torch.cuda.synchronize()
        require(same_bits(got, want), f"median != plain at {ENVELOPE_BATCH} slices, k={k}")
        split[f"k{k}"] = sel.launches + hm.vector_median_filter_kernel.launches - before
        require(split[f"k{k}"] == -(-ENVELOPE_BATCH[0] // hm.MAX_BATCH),
                f"{ENVELOPE_BATCH[0]} slices went in {split[f'k{k}']} launches")
    del xb, got, want
    # signed zeros at the median rank, and a NaN: the plain network's answer
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                                    size=(4, 40, 40), p=[0.35, 0.35, 0.15, 0.15])).to(dev)
    z[0, 5, 5] = float("nan")
    zeros = {}
    for k in ENVELOPE_WINDOWS:
        got, want = hm.vector_median_filter_kernel(z, k), vector_median_filter(z, k)
        torch.cuda.synchronize()
        require(same_bits(got, want), f"median select != plain on signed zeros and NaN, k={k}")
        is_zero = want == 0
        zeros[f"k{k}"] = {"zero_medians": int(is_zero.sum()),
                          "negative_zero_medians": int((is_zero & torch.signbit(want)).sum()),
                          "nan_medians": int(torch.isnan(want).sum())}
    pair = torch.tensor([-0.0, 0.0], device=dev), torch.tensor([0.0, -0.0], device=dev)
    zeros["torch_minimum_signbit"] = torch.signbit(torch.minimum(*pair)).tolist()
    zeros["torch_maximum_signbit"] = torch.signbit(torch.maximum(*pair)).tolist()
    # the limit, MAX_SELECT_WINDOW, on a smaller batch
    lim_x = envelope_limit_input()
    klim = hm.MAX_SELECT_WINDOW
    before = sel.launches
    got = hm.vector_median_filter_kernel(lim_x, klim)
    want, lim_plain_ms = timed_once(lambda: vector_median_filter(lim_x, klim))
    require(same_bits(got, want), f"median select != plain at the limit, k={klim}")
    require(sel.launches == before + 1, f"k={klim}: not one select launch")
    cases.append(f"limit:k{klim}")
    del got, want
    k = ENVELOPE_WINDOWS[0]
    timing = {}
    for kk, x in [(kk, median_x) for kk in ENVELOPE_WINDOWS] + [(klim, lim_x)]:
        n = x.numel()
        first = select_ops(x, kk)
        design = select_design_ops(x, kk)
        # the floor: the bytes or this design's operations on this data;
        # the first design's count beside it, the yardstick of its times
        b_ms, b_by = bound(8 * n, {"minmax_bitwise": design["ops"]})
        first_ms = bound(8 * n, {"minmax_bitwise": first})[0]
        dev_ms, dev_by, dev_missed = times[f"select_k{kk}"]
        timing[f"k{kk}"] = {
            "shape": list(x.shape), "device_ms": dev_ms, "device_ms_by": dev_by,
            "profiler_missed": dev_missed,
            "ms": cuda_ms(lambda: hm.vector_median_filter_kernel(x, kk), repeats=5),
            "plain_ms": (lim_plain_ms if kk == klim else
                         cuda_ms(lambda: vector_median_filter(x, kk), repeats=2)),
            "library_ms": median_library_ms(x, kk, repeats=3),
            "ops_per_output": design["ops"] / n, "bound_ms": b_ms, "bound_by": b_by,
            "first_design_ops_per_output": first / n, "first_design_bound_ms": first_ms,
            "passes_per_output": design["passes_per_output"],
            "warp_passes_per_output": design["warp_passes_per_output"]}
    del lim_x
    t = timing[f"k{k}"]
    results["median_select"] = dict(max_abs_err=0.0, ms=t["ms"], device_ms=t["device_ms"],
                                    device_ms_by=t["device_ms_by"], plain_ms=t["plain_ms"],
                                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                                    first_design_bound_ms=t["first_design_bound_ms"],
                                    library_ms=t["library_ms"])
    line["median_select"] = {"bitwise": True, "cases": cases, "batch_split_launches": split,
                             "signed_zeros_and_nan": zeros, "timing": timing,
                             "limit": hm.MAX_SELECT_WINDOW}

    step("median_select")
    # -- the median past the select's planes: the wide route ----------------
    wide = hm.vector_median_wide_kernel
    wc, wk = ENVELOPE_WIDE_PIPELINE
    wide_golden, wide_bt, wide_fx, wide_mx = envelope_wide_inputs(pre_kw)
    rand_w = (torch.rand(ENVELOPE_LIMIT, generator=gen) * 4000 + 0.68).to(dev)
    small_w = (torch.rand(ENVELOPE_WIDE_SMALL, generator=gen) * 4000 + 0.68).to(dev)
    wide_cases, wide_plain_ms, wide_window_ms = [], None, {}
    checks = [("main", wide_mx, wk, vector_median_filter), ("random", rand_w, wk,
                                                             vector_median_filter)]
    # k = 127 against the plain network (934k min/max); past it (225 and 227,
    # either side of the segments' switch to a device scratch, and 257) the
    # network is millions, so the plain sort median holds them: the same
    # bits on finite data without signed zeros (ops/median.py)
    checks += [("random", small_w, ENVELOPE_WIDE[1], vector_median_filter)]
    checks += [("random", small_w, kk, vector_median_filter_sort)
               for kk in (hm.MAX_WIDE_SHARED_WINDOW, hm.MAX_WIDE_SHARED_WINDOW + 2,
                          ENVELOPE_WIDE[2])]
    wide_library_ms = {}
    for name, x, kk, plain in checks:
        require(hm.median_launch_shape(*x.shape, kk).route == "wide", f"k={kk}: not the wide route")
        before = wide.launches
        got = hm.vector_median_filter_kernel(x, kk)
        want, p_ms = timed_once(lambda: plain(x, kk))
        require(same_bits(got, want), f"median wide != {plain.__name__} ({name}, k={kk})")
        require(wide.launches == before + 1, f"k={kk}: not one wide launch")
        if name == "main":
            wide_plain_ms = p_ms
        if x is small_w:
            wide_window_ms[f"k{kk}"] = cuda_ms(lambda: hm.vector_median_filter_kernel(x, kk),
                                               repeats=3)
            wide_library_ms[f"k{kk}"] = median_library_ms(x, kk, repeats=3)
        where = "shared" if hm.wide_shared(kk) else "scratch"
        wide_cases.append(f"{name}{list(x.shape)}:k{kk}:{where}:{plain.__name__}")
    del got, want, small_w
    got, want = hm.vector_median_filter_kernel(z, wk), vector_median_filter(z, wk)
    torch.cuda.synchronize()
    require(same_bits(got, want), f"median wide != plain on signed zeros and NaN, k={wk}")
    wide_zeros = {}
    # signed zeros, negatives and NaNs of both signs either side of the
    # segments' switch to a device scratch, held to a sort of the same keys
    kzs, zshape = ENVELOPE_WIDE_KEYS
    checked = [(wk, want)]
    for kz in kzs:
        zi = signed_keys_input(zshape, kz).to(dev)
        before = wide.launches
        got_i = hm.vector_median_filter_kernel(zi, kz)
        require(wide.launches == before + 1, f"k={kz}: not one wide launch")
        want_i = key_sort_median(zi, kz)
        require(same_bits(got_i, want_i),
                f"median wide != key sort on signed zeros and NaN, k={kz}")
        checked.append((kz, want_i))
        where = "shared" if hm.wide_shared(kz) else "scratch"
        wide_cases.append(f"signed_keys{list(zshape)}:k{kz}:{where}:key_sort_median")
        del zi, got_i
    require([hm.wide_shared(kz) for kz in kzs] == [True, False],
            f"k={kzs}: not either side of the switch")
    for kk, v in checked:
        is_zero = v == 0
        wide_zeros[f"k{kk}"] = {
            "zero_medians": int(is_zero.sum()),
            "negative_zero_medians": int((is_zero & torch.signbit(v)).sum()),
            "negative_medians": int((v < 0).sum()), "nan_medians": int(torch.isnan(v).sum()),
            "negative_nan_medians": int((torch.isnan(v) & torch.signbit(v)).sum())}
    for kz in kzs:
        require(all(wide_zeros[f"k{kz}"][c] > 0 for c in ("negative_zero_medians", "nan_medians",
                                                          "negative_nan_medians")),
                f"k={kz}: the signed-zeros case does not reach -0.0 and both NaNs")
    del checked, want_i
    n = wide_mx.numel()
    counted = bisection_passes(wide_mx, wk)
    mb, mh, mw = wide_mx.shape
    per_sm = hm._wide_ctas_per_sm(0, wk)
    launched = hm.wide_launch_shape(mb, mh, mw, wk, hm._sm_count(0), per_sm)
    design = wide_design_ops(wide_mx, wk, launched.rows, counted)  # as the wrapper runs it
    one_band = wide_design_ops(wide_mx, wk, mh, counted)  # its least count
    require(one_band["ops"] <= design["ops"], "the wide count is not least at one band a slice")
    # the floor: the bytes or the least operations of a known exact design
    # on this data, this design's at one band a slice or the select's
    # (which needs no block to hold its planes in the count; the floor of
    # the first wide design, kept as its yardstick). The count at the
    # launched bands is the design's own
    least = select_design_ops(wide_mx, wk, counted)["ops"]
    b_ms, b_by = bound(8 * n, {"minmax_bitwise": min(least, one_band["ops"])})
    own_ms = bound(8 * n, {"minmax_bitwise": design["ops"]})[0]
    first_ms = bound(8 * n, {"minmax_bitwise": least})[0]
    w_dev, w_by, w_missed = times[f"wide_k{wk}"]
    w_ms = cuda_ms(lambda: hm.vector_median_filter_kernel(wide_mx, wk), repeats=5)
    w_lib = median_library_ms(wide_mx, wk, repeats=3)
    results["median_wide"] = dict(max_abs_err=0.0, ms=w_ms, device_ms=w_dev, device_ms_by=w_by,
                                  plain_ms=wide_plain_ms, bound_ms=b_ms, bound_by=b_by,
                                  own_design_bound_ms=own_ms, first_design_bound_ms=first_ms,
                                  library_ms=w_lib)
    line["median_wide"] = {
        "bitwise": True, "cases": wide_cases, "signed_zeros_and_nan": wide_zeros,
        "timed": f"k{wk} on {list(wide_mx.shape)}, the canvas-{wc} process_batch's median input",
        "ms": w_ms, "device_ms": w_dev, "device_ms_by": w_by, "profiler_missed": w_missed,
        "plain_ms": wide_plain_ms, "library_ms": w_lib, "bound_ms": b_ms, "bound_by": b_by,
        "bound_ops_per_output": min(least, one_band["ops"]) / n,
        "one_band_ops_per_output": one_band["ops"] / n,
        "ops_per_output": design["ops"] / n, "own_design_bound_ms": own_ms,
        "first_design_bound_ms": first_ms, "first_design_ops_per_output": least / n,
        "sort_ops_per_output": design["sort_ops_per_output"],
        "upkeep_ops_per_output": design["upkeep_ops_per_output"],
        "band_rows": design["rows"], "tiles": design["tiles"], "ctas_per_sm": per_sm,
        "grid": launched.grid,
        "passes_per_output": design["passes_per_output"],
        "warp_passes_per_output": design["warp_passes_per_output"],
        "ms_on_small": wide_window_ms, "library_ms_on_small": wide_library_ms,
        "shared_up_to": hm.MAX_WIDE_SHARED_WINDOW}
    del rand_w

    step("median_wide")
    # -- the fused preprocess past its plans and taps: the split route ------
    # two launches and no torch op: the window's median with normalize and
    # clip on load, then the sharpen kernel
    cases = []
    shp = hm.sharpen_filter_kernel
    med_route = {"network": "median", "select": "median_select", "wide": "median_wide"}
    rand_f = (torch.rand(MAIN_SHAPE, generator=gen) * 9000).to(dev)
    split_cases = [(name, x, k, ks) for k, ks in ((ENVELOPE_WINDOWS[0], pre_kw["sharpen_kernel"]),
                                                (pre_kw["median_window"], ENVELOPE_TAPS))
                   for name, x in (("main", fused_x), ("random", rand_f))]
    # past the select: the wide median, on the canvas-256 process_batch's fused input
    split_cases.append((f"main{list(wide_fx.shape)}", wide_fx, wk, pre_kw["sharpen_kernel"]))
    for name, x, k, ks in split_cases:
        kw = dict(pre_kw, median_window=k, sharpen_kernel=ks)
        require(hm.fused_launch_shape(*x.shape, k, ks, 132).route == "split",
                f"k={k}, {ks} taps: not the split route")
        before = {n: fn.launches for n, fn in kernels.items()}
        got, want = hm.fused_preprocess_kernel(x, **kw), hm._fused_preprocess_plain(x, **kw)
        torch.cuda.synchronize()
        require(same_bits(got, want), f"split route != plain ({name}, k={k}, {ks} taps)")
        ran = {n: fn.launches - before[n] for n, fn in kernels.items()}
        med = med_route[hm.median_launch_shape(*x.shape, k).route]
        require(ran == launch_dict(**{med: 1, "sharpen": 1}), f"split route launched {ran}")
        cases.append(f"{name}:k{k}:taps{ks}:{med}+sharpen")
    del got, want
    # the sharpen kernel alone: at the main path's 9 taps on the k = 17
    # median image, and at 33 taps, each bitwise to the plain sharpen
    kw = dict(pre_kw, median_window=ENVELOPE_WINDOWS[0])
    med_img = split_median(fused_x, kw)
    sharpen_cases = []
    for ks in (kw["sharpen_kernel"], ENVELOPE_TAPS):
        before = shp.launches
        got = shp(med_img, kw["sharpen_gain"], kw["sharpen_sigma"], ks)
        want = sharpen(med_img, kw["sharpen_gain"], kw["sharpen_sigma"], ks)
        require(same_bits(got, want), f"sharpen kernel != plain ({ks} taps)")
        require(shp.launches == before + 1, f"{ks} taps: not one sharpen launch")
        sharpen_cases.append(f"median_k{kw['median_window']}:taps{ks}")
    del got, want
    n = fused_x.numel()
    ks = kw["sharpen_kernel"]
    add_mul = (3 + 2 * (2 * ks - 1) + 3) * n
    f_bound = bound(8 * n, {"minmax_bitwise": select_ops(fused_x, ENVELOPE_WINDOWS[0]) + 2 * n,
                            "add_mul": add_mul})[0]
    med_in = clip_intensity(normalize(fused_x, kw["norm_low"], kw["norm_high"], kw["norm_min"],
                                      kw["norm_max"]), kw["clip_low"], kw["clip_high"])
    b_ms, b_by = bound(8 * n, {
        "minmax_bitwise": select_design_ops(med_in, ENVELOPE_WINDOWS[0])["ops"] + 2 * n,
        "add_mul": add_mul})
    del med_in
    f_ms = cuda_ms(lambda: hm.fused_preprocess_kernel(fused_x, **kw), repeats=5)
    f_plain = cuda_ms(lambda: hm._fused_preprocess_plain(fused_x, **kw), repeats=2)
    f_dev, f_by, f_missed = times["split"]
    results["fused_split"] = dict(max_abs_err=0.0, ms=f_ms, device_ms=f_dev, device_ms_by=f_by,
                                  plain_ms=f_plain, bound_ms=b_ms, bound_by=b_by,
                                  first_design_bound_ms=f_bound)
    line["fused_split"] = {"bitwise": True, "cases": cases, "timed": f"k{kw['median_window']}, "
                           f"{ks} taps on {list(fused_x.shape)}", "ms": f_ms,
                           "plain_ms": f_plain, "device_ms": f_dev, "device_ms_by": f_by,
                           "device_ms_of": "select_kernel + sharpen_kernel, a call",
                           "profiler_missed": f_missed, "bound_ms": b_ms, "bound_by": b_by,
                           "first_design_bound_ms": f_bound}
    # the sharpen's floor: one read of the median image, one write (8 bytes
    # an output), against two ks-tap passes and the update (4 ks + 1
    # operations an output)
    def sharpen_bound(outputs: int, taps: int):
        return bound(8 * outputs, {"add_mul": (2 * (2 * taps - 1) + 3) * outputs})

    s_bound = sharpen_bound(n, ks)
    s_ms = cuda_ms(lambda: shp(med_img, kw["sharpen_gain"], kw["sharpen_sigma"], ks), repeats=5)
    s_plain = cuda_ms(lambda: sharpen(med_img, kw["sharpen_gain"], kw["sharpen_sigma"], ks),
                      repeats=5)
    s_dev, s_by, s_missed = times["sharpen"]
    e_dev, e_by, _ = times["sharpen_earlier"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def plan(shape, taps):
        return hm.sharpen_launch_shape(*shape, taps, n_sm)._asdict()

    results["sharpen"] = dict(max_abs_err=0.0, ms=s_ms, device_ms=s_dev, device_ms_by=s_by,
                              plain_ms=s_plain, bound_ms=s_bound[0], bound_by=s_bound[1],
                              library_ms=None, earlier_design_device_ms=e_dev)
    at33, big = times["sharpen_33"], times["sharpen_3072_shape"]
    b33, b3072 = sharpen_bound(n, ENVELOPE_TAPS), sharpen_bound(math.prod(big), ks)
    line["sharpen"] = {
        "bitwise": True, "cases": sharpen_cases,
        "timed": f"{ks} taps on {list(med_img.shape)}", "ms": s_ms,
        "plain_ms": s_plain, "device_ms": s_dev, "device_ms_by": s_by,
        "profiler_missed": s_missed, "bound_ms": s_bound[0], "bound_by": s_bound[1],
        "launch_shape": plan(med_img.shape, ks),
        "earlier_design": {"of": "the staged plan, 32 x 64 tiles, one tile a CTA",
                           "device_ms": e_dev, "device_ms_by": e_by},
        "at_33_taps": {"device_ms": at33[0], "device_ms_by": at33[1], "bound_ms": b33[0],
                       "bound_by": b33[1], "launch_shape": plan(med_img.shape, ENVELOPE_TAPS),
                       "ms": cuda_ms(lambda: shp(med_img, kw["sharpen_gain"],
                                                 kw["sharpen_sigma"], ENVELOPE_TAPS),
                                     repeats=5)},
        "canvas3072": {"timed": f"{ks} taps on {big}, the canvas-3072 process_batch's median "
                                "image", "device_ms": times["sharpen_3072"][0],
                       "device_ms_by": times["sharpen_3072"][1], "bound_ms": b3072[0],
                       "bound_by": b3072[1], "launch_shape": plan(big, ks)}}
    del med_img, rand_f

    step("fused_split")
    # -- grow past one cluster: the global route, at any size -----------------
    cfg = PipelineConfig(canvas=256)
    gg = hg.region_grow_global_kernel
    cases, steps_by = [], {}
    small = envelope_grow_inputs(envelope_phantoms(256, 256, 10), pre_kw)
    grow_cases = [("forced256_conn8", small, dict(connectivity=8))]
    for h, w in ENVELOPE_CANVASES + ENVELOPE_SIDES:
        grow_cases.append((f"canvas{h}x{w}",
                           envelope_grow_inputs(envelope_phantoms(h, w, 10), pre_kw), {}))
    side, up = ENVELOPE_HUGE
    huge_name = f"canvas{side * up}x{side * up}"
    grow_cases.append((huge_name, envelope_huge_inputs(pre_kw), {}))
    huge_plain_ms = None
    jump = None
    for name, (img, seeds, valid), extra in grow_cases:
        forced = name.startswith("forced")
        if not forced:
            require(hg.grow_launch_shape(*img.shape[-2:]).route == "global", f"{name} route")
        for bi, mi in ((cfg.grow_block_iters, cfg.grow_max_iters), (2, 4)):
            kw = dict(valid=valid, block_iters=bi, max_iters=mi, return_steps=True)
            conn = extra.get("connectivity", 4)
            before = (gg.launches, hg.region_grow_kernel.launches)
            if forced:
                got = gg(img, seeds, cfg.grow_low, cfg.grow_high, **kw, **extra)
            else:
                got = hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high, **kw)
            want, p_ms = timed_once(lambda: region_grow(img, seeds, cfg.grow_low, cfg.grow_high,
                                                        connectivity=conn, **kw))
            if name == huge_name and mi == cfg.grow_max_iters:
                huge_plain_ms = p_ms
            require((gg.launches, hg.region_grow_kernel.launches) == (before[0] + 1, before[1]),
                    f"{name}: not one global launch")
            for what, a, b in zip(("mask", "converged", "steps"), got, want):
                require(torch.equal(a, b), f"grow global {what} != plain ({name}, {mi})")
            require(mi == 4 or int(want[0].sum()) > 0, f"nothing grew ({name})")
            cases.append(f"{name}:max_iters={mi}:steps={got[2].tolist()}")
            steps_by.setdefault(name, got[2].tolist())
        if name == "canvas3072x3072":
            # the jump schedule runs torch ops on any device: the card's
            # answer is the CPU's, and on these phantoms its mask is the
            # dilate fixpoint the global route reaches, though its flag
            # says not converged (12 rounds, the JAX package's budget)
            jkw = dict(valid=valid, algorithm="jump")
            jm, jc = hg.grow_dispatch(img, seeds, cfg.grow_low, cfg.grow_high, **jkw)
            cm, cc = hg.grow_dispatch(img.cpu(), seeds.cpu(), cfg.grow_low, cfg.grow_high,
                                      valid=valid.cpu(), algorithm="jump")
            dm, dc = hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high, valid=valid)
            torch.cuda.synchronize()
            require(torch.equal(jm.cpu(), cm) and torch.equal(jc.cpu(), cc),
                    "jump on the card != jump on the CPU at canvas 3072")
            require(torch.equal(jm, dm), "jump mask != the global route's at canvas 3072")
            jump = {"converged": jc.tolist(), "dilate_converged": dc.tolist(),
                    "mask_equal_dilate": True, "mask_area": [int(m.sum()) for m in jm]}
    step("grow_cases")
    gkw = dict(block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # the 20,000 x 20,000 case: its call, device time, plain time and floor
    img, seeds, valid = dict((c[0], c[1]) for c in grow_cases)[huge_name]
    hkw = dict(gkw, valid=valid)
    b, h, w = img.shape
    h_tiles = hg.global_tiles(b, h, w, cfg.grow_block_iters, n_sm)
    h_bound = bound(b * h * w * (4 + 1 + 1 + 1) + 8 * b, {"minmax_bitwise": grow_design_ops(
        img, seeds, valid, cfg.grow_low, cfg.grow_high, cfg.grow_block_iters,
        cfg.grow_max_iters, h_tiles)})
    huge = {"shape": [b, h, w], "steps": steps_by[huge_name],
            "tiles": h_tiles._asdict() | {"resident": h_tiles.resident},
            "ms": cuda_ms(lambda: hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high,
                                                        **hkw), repeats=3),
            "plain_ms": huge_plain_ms, "bound_ms": h_bound[0], "bound_by": h_bound[1]}
    huge["device_ms"], huge["device_ms_by"], huge["profiler_missed"] = times["grow_huge"]
    img, seeds, valid = dict((c[0], c[1]) for c in grow_cases)["canvas4096x4096"]
    gkw = dict(gkw, valid=valid)
    g_ms = cuda_ms(lambda: hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high, **gkw),
                   repeats=5)
    g_dev, g_by, g_missed = times["grow_4096"]
    g_plain = cuda_ms(lambda: region_grow(img, seeds, cfg.grow_low, cfg.grow_high, **gkw),
                      repeats=2)
    b, h, w = img.shape
    words = h * ((w + 31) // 32)
    steps = steps_by["canvas4096x4096"]
    g_bytes = b * h * w * (4 + 1 + 1 + 1) + 8 * b
    g_first = bound(g_bytes, {"minmax_bitwise": float(sum(steps)) * words * 9})[0]
    g_tiles = hg.global_tiles(b, h, w, cfg.grow_block_iters, n_sm)
    g_bound = bound(g_bytes, {"minmax_bitwise": grow_design_ops(
        img, seeds, valid, cfg.grow_low, cfg.grow_high, cfg.grow_block_iters,
        cfg.grow_max_iters, g_tiles)})
    # past the resident tiles: the 4096 case upsampled, every CTA walking
    # two tiles a super-step
    up = ENVELOPE_STREAMED
    big = [t.repeat_interleave(up, dim=-2).repeat_interleave(up, dim=-1)
           for t in (img, seeds, valid)]
    s_tiles = hg.global_tiles(b, h * up, w * up, cfg.grow_block_iters, n_sm)
    require(hg.grow_launch_shape(h * up, w * up).route == "global" and not s_tiles.resident,
            f"{h * up}x{w * up} x{b}: not past the resident tiles ({s_tiles})")
    skw = dict(gkw, valid=big[2], return_steps=True)
    before = gg.launches
    got = hg.region_grow_kernel(big[0], big[1], cfg.grow_low, cfg.grow_high, **skw)
    want = region_grow(big[0], big[1], cfg.grow_low, cfg.grow_high, **skw)
    torch.cuda.synchronize()
    require(gg.launches == before + 1, "streamed grow: not one global launch")
    for what, a, bb in zip(("mask", "converged", "steps"), got, want):
        require(torch.equal(a, bb), f"grow global {what} != plain ({h * up}x{w * up} x{b})")
    streamed = {"shape": [b, h * up, w * up], "tiles": g_tiles._asdict() | {"resident": g_tiles.resident},
                "streamed_tiles": s_tiles._asdict() | {"resident": s_tiles.resident},
                "steps": got[2].tolist(), "bitwise": True,
                "ms": cuda_ms(lambda: hg.region_grow_kernel(
                    big[0], big[1], cfg.grow_low, cfg.grow_high, **skw), repeats=3)}
    del got, want, big
    results["grow_global"] = dict(max_abs_err=0.0, ms=g_ms, device_ms=g_dev, device_ms_by=g_by,
                                  plain_ms=g_plain, bound_ms=g_bound[0], bound_by=g_bound[1],
                                  first_design_bound_ms=g_first)
    line["grow_global"] = {"bitwise": True, "cases": cases, "jump_at_3072": jump,
                           "timed": "4096x4096 x2", "steps": steps, "ms": g_ms,
                           "device_ms": g_dev, "device_ms_by": g_by,
                           "profiler_missed": g_missed, "plain_ms": g_plain,
                           "bound_ms": g_bound[0], "bound_by": g_bound[1],
                           "first_design_bound_ms": g_first,
                           "streamed": streamed, "huge": huge}
    del grow_cases, small, img, seeds, valid

    step("grow_timing")
    # -- process_batch at canvas 3072, k = 17: the main path of the routes ---
    c, k = ENVELOPE_PIPELINE
    bt = envelope_phantoms(c, c, 30)
    kcfg = PipelineConfig(canvas=c, median_window=k)
    pcfg = PipelineConfig(canvas=c, median_window=k, use_kernels=False)
    reset()  # the main path's run: every launch from here to the read counts
    fast = process_batch(bt.pixels, bt.dims, kcfg)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.items()}
    require(launches == launch_dict(median_select=1, sharpen=1, grow_global=1, **per_entry(1)),
            f"canvas {c}, k={k}: launches {launches}")
    slow = process_batch(bt.pixels, bt.dims, pcfg)
    torch.cuda.synchronize()
    require(torch.equal(fast["mask"], slow["mask"]), f"canvas {c}: kernel masks != plain")
    require(torch.equal(fast["grow_converged"], slow["grow_converged"]),
            f"canvas {c}: kernel grow_converged != plain")
    masks = fast["mask"].cpu().numpy()
    got = [{"sha256": hashlib.sha256(m.tobytes()).hexdigest(), "area": int(m.sum()),
            "converged": bool(cv)} for m, cv in zip(masks, fast["grow_converged"].tolist())]
    require(all(g["area"] > 0 for g in got), f"canvas {c} segmented nothing")
    golden_path = build.PKG / "testdata" / "envelope_golden.json"
    golden = json.loads(golden_path.read_text())
    require(golden["slices"] == got, f"canvas {c}: masks differ from the JAX golden")
    # each kernel of that run on its own, at the inputs process_batch gave it
    kw = preprocess_kwargs(kcfg)
    fx = extend_edges(bt.pixels, bt.dims)
    mx = clip_intensity(normalize(fx, kw["norm_low"], kw["norm_high"], kw["norm_min"],
                                  kw["norm_max"]), kw["clip_low"], kw["clip_high"])
    require(hm.median_launch_shape(*mx.shape, k).route == "select", f"canvas {c}: median route")
    got_m, want_m = hm.vector_median_filter_kernel(mx, k), vector_median_filter(mx, k)
    got_f, want_f = hm.fused_preprocess_kernel(fx, **kw), hm._fused_preprocess_plain(fx, **kw)
    torch.cuda.synchronize()
    require(same_bits(got_m, want_m), f"canvas {c}: median select != plain, k={k}")
    require(same_bits(got_f, want_f), f"canvas {c}: split route != plain, k={k}")
    del fx, mx, got_m, want_m, got_f, want_f
    t = time.perf_counter()
    process_batch(bt.pixels, bt.dims, kcfg)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t
    line["process_batch"] = {"canvas": c, "median_window": k, "slices": 2, "launches": launches,
                             "equal_plain": True, "median_and_fused_bitwise": True, "golden": golden["made_by"], "masks": got,
                             "kernels_s": pipe_s}

    step("process_batch")
    # -- process_batch at canvas 256, k = 65: the main path of the wide route
    kcfg = PipelineConfig(canvas=wc, median_window=wk)
    pcfg = PipelineConfig(canvas=wc, median_window=wk, use_kernels=False)
    reset()  # the wide route's main run: every launch from here to the read counts
    fast = process_batch(wide_bt.pixels, wide_bt.dims, kcfg)
    torch.cuda.synchronize()
    wide_launches = {n: fn.launches for n, fn in kernels.items()}
    require(wide_launches == launch_dict(median_wide=1, sharpen=1, grow=1, **per_entry(1)),
            f"canvas {wc}, k={wk}: launches {wide_launches}")
    slow = process_batch(wide_bt.pixels, wide_bt.dims, pcfg)
    torch.cuda.synchronize()
    require(torch.equal(fast["mask"], slow["mask"]), f"canvas {wc}, k={wk}: kernel masks != plain")
    require(torch.equal(fast["grow_converged"], slow["grow_converged"]),
            f"canvas {wc}, k={wk}: kernel grow_converged != plain")
    masks = fast["mask"].cpu().numpy()
    got = [{"sha256": hashlib.sha256(m.tobytes()).hexdigest(), "area": int(m.sum()),
            "converged": bool(cv)} for m, cv in zip(masks, fast["grow_converged"].tolist())]
    require(all(g["area"] > 0 for g in got), f"canvas {wc}, k={wk} segmented nothing")
    golden = wide_golden
    require(golden["case"]["canvas"] == wc and golden["case"]["median_window"] == wk
            and golden["slices"] == got, f"canvas {wc}, k={wk}: masks differ from the JAX golden")
    line["process_batch_wide"] = {"canvas": wc, "median_window": wk, "slices": 2,
                                  "launches": wide_launches, "equal_plain": True,
                                  "golden": golden["made_by"], "masks": got}
    launches = dict(launches, median_wide=wide_launches["median_wide"],
                    sharpen=launches["sharpen"] + wide_launches["sharpen"])
    step("process_batch_wide")
    line["steps_s"] = step.spent
    line["device_ms_taken"] = "after the grow phase (envelope_device_times)"
    line["device_times_s"] = times["seconds"]
    line["seconds"] = time.perf_counter() - t_phase
    line["nvidia_smi"] = smi
    emit(line)
    return results, launches


def serve_envelope_phase(smi: str, kernels: dict, reset) -> dict:
    """Every route inside the served CUDA graphs (``serve_envelope``).

    For each window of SERVE_ENVELOPE_WINDOWS a server (``ServingApp`` in
    this process, canvas 3072: the global grow in every graph; buckets 1
    and 2; two lanes on the card, each with its own stream and graphs)
    answers SERVE_ENVELOPE_PHANTOMS raw float32 phantom bodies at
    concurrency SERVE_ENVELOPE_CONCURRENCY: the two of
    ``testdata/envelope_golden.json`` and six more, of other sizes. Each
    served mask must equal ``process_batch``'s with the kernels on the same
    phantoms (the batch path), and at k = 17 that batch path's masks of the
    golden's two phantoms must equal the golden. The line has each bucket's
    kernels and capture seconds, the statuses, the lanes that answered and
    the replays' launches. Returns the launches of the three servers'
    requests (replays x the launches a graph holds; no wrapper runs outside
    a graph)."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    t_phase = time.perf_counter()
    c, buckets, lanes = SERVE_ENVELOPE
    golden = json.loads((build.PKG / "testdata" / "envelope_golden.json").read_text())
    case = golden["case"]
    require(case["canvas"] == c, f"the golden's canvas {case['canvas']} is not {c}")
    dims = [tuple(d) for d in case["dims"]]
    seeds = list(case["seeds"])
    for i in range(SERVE_ENVELOPE_PHANTOMS - len(dims)):
        dims.append((c - c // (3 + i), c - c // (4 + i)))
        seeds.append(50 + i)
    slices = [phantom_slice(h, w, seed=s, lesion_radius=case["lesion_radius"])
              for (h, w), s in zip(dims, seeds)]
    bt = pad_to_canvas(slices, (c, c), device="cuda")
    out, total = {"canvas": c, "buckets": list(buckets), "lanes": lanes, "windows": {}}, {}
    for k in SERVE_ENVELOPE_WINDOWS:
        cfg = PipelineConfig(canvas=c, median_window=k)
        batch = process_batch(bt.pixels, bt.dims, cfg)
        masks = batch["mask"].cpu().numpy()
        want = {i: hashlib.sha256(np.ascontiguousarray(masks[i, :h, :w]).tobytes()).hexdigest()
                for i, (h, w) in enumerate(dims)}
        if k == case["median_window"]:
            got = [{"sha256": hashlib.sha256(m.tobytes()).hexdigest(), "area": int(m.sum()),
                    "converged": bool(cv)}
                   for m, cv in zip(masks[:2], batch["grow_converged"][:2].tolist())]
            require(got == golden["slices"], f"k={k}: the batch path differs from the golden")
        del batch
        app = ServingApp(cfg=cfg, buckets=buckets, max_wait_s=0.05,
                         lane_devices=["cuda:0"] * lanes, result_cache_bytes=1 << 28)
        t0 = time.perf_counter()
        httpd, _, port = serve_in_thread(app)
        warm_s = time.perf_counter() - t0
        try:
            graphs = app.status()["cuda_graphs"]
            require(graphs["enabled"] and len(graphs["lanes"]) == lanes,
                    f"k={k}: graphs {graphs}")
            reset()
            app.executor.reset_replays()
            jobs = [(i, np.ascontiguousarray(slices[i]).astype("<f4").tobytes(),
                     {"Content-Type": "application/octet-stream", "X-Nm03-Height": str(h),
                      "X-Nm03-Width": str(w)}) for i, (h, w) in enumerate(dims)]
            res, wall = client_run(f"http://127.0.0.1:{port}/v1/segment?output=mask", jobs,
                                   SERVE_ENVELOPE_CONCURRENCY)
            launches = app.executor.replay_launches()
            eager = {n: fn.launches for n, fn in kernels.items() if fn.launches}
            graphs = {lane: {b: {"kernels": g["kernels"], "capture_s": g["capture_s"],
                                 "replays": g["replays"]} for b, g in bk.items()}
                      for lane, bk in app.executor.graph_stats()["lanes"].items()}
        finally:
            app.begin_drain(reason="chip_smoke")
            httpd.shutdown()
            httpd.server_close()
            app.close()
        statuses = sorted(r[0] for r in res.values())
        require(statuses == [200] * len(jobs), f"k={k}: statuses {statuses}")
        for i, (_, payload, _, _) in res.items():
            require(payload["mask_sha256"] == want[i],
                    f"k={k}: served phantom {i} {dims[i]} != the batch path")
        require(not eager, f"k={k}: wrappers ran outside the graphs: {eager}")
        routes = {17: ("median_select", "sharpen"), 65: ("median_wide", "sharpen")}.get(
            k, ("fused",))
        require(launches.get("grow_global", 0) > 0 and all(launches.get(r, 0) > 0
                                                           for r in routes),
                f"k={k}: the replays launched {launches}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        out["windows"][f"k{k}"] = {
            "warm_s": warm_s,
            "graphs": graphs,
            "statuses": statuses, "lanes_answered": sorted({r[1]["lane"] for r in res.values()}),
            "requests_per_s": len(jobs) / wall, "launches": launches,
            "equal_batch_path": True, "golden": k == case["median_window"]}
    out.update(phase="serve_envelope", launches=total,
               seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    emit(out)
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to drive", file=sys.stderr)
        return 1
    try:
        from nm03_capstone_project_tpu_torch.kernels import build, median_runs
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 1
    from nm03_capstone_project_tpu_torch.config import DEFAULT_BATCH_SIZE, PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas, valid_mask
    from nm03_capstone_project_tpu_torch.data.synthetic import (
        phantom_slice,
        smoke_cohort,
    )
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
    from nm03_capstone_project_tpu_torch.ops.launches import KERNELS
    from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
    from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
    from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
    from nm03_capstone_project_tpu_torch.ops.selection_network import comparator_counts
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    _PHASE_LOAD["load_1m"] = os.getloadavg()[0]

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    ptxas = {}
    for name in build.SOURCES:
        log = (build.build_dir() / f"{name}.log")
        if log.exists():
            ptxas.update(ptxas_report(log.read_text()))
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "compiled": {k: round(v, 3) for k, v in built.items()},
          "nvidia_smi": smi, "ptxas": ptxas,
          "fused_minmax_per_median": {
              f"k{k}_R{r}": round(median_runs.ops_per_output(k, r), 2)
              for k, r in median_runs.FUSED_RUNS.items()}})
    require(ptxas.get("fused_kernel<7,%d>" % median_runs.FUSED_RUNS[7], {}).get(
        "spill_stores") == 0, "the fused kernel spills at k = 7")

    cfg = PipelineConfig(canvas=256)
    counts = comparator_counts(cfg.median_window)
    median_ops = counts["presort_minmax"] + counts["merge_minmax_pruned_shared"]
    ks = cfg.sharpen_kernel
    # per pixel: the median and the clip's min and max; normalize (3), two
    # ks-tap passes (ks products, ks - 1 sums each) and the unsharp update (3)
    fused_ops = {"minmax_bitwise": median_ops + 2, "add_mul": 3 + 2 * (2 * ks - 1) + 3}
    pre_kw = preprocess_kwargs(cfg)

    cohort = smoke_cohort()
    batches = [
        pad_to_canvas(cohort[i : i + DEFAULT_BATCH_SIZE], cfg.canvas_hw, device=dev)
        for i in range(0, len(cohort), DEFAULT_BATCH_SIZE)
    ]
    main_px, main_dims = batches[1].pixels, batches[1].dims  # mixed true dims
    require(tuple(main_px.shape) == MAIN_SHAPE, "main batch shape")
    prime_px = torch.from_numpy(np.stack(
        [phantom_slice(*PRIME_SHAPE[1:], seed=s, lesion_radius=0.12) for s in range(3)]
    )).to(dev)
    prime_dims = torch.tensor([[251, 241], [240, 241], [251, 200]], dtype=torch.int32,
                              device=dev)
    gen = torch.Generator(device="cpu").manual_seed(7)
    results = {}
    kernels = dict(KERNELS)

    def reset():
        for fn in kernels.values():
            fn.launches = 0

    def median_input(px, dims):
        x = extend_edges(px, dims)
        return clip_intensity(normalize(x), cfg.clip_low, cfg.clip_high)

    # -- 2a. median ----------------------------------------------------------

    t_phase = time.perf_counter()
    err, cases = 0.0, []
    for shape, x in (
        ("main", median_input(main_px, main_dims)),
        ("prime", median_input(prime_px, prime_dims)),
        ("prime_random", (torch.rand(PRIME_SHAPE, generator=gen) * 4000 + 0.68).to(dev)),
    ):
        for k in ((7,) if shape == "main" else WINDOWS):
            got, want = hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"median kernel != plain ({shape}, k={k})")
            err = max(err, max_abs(got, want))
            cases.append(f"{shape}:k{k}")
    x = median_input(main_px, main_dims)
    ms = cuda_ms(lambda: hm.vector_median_filter_kernel(x, 7))
    dev_ms, dev_by, dev_missed = device_ms(lambda: hm.vector_median_filter_kernel(x, 7),
                                           "band_kernel", hm.vector_median_filter_kernel)
    plain_ms = cuda_ms(lambda: vector_median_filter(x, 7), repeats=5)
    library_ms = median_library_ms(x, 7)
    n = x.numel()
    b_ms, b_by = bound(8 * n, {"minmax_bitwise": median_ops * n})
    results["median"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, device_ms_by=dev_by,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms)
    windows = {}  # the other plans' times on the main batch, each held bitwise first
    for k in WINDOWS_TIMED:
        require(torch.equal(hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k)),
                f"median kernel != plain (main, k={k})")
        cases.append(f"main:k{k}")
        c = comparator_counts(k)
        w_dev, w_by, w_missed = device_ms(lambda: hm.vector_median_filter_kernel(x, k),
                                          "band_kernel", hm.vector_median_filter_kernel,
                                          repeats=5)
        windows[f"k{k}"] = {
            "device_ms": w_dev, "device_ms_by": w_by, "profiler_missed": w_missed,
            "ms": cuda_ms(lambda: hm.vector_median_filter_kernel(x, k), repeats=5),
            "bound_ms": bound(8 * n, {"minmax_bitwise": (
                c["presort_minmax"] + c["merge_minmax_pruned_shared"]) * n})[0]}
    emit({"phase": "median", "bitwise": True, "cases": cases, "ms": ms, "device_ms": dev_ms,
          "device_ms_by": dev_by, "profiler_missed": dev_missed,
          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
          "windows": windows, "launches": hm.vector_median_filter_kernel.launches,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 2b. fused preprocess ------------------------------------------------
    # one long study as the volume path launches it: its planes as the batch
    t_phase = time.perf_counter()
    study = long_study()
    study_x = extend_edges(torch.from_numpy(study[0]).to(dev),
                           torch.from_numpy(study[1]).to(dev).expand(LONG_STUDY[0], 2))
    err, cases = 0.0, []
    for shape, x in (
        ("main", extend_edges(main_px, main_dims)),
        ("prime", extend_edges(prime_px, prime_dims)),
        ("prime_random", (torch.rand(PRIME_SHAPE, generator=gen) * 9000).to(dev)),
        ("study%dx%d" % LONG_STUDY[:2], study_x),
    ):
        for k in ((7,) if shape in ("main", "study%dx%d" % LONG_STUDY[:2]) else WINDOWS):
            kw = dict(pre_kw, median_window=k)
            got = hm.fused_preprocess_kernel(x, **kw)
            want = hm._fused_preprocess_plain(x, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"fused kernel not finite ({shape}, k={k})")
            require(torch.equal(got, want), f"fused kernel != plain ({shape}, k={k})")
            err = max(err, max_abs(got, want))
            cases.append(f"{shape}:k{k}")
    x = extend_edges(main_px, main_dims)
    ms = cuda_ms(lambda: hm.fused_preprocess_kernel(x, **pre_kw))
    dev_ms, dev_by, dev_missed = device_ms(lambda: hm.fused_preprocess_kernel(x, **pre_kw),
                                           "fused_kernel", hm.fused_preprocess_kernel)
    plain_ms = cuda_ms(lambda: hm._fused_preprocess_plain(x, **pre_kw), repeats=5)
    n = x.numel()
    b_ms, b_by = bound(8 * n, {k: v * n for k, v in fused_ops.items()})
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tile_h, tile_w, grid, smem = hm.fused_launch_shape(
        *x.shape, cfg.median_window, cfg.sharpen_kernel, n_sm)
    # the long study in one launch: its wrapper time and bound
    study_ms = cuda_ms(lambda: hm.fused_preprocess_kernel(study_x, **pre_kw), repeats=5)
    study_bound = bound(8 * study_x.numel(), {k: v * study_x.numel() for k, v in fused_ops.items()})
    study_shape = hm.fused_launch_shape(*study_x.shape, cfg.median_window, cfg.sharpen_kernel,
                                        n_sm)
    del study_x
    results["fused"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, device_ms_by=dev_by,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    windows = {}  # the other plans' times on the main batch, each held bitwise first
    for k in WINDOWS_TIMED:
        kw = dict(pre_kw, median_window=k)
        require(torch.equal(hm.fused_preprocess_kernel(x, **kw),
                            hm._fused_preprocess_plain(x, **kw)),
                f"fused kernel != plain (main, k={k})")
        cases.append(f"main:k{k}")
        c = comparator_counts(k)
        w_ops = {"minmax_bitwise": c["presort_minmax"] + c["merge_minmax_pruned_shared"] + 2,
                 "add_mul": fused_ops["add_mul"]}
        w_dev, w_by, w_missed = device_ms(lambda: hm.fused_preprocess_kernel(x, **kw),
                                          "fused_kernel", hm.fused_preprocess_kernel,
                                          repeats=5)
        windows[f"k{k}"] = {
            "device_ms": w_dev, "device_ms_by": w_by, "profiler_missed": w_missed,
            "ms": cuda_ms(lambda: hm.fused_preprocess_kernel(x, **kw), repeats=5),
            "bound_ms": bound(8 * n, {o: v * n for o, v in w_ops.items()})[0],
            "launch_shape": list(hm.fused_launch_shape(*x.shape, k, cfg.sharpen_kernel, n_sm))}
    emit({"phase": "fused", "bitwise": True, "cases": cases, "ms": ms, "device_ms": dev_ms,
          "device_ms_by": dev_by, "profiler_missed": dev_missed,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "tile": [tile_h, tile_w], "grid": grid, "smem_bytes": smem,
          "study": {"shape": list(LONG_STUDY), "ms": study_ms, "bound_ms": study_bound[0],
                    "bound_by": study_bound[1], "launch_shape": list(study_shape)},
          "windows": windows, "launches": hm.fused_preprocess_kernel.launches,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 2c. region growing --------------------------------------------------
    t_phase = time.perf_counter()

    def grow_inputs(px, dims):
        pre = hm._fused_preprocess_plain(extend_edges(px, dims), **pre_kw)
        hw = tuple(px.shape[-2:])
        return pre, seed_mask(dims, hw), valid_mask(dims, hw)

    def canvas_batch(c: int):
        """Phantoms on a c x c canvas, one of full size and one smaller."""
        dims = [(c, c), (c - c // 8, c - c // 5)]
        slices = [phantom_slice(h, w, seed=10 + i, lesion_radius=0.12)
                  for i, (h, w) in enumerate(dims)]
        return pad_to_canvas(slices, (c, c), device=dev)

    err, cases, truncated, shapes = 0.0, [], 0, {}
    grow_cases = [("main", grow_inputs(main_px, main_dims)),
                  ("prime", grow_inputs(prime_px, prime_dims))]
    for c in GROW_CANVASES:
        bt = canvas_batch(c)
        grow_cases.append((f"canvas{c}", grow_inputs(bt.pixels, bt.dims)))
    for shape, (img, seeds, valid) in grow_cases:
        shapes[shape] = hg.grow_launch_shape(*img.shape[-2:])
        for bi, mi in ((cfg.grow_block_iters, cfg.grow_max_iters), (2, 4)):
            kw = dict(valid=valid, block_iters=bi, max_iters=mi, return_steps=True)
            gm, gc, gs = hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high, **kw)
            wm, wc, ws = region_grow(img, seeds, cfg.grow_low, cfg.grow_high, **kw)
            torch.cuda.synchronize()
            require(torch.equal(gm, wm), f"grow kernel mask != plain ({shape}, {mi})")
            require(torch.equal(gc, wc), f"grow kernel converged != plain ({shape}, {mi})")
            require(torch.equal(gs, ws), f"grow kernel steps != plain ({shape}, {mi})")
            require(mi == 4 or int(wm.sum()) > 0, f"nothing grew ({shape})")
            if mi == 4:
                truncated += int((~gc).sum())
            err = max(err, max_abs(gm, wm))
            cases.append(f"{shape}:max_iters={mi}:steps={gs.tolist()}")
    require(truncated > 0, "the truncating grow case truncated no slice")
    img, seeds, valid = grow_inputs(main_px, main_dims)
    gkw = dict(valid=valid, block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters)
    ms = cuda_ms(lambda: hg.region_grow_kernel(
        img, seeds, cfg.grow_low, cfg.grow_high, **gkw))
    dev_ms, dev_by, dev_missed = device_ms(lambda: hg.region_grow_kernel(
        img, seeds, cfg.grow_low, cfg.grow_high, **gkw), "grow_kernel", hg.region_grow_kernel)
    plain_ms = cuda_ms(lambda: region_grow(
        img, seeds, cfg.grow_low, cfg.grow_high, **gkw), repeats=5)
    # the depth of each slice's fixpoint on this data, as the kernel ran it
    steps = hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high,
                                  return_steps=True, **gkw)[2]
    b, h, w = img.shape
    words = h * ((w + 31) // 32)
    # per step and 32-pixel word: 4 neighbour shifts/ORs, 2 carries, up/down, band AND
    grow_ops = float(steps.sum()) * words * 9
    b_ms, b_by = bound(b * h * w * (4 + 1 + 1 + 1) + 4 * b, {"minmax_bitwise": grow_ops})
    results["grow"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, device_ms_by=dev_by,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "grow", "bitwise": True, "cases": cases,
          "truncated_slices": truncated, "steps_per_slice": steps.tolist(),
          "launch_shapes": shapes, "ms": ms, "device_ms": dev_ms,
          "device_ms_by": dev_by, "profiler_missed": dev_missed, "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by, "launches": hg.region_grow_kernel.launches,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # the envelope routes' device times, before the launch-heavy phases
    envelope_times = envelope_device_times(median_input(main_px, main_dims),
                                           extend_edges(main_px, main_dims), pre_kw)
    # and the 3D grow kernel's, for the volume phase
    grow3d_dev = grow3d_device_times(PipelineConfig(canvas=DRIVER_COHORT[2]))

    # -- the seed/valid and finish kernels (csrc/masks.cu) ----------------------
    results.update(masks_phase(cfg, main_px, main_dims, smi))

    # -- 3. the cohort through process_batch ---------------------------------
    t_phase = time.perf_counter()

    def run(c):
        outs = [process_batch(bt.pixels, bt.dims, c) for bt in batches]
        torch.cuda.synchronize()
        return outs

    plain_cfg = PipelineConfig(canvas=256, use_kernels=False)
    process_batch(batches[0].pixels, batches[0].dims, cfg)  # warm-up, not counted
    process_batch(batches[0].pixels, batches[0].dims, plain_cfg)
    torch.cuda.synchronize()

    reset()  # the main path's run: every launch from here to the read counts
    fast = run(cfg)
    launches = {k: fn.launches for k, fn in kernels.items()}
    slow = run(plain_cfg)
    require(launches["fused"] > 0 and launches["grow"] > 0
            and launches["seeds"] == launches["finish"] == len(batches),
            f"the main path did not launch every kernel: {launches}")
    for i, (a, p) in enumerate(zip(fast, slow)):
        require(torch.equal(a["mask"], p["mask"]), f"batch {i}: kernel masks != plain")
        require(torch.equal(a["grow_converged"], p["grow_converged"]),
                f"batch {i}: kernel grow_converged != plain")
    masks = torch.cat([o["mask"] for o in fast]).cpu().numpy()
    conv = torch.cat([o["grow_converged"] for o in fast]).cpu().numpy()
    golden_path = build.PKG / "testdata" / "smoke_masks.json"
    golden = json.loads(golden_path.read_text())["slices"]
    for g in golden:
        i = g["index"]
        got = {"sha256": hashlib.sha256(masks[i].tobytes()).hexdigest(),
               "area": int(masks[i].sum()), "converged": bool(conv[i])}
        require(got == {k: g[k] for k in got}, f"slice {i}: mask differs from the golden")
    require(masks.shape == (len(cohort), 256, 256), "mask shape")
    require(int(masks.sum()) > 0, "the cohort segmented nothing")

    # the standalone median kernel's path: one batch, fuse_preprocess=False
    unfused_cfg = PipelineConfig(canvas=256, fuse_preprocess=False)
    reset()
    unfused = process_batch(batches[1].pixels, batches[1].dims, unfused_cfg)
    torch.cuda.synchronize()
    unfused_launches = {k: fn.launches for k, fn in kernels.items()}
    require(unfused_launches["median"] > 0 and unfused_launches["grow"] > 0
            and unfused_launches["seeds"] == unfused_launches["finish"] == 1,
            f"the unfused path did not launch its kernels: {unfused_launches}")
    require(torch.equal(unfused["mask"], fast[1]["mask"]), "unfused masks != fused masks")
    launches["median"] = unfused_launches["median"]

    # a canvas past the old one-CTA limit: phantoms at 1024 through process_batch
    big = canvas_batch(1024)
    big_fast = process_batch(big.pixels, big.dims, PipelineConfig(canvas=1024))
    big_slow = process_batch(big.pixels, big.dims, PipelineConfig(canvas=1024, use_kernels=False))
    torch.cuda.synchronize()
    require(torch.equal(big_fast["mask"], big_slow["mask"]), "canvas 1024: kernel masks != plain")
    require(torch.equal(big_fast["grow_converged"], big_slow["grow_converged"]),
            "canvas 1024: kernel grow_converged != plain")
    require(int(big_fast["mask"].sum()) > 0, "canvas 1024 segmented nothing")

    # throughput, host clock around whole cohort runs ending in a synchronize;
    # plain, kernels, kernels, plain in turns
    runs = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain") * 2:
        t = time.perf_counter()
        run(cfg if which == "kernels" else plain_cfg)
        runs[which].append(time.perf_counter() - t)
    fast_s, slow_s = statistics.median(runs["kernels"]), statistics.median(runs["plain"])

    # where a batch's time goes: device time by kernel over 4 batches
    from torch.profiler import ProfilerActivity, profile

    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for bt in batches[:4]:
            process_batch(bt.pixels, bt.dims, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if getattr(e, "self_device_time_total", 0) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in by_kernel)
    emit({"phase": "profile", "batches": 4, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if by_kernel else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if by_kernel else "not measured",
          "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in by_kernel[:10]],
          "seconds": time.perf_counter() - t_prof, "nvidia_smi": smi})

    n = len(cohort)
    emit({"phase": "slice", "slices": n, "batch": DEFAULT_BATCH_SIZE, "canvas": 256,
          "kernels_slices_per_s": n / fast_s, "plain_slices_per_s": n / slow_s,
          "kernels_s": runs["kernels"], "plain_s": runs["plain"],
          "golden_slices": len(golden),
          "converged": int(conv.sum()), "mask_area": int(masks.sum()),
          "launches": launches, "unfused_launches": unfused_launches,
          "canvas1024_mask_area": int(big_fast["mask"].sum()),
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})

    # -- 4. the batch drivers -------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="nm03_driver_") as tmp:
        driver_launches, driver_out = driver_phase(Path(tmp), smi, kernels, reset)
        # -- 5. single-slice serving --------------------------------------
        serve_launches = serve_phase(driver_out, smi, kernels, reset)
        # -- 6. the 3D volume path ----------------------------------------
        volume_launches, volume_out = volume_phase(Path(tmp), driver_out["cohort"], study,
                                                   smi, kernels, reset, grow3d_dev)
        results["grow3d"] = volume_out["grow3d"]
        # -- 7. multi-device inference on the one card --------------------
        shard_launches = shard_phase(Path(tmp), driver_out, volume_out, study,
                                     (cohort, masks, conv), smi, kernels, reset)
        # -- 8. whole-study serving ---------------------------------------
        serve_volume_launches = serve_volume_phase(Path(tmp), driver_out, volume_out, smi,
                                                   kernels, reset)
        # -- 9. the U-Net students ----------------------------------------
        student_launches = student_phase(Path(tmp), driver_out, volume_out, smi, kernels,
                                         reset)
        # -- 10. the service under load and under faults -------------------
        operate_launches = operate_phase(Path(tmp), driver_out, smi, kernels, reset)
        # -- 11. a fleet of replicas on the card --------------------------
        fleet_launches = fleet_phase(Path(tmp), driver_out, smi)
        # -- 12. the lock-order witness ------------------------------------
        lockdep_launches = lockdep_phase(Path(tmp), driver_out, smi, kernels, reset)
        # -- 13. --sanitize ------------------------------------------------
        sanitize_launches = sanitize_phase(Path(tmp), driver_out, smi, kernels, reset)
        # -- 14. the kernel-library cache ---------------------------------
        compile_cache_launches = compile_cache_phase(Path(tmp), driver_out, smi, kernels,
                                                     reset)

    # -- 15. the kernels over the JAX package's whole envelope ---------------
    envelope_results, envelope_launches = envelope_phase(
        median_input(main_px, main_dims), extend_edges(main_px, main_dims), pre_kw, smi,
        kernels, reset, envelope_times)
    results.update(envelope_results)
    # -- 16. every route inside the served graphs -----------------------------
    serve_envelope_launches = serve_envelope_phase(smi, kernels, reset)

    # -- 17. kernels ---------------------------------------------------------
    # name, source, TPU kernel, and the launch key its main-path counts read:
    # the split route's calls are its sharpen launches (its median launches
    # count under the median route's own key)
    meta = {
        "median": ("vector_median_filter", "csrc/median.cu",
                   "nm03_capstone_project_tpu/ops/pallas_median.py:101", "median"),
        "fused": ("fused_preprocess", "csrc/fused.cu",
                  "nm03_capstone_project_tpu/ops/pallas_median.py:165", "fused"),
        "grow": ("region_grow", "csrc/grow.cu",
                 "nm03_capstone_project_tpu/ops/pallas_region_growing.py:30", "grow"),
        "median_select": ("vector_median_filter:select", "csrc/median.cu",
                          "nm03_capstone_project_tpu/ops/pallas_median.py:101",
                          "median_select"),
        "median_wide": ("vector_median_filter:wide", "csrc/median.cu",
                        "nm03_capstone_project_tpu/ops/pallas_median.py:101", "median_wide"),
        "fused_split": ("fused_preprocess:split", "csrc/median.cu",
                        "nm03_capstone_project_tpu/ops/pallas_median.py:165", "sharpen"),
        "sharpen": ("sharpen", "csrc/fused.cu",
                    "nm03_capstone_project_tpu/ops/pallas_median.py:165", "sharpen"),
        "grow_global": ("region_grow:global", "csrc/grow.cu",
                        "nm03_capstone_project_tpu/ops/pallas_region_growing.py:30",
                        "grow_global"),
        "grow3d": ("region_grow_3d", "csrc/grow3d.cu",
                   "none (the JAX package's 3D growth is XLA ops)", "grow3d"),
        "seeds": ("seed_valid_masks", "csrc/masks.cu",
                  "none (the JAX package's seed grid and valid mask are XLA ops)", "seeds"),
        "finish": ("finish_mask", "csrc/masks.cu",
                   "none (the JAX package's cast, dilation and cut are XLA ops)", "finish"),
    }
    rows = []
    for key, (name, src, replaces, lk) in meta.items():
        r = results[key]
        new_route = key in envelope_results
        rows.append({
            "name": name, "route": "cuda",
            "source": f"nm03_capstone_project_tpu_torch/{src}", "replaces": replaces,
            # the main path's launches: the envelope's process_batch for the
            # routes past the plans and one cluster, the volume driver's for
            # the 3D growth, the batch drivers' for the rest
            "launches": (envelope_launches[lk] if new_route else volume_launches[lk]
                         if key == "grow3d" else driver_launches[key]),
            "slice_launches": launches.get(lk, 0),
            "serve_launches": serve_launches.get(lk, 0),
            "volume_launches": volume_launches.get(lk, 0),
            "serve_volume_launches": serve_volume_launches.get(lk, 0),
            "student_launches": student_launches.get(lk, 0),
            "operate_launches": operate_launches.get(lk, 0),
            "fleet_launches": fleet_launches.get(lk, 0),
            "shard_launches": shard_launches.get(lk, 0),
            "lockdep_launches": lockdep_launches.get(lk, 0),
            "sanitize_launches": sanitize_launches.get(lk, 0),
            "compile_cache_launches": compile_cache_launches.get(lk, 0),
            "envelope_launches": envelope_launches[lk],
            "serve_envelope_launches": serve_envelope_launches.get(lk, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "device_ms_by": r["device_ms_by"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **{b: r[b] for b in ("own_design_bound_ms", "first_design_bound_ms",
                                 "earlier_design_device_ms") if b in r},
        })
    emit({"phase": "script", "seconds": round(time.perf_counter() - _SCRIPT_T0, 3),
          "nvidia_smi": smi})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 a failed phase fails the run, after its traceback
        traceback.print_exc()
        sys.exit(1)
