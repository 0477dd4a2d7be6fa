"""The port's multi-process jobs over ``torch.distributed``, on the CPU.

In process: :func:`..parallel.distributed.initialize` is a no-op alone,
joins a world of 1, is idempotent, and refuses a world size that differs
from ``--num-processes`` with both numbers.

Real 2-process ``gloo`` jobs, each on a free port (retried with a fresh
one when the coordinator loses its port, as ``tests/test_multihost.py``
does) and each held to a hard subprocess timeout, so a hang is a failure:

1. the z-sharded mask over both ranks (halo planes over
   ``batch_isend_irecv``, counts over ``all_reduce``) equals the
   single-device mask;
2. ``nm03-parallel --distributed`` over a synthetic cohort: the rank
   manifests are disjoint and complete, every JPEG pair is there, and rank
   0's results carry the ``cluster`` totals;
3. ``nm03-volume --z-shard --distributed``: its files equal a one-process
   ``nm03-volume`` run's byte for byte; and when rank 0's export of one
   patient fails, both ranks still meet at that patient's outcome
   collective, count it failed and go on to the next (no hang);
4. ``process_volume_batch_zsharded`` over a process-group ('data', 'z')
   mesh, both ways round, equals the in-process one;
5. ``nm03-train --distributed``: rank 0's checkpoint and final loss equal
   a one-process run's within the tolerance below; rank 1 writes nothing;
   and ``fit_distributed`` over two ranks whose shards are uneven (4 and
   3 slices, the second wrap-padded by ``pad_local_shard``) equals JAX
   ``fit_distributed`` over the padded global batch, at the one-step
   bounds of ``tests/test_torch_train_sharded.py``;
6. ``nm03-serve --distributed-init`` over two ranks: the served studies
   equal the volume driver's masks and ``volume_golden.json``; SIGTERM to
   rank 0 stops both ranks cleanly;
7. a follower killed between studies: the next study gets 503 with
   ``Retry-After`` at once, ``/readyz`` says the gang is down, and
   ``POST /v1/segment`` still answers on rank 0.
"""

import base64
import hashlib
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

import pytest
import torch

from nm03_capstone_project_tpu_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parents[1]
JOB_TIMEOUT_S = 120
# a 2-rank data-parallel run sums the same slices' loss in another order:
# its curve stays within this relative distance of the one-process run's
TRAIN_RTOL = 1e-4
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID",
                "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_job(argv_of, tmp_path, nproc, port, attempt):
    """Start the ranks; (rcs, outs, errs) once all exit or the timeout ends them."""
    # output to files, not pipes: a full pipe between two ranks blocked in
    # a collective would hang the job
    logs = [(open(tmp_path / f"a{attempt}_r{r}.out", "w+"),
             open(tmp_path / f"a{attempt}_r{r}.err", "w+")) for r in range(nproc)]
    procs = [subprocess.Popen(argv_of(r, port), stdout=logs[r][0], stderr=logs[r][1],
                              text=True, cwd=tmp_path, env=_env())
             for r in range(nproc)]
    rcs, outs, errs = [], [], []
    try:
        for r, p in enumerate(procs):
            try:
                rcs.append(p.wait(timeout=JOB_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                rcs.append(None)
            outs.append((tmp_path / f"a{attempt}_r{r}.out").read_text())
            errs.append((tmp_path / f"a{attempt}_r{r}.err").read_text())
    finally:
        for p in procs:  # a hung or failed sibling must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in logs:
            fo.close()
            fe.close()
    return rcs, outs, errs


def run_job_with_port_retry(argv_of, tmp_path, nproc=2, attempts=3, want_rc=0):
    """Run an nproc job, retrying with a fresh port when rank 0's store
    loses its port between :func:`_free_port` and the bind. Asserts every
    rank exits ``want_rc`` within the timeout; returns their stdouts."""
    for attempt in range(attempts):
        rcs, outs, errs = _run_job(argv_of, tmp_path, nproc, _free_port(), attempt)
        err0 = errs[0].lower()
        bind_lost = rcs[0] not in (0, None) and (
            "address already in use" in err0 or "failed to bind" in err0
            or "eaddrinuse" in err0)
        if bind_lost and attempt < attempts - 1:
            continue
        for r in range(nproc):
            assert rcs[r] is not None, f"rank {r} hung past {JOB_TIMEOUT_S}s:\n{errs[r][-3000:]}"
            assert rcs[r] == want_rc, f"rank {r} rc={rcs[r]}:\n{errs[r][-3000:]}"
        return outs
    raise AssertionError("unreachable")


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)


class TestInProcess:
    def test_initialize_alone_is_a_no_op(self, no_launcher):
        assert distributed.initialize(device="cpu") is False
        assert not distributed.is_initialized()
        assert distributed.process_info() == {
            "process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
        mesh = distributed.global_mesh(("z",), device="cpu")
        assert mesh.shape == {"z": 1} and not mesh.process_group
        assert mesh.devices.reshape(-1).tolist() == [torch.device("cpu")]

    def test_global_mesh_outside_a_job_is_the_card_by_default(self, no_launcher, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        mesh = distributed.global_mesh(("z",))
        assert mesh.devices.reshape(-1).tolist() == [torch.device("cuda")]
        assert distributed.local_device() == torch.device("cuda")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.global_mesh(("z",))

    def test_world_of_one_joins_and_is_idempotent(self, no_launcher):
        addr = f"127.0.0.1:{_free_port()}"
        try:
            assert distributed.initialize(addr, 1, 0, device="cpu") is True
            assert distributed.initialize(addr, 1, 0, device="cpu") is True
            assert distributed.process_count() == 1 and distributed.process_index() == 0
            assert distributed.allgather([3, 2 ** 40]).tolist() == [[3, 2 ** 40]]
            assert distributed.broadcast_one_to_all([5]).tolist() == [5]
            distributed.barrier()
        finally:
            distributed.shutdown()
        assert not distributed.is_initialized()

    def test_gang_headers_travel_on_the_host_over_the_control_group(self, no_launcher,
                                                                     monkeypatch):
        """A dispatch header goes on the host over ``control_group()`` (in
        an NCCL job its gloo side group, stood in for here by a second gloo
        group), the study over the job's own group."""
        import torch.distributed as dist

        try:
            assert distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
            assert distributed.control_group() is None  # gloo: the job's own group
            side = dist.new_group(backend="gloo")
            monkeypatch.setattr(distributed, "_CONTROL", side)
            calls, real = [], dist.broadcast

            def spy(t, src, group=None, **kw):
                calls.append((t.device.type, t.numel(), group))
                return real(t, src, group=group, **kw)

            monkeypatch.setattr(dist, "broadcast", spy)
            op, vol, dm = distributed.broadcast_study(
                distributed.OP_STUDY, np.ones((2, 3, 4), np.float32), [3, 4])
            assert calls == [("cpu", 6, side), ("cpu", 24, None)]
            assert op == distributed.OP_STUDY and tuple(vol.shape) == (2, 3, 4)
            assert dm.tolist() == [3, 4]
            assert distributed.broadcast_study(distributed.OP_KEEPALIVE) == (
                distributed.OP_KEEPALIVE, None, None)
            assert calls[-1] == ("cpu", 6, side)
        finally:
            distributed.shutdown()
        assert distributed.control_group() is None

    def test_world_size_mismatch_raises_with_both_numbers(self, no_launcher, monkeypatch):
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(_free_port()))
        monkeypatch.setenv("WORLD_SIZE", "3")
        monkeypatch.setenv("RANK", "0")
        with pytest.raises(ValueError, match=r"world size 3 \(\$WORLD_SIZE\) differs from "
                                             r"--num-processes 2"):
            distributed.initialize(num_processes=2, device="cpu")
        assert not distributed.is_initialized()

    def test_explicit_request_without_an_address_raises(self, no_launcher):
        with pytest.raises(ValueError, match="no coordinator address"):
            distributed.initialize(num_processes=2, process_id=0, device="cpu")
        with pytest.raises(ValueError, match=r"process id 2 outside \[0, 2\)"):
            distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")

    def test_backend_follows_the_device(self, monkeypatch):
        assert distributed.backend_for("cpu") == "gloo"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert distributed.backend_for("cuda") == "nccl"
        assert distributed.backend_for() == "nccl"

    def test_a_launcher_of_one_is_no_job(self, no_launcher, monkeypatch):
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("WORLD_SIZE", "1")
        assert distributed.initialize(device="cpu") is False


ZSHARD_WORKER = r'''
import sys
import numpy as np
import torch
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
from nm03_capstone_project_tpu_torch.parallel import distributed, process_volume_zsharded
from nm03_capstone_project_tpu_torch.pipeline import process_volume

rank, world, port = (int(a) for a in sys.argv[1:4])
assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
mesh = distributed.global_mesh(("z",))
assert mesh.process_group and mesh.shape == {"z": world}
vol = phantom_volume(16, 64, 64, seed=3)
dims = np.asarray([64, 64], np.int32)
for morph, cap in ((3, 512), (5, 512), (3, 3)):
    cfg = PipelineConfig(canvas=64, min_dim=16, grow_block_iters=1 if cap == 3 else 8,
                         grow_max_iters=cap, morph_size=morph)
    got = process_volume_zsharded(vol, dims, cfg, mesh)
    want = process_volume(vol, dims, cfg, device="cpu")
    same = torch.equal(got["mask"], want["mask"])
    conv = bool(got["grow_converged"]) == bool(want["grow_converged"])
    print(f"ZSOK {rank} {morph} {cap} {int(same and conv)} {int(got['mask'].sum())} "
          f"{int(bool(got['grow_converged']))}")
print("GATHER", rank, distributed.allgather([rank, 2 ** 40 + rank]).tolist())
distributed.shutdown()
'''


def _cohort_args(n_patients, n_slices):
    return ["--synthetic", str(n_patients), "--synthetic-slices", str(n_slices),
            "--canvas", "64", "--min-dim", "32", "--device", "cpu"]


def _files(root: pathlib.Path) -> dict:
    """Every output file but the cohort and the rank bookkeeping, by path."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "synthetic-cohort" not in str(p)
            and not p.name.startswith("manifest") and p.name != "slices.journal"
            and p.suffix != ".json"}


@pytest.mark.multiproc
class TestTwoProcessJobs:
    def test_zsharded_mask_over_two_ranks_equals_one_device(self, tmp_path):
        script = tmp_path / "zshard_worker.py"
        script.write_text(ZSHARD_WORKER)
        outs = run_job_with_port_retry(
            lambda r, port: [sys.executable, str(script), str(r), "2", str(port)], tmp_path)
        rows = {}
        for r, out in enumerate(outs):
            lines = [ln.split() for ln in out.splitlines() if ln.startswith("ZSOK")]
            assert len(lines) == 3, out
            for _, rank, morph, cap, ok, voxels, conv in lines:
                assert int(rank) == r and ok == "1", out
                rows.setdefault((morph, cap), set()).add((voxels, conv))
            gathered = [ln for ln in out.splitlines() if ln.startswith("GATHER")]
            assert gathered == [f"GATHER {r} [[0, {2 ** 40}], [1, {2 ** 40 + 1}]]"]
        # both ranks hold the same whole mask; the capped run truncated
        assert all(len(v) == 1 for v in rows.values())
        ((_, capped_conv),) = rows[("3", "3")]
        assert capped_conv == "0"

    def test_parallel_driver_shards_patients(self, tmp_path):
        out = tmp_path / "out"

        def argv_of(r, port):
            return [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.parallel",
                    "--output", str(out), *_cohort_args(3, 3), "--batch-size", "2",
                    "--results-json", str(tmp_path / f"results{r}.json"),
                    "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(r)]

        outs = run_job_with_port_retry(argv_of, tmp_path)
        assert "process 0/2: 2 patients assigned" in outs[0]
        assert "process 1/2: 1 patients assigned" in outs[1]
        manifests = [json.loads((out / f"manifest.rank{r}.json").read_text()) for r in (0, 1)]
        assert not (out / "manifest.json").exists()
        assert set(manifests[0]).isdisjoint(manifests[1])
        patients = sorted(set(manifests[0]) | set(manifests[1]))
        assert len(patients) == 3
        for pid in patients:
            stems = {**manifests[0], **manifests[1]}[pid]
            assert len(stems) == 3 and set(stems.values()) == {"done"}
            for stem in stems:
                for kind in ("original", "processed"):
                    assert (out / pid / f"{stem}_{kind}.jpg").stat().st_size > 0
        rec = json.loads((tmp_path / "results0.json").read_text())
        assert rec["process_count"] == 2
        cluster = rec["cluster"]
        assert (cluster["patients_ok"], cluster["patients_total"], cluster["slices_ok"],
                cluster["slices_total"]) == (3, 3, 9, 9)
        assert cluster["per_process"]["1"]["slices_ok"] == 3
        assert not (tmp_path / "results1.json").exists()  # rank 0 writes the results

    def test_global_zshard_volume_driver_equals_one_process(self, tmp_path):
        common = [*_cohort_args(2, 5), "--export-mhd", "--morph-size", "5"]
        solo = tmp_path / "solo"
        assert subprocess.run(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.volume",
             "--output", str(solo), *common], cwd=tmp_path, env=_env(),
            capture_output=True, timeout=JOB_TIMEOUT_S).returncode == 0
        out = tmp_path / "out"

        def argv_of(r, port):
            return [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.volume",
                    "--output", str(out), *common, "--z-shard",
                    "--results-json", str(tmp_path / "results.json"),
                    "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(r)]

        outs = run_job_with_port_retry(argv_of, tmp_path)
        assert all("z-sharding volumes over 2 global devices" in o for o in outs)
        assert all("Successfully processed 2/2 patients." in o for o in outs)
        want, got = _files(solo), _files(out)
        assert len(want) == 2 * (2 * 5 + 2) and got == want
        # rank 0 keeps the one manifest, equal to the one-process run's
        assert (out / "manifest.json").read_bytes() == (solo / "manifest.json").read_bytes()
        assert not list(out.glob("manifest.rank*.json"))
        rec = json.loads((tmp_path / "results.json").read_text())
        assert rec["z_sharded"] and rec["z_global"] and rec["z_shards"] == 2

    def test_global_zshard_rank0_export_failure_reaches_every_rank(self, tmp_path):
        out = tmp_path / "out"
        out.mkdir()
        # rank 0's export of the first patient fails: its directory is a file
        (out / "PGBM-0001").write_text("not a directory")

        def argv_of(r, port):
            return [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.volume",
                    "--output", str(out), *_cohort_args(2, 4), "--z-shard",
                    "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(r)]

        outs = run_job_with_port_retry(argv_of, tmp_path, want_rc=1)
        assert all("Successfully processed 1/2 patients." in o for o in outs)
        assert len(list((out / "PGBM-0002").glob("*.jpg"))) == 8
        # the last attempt's stderr (an earlier one may have lost its port)
        errs = [sorted(tmp_path.glob(f"a*_r{r}.err"))[-1].read_text() for r in (0, 1)]
        assert "Patient PGBM-0001 failed" in errs[0]
        assert "Patient PGBM-0001: export failed on the exporting rank" in errs[1]


BATCH_ZSHARD_WORKER = r"""
import sys
import numpy as np
import torch
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
from nm03_capstone_project_tpu_torch.parallel import (
    Mesh, distributed, make_mesh, process_volume_batch_zsharded)

rank, world, port = (int(a) for a in sys.argv[1:4])
assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
vols = np.stack([phantom_volume(8, 64, 64, seed=s) for s in (3, 4)]).astype(np.float32)
vols[1, :, 40:] = 0  # a smaller second study: the rows grow for different lengths
dims = np.asarray([[64, 64], [64, 40]], np.int32)
cpu = torch.device("cpu")
for names, sizes in ((("data", "z"), (1, 2)), (("data", "z"), (2, 1)), (("z", "data"), (2, 1))):
    for morph, cap in ((3, 512), (5, 512), (3, 2)):
        cfg = PipelineConfig(canvas=64, min_dim=16, grow_block_iters=1 if cap == 2 else 8,
                             grow_max_iters=cap, morph_size=morph)
        g = distributed.global_mesh(names, sizes)
        got = process_volume_batch_zsharded(vols, dims, cfg, g)
        want = process_volume_batch_zsharded(vols, dims, cfg,
                                             make_mesh(2, names, sizes, devices=[cpu] * 2))
        same = (torch.equal(got["mask"], want["mask"])
                and torch.equal(got["grow_converged"], want["grow_converged"])
                and torch.equal(got["original"], want["original"]))
        print(f"BZOK {rank} {''.join(n[0] for n in names)}{sizes[0]}{sizes[1]} {morph} {cap} "
              f"{int(same)} {int(got['mask'].sum())} {got['grow_converged'].tolist()}")
distributed.shutdown()
"""


def _get(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post(url: str, body: bytes, headers: dict, timeout: float = 90.0):
    """POST; (status, parsed json or None, headers), without raising."""
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, json.loads(raw) if raw else None, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None, dict(e.headers)


class _ServerJob:
    """Two ``nm03-serve --distributed-init`` ranks on the CPU, launched as
    torchrun would (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``).
    Rank 0 writes its HTTP port to a file; every wait is bounded."""

    def __init__(self, tmp_path, extra, follower_code=None):
        self.tmp = tmp_path
        self.port_file = tmp_path / "port.txt"
        master = _free_port()
        self.logs, self.procs = [], []
        for r in range(2):
            env = _env()
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master), WORLD_SIZE="2",
                       RANK=str(r))
            out = open(tmp_path / f"serve_r{r}.out", "w")
            err = open(tmp_path / f"serve_r{r}.err", "w")
            self.logs += [out, err]
            entry = (["-c", follower_code] if r == 1 and follower_code else
                     ["-m", "nm03_capstone_project_tpu_torch.serving.server"])
            self.procs.append(subprocess.Popen(
                [sys.executable, *entry,
                 "--device", "cpu", "--port", "0", "--port-file", str(self.port_file),
                 "--heartbeat-s", "0", "--buckets", "1", "--volume-serving",
                 "--distributed-init", "--flight-dir", str(tmp_path), *extra],
                stdout=out, stderr=err, cwd=tmp_path, env=env))
        t0 = time.monotonic()
        while not self.port_file.exists():
            assert all(p.poll() is None for p in self.procs), self.errors()
            assert time.monotonic() - t0 < JOB_TIMEOUT_S, "the server did not start"
            time.sleep(0.2)
        self.url = f"http://127.0.0.1:{int(self.port_file.read_text())}"

    def errors(self) -> str:
        return "\n".join((self.tmp / f"serve_r{r}.err").read_text()[-2000:] for r in (0, 1))

    def stop(self):
        """SIGTERM to rank 0 (the drain sends the followers the stop op);
        each rank's exit code, None for one still running at the timeout."""
        if self.procs[0].poll() is None:
            self.procs[0].send_signal(signal.SIGTERM)
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=JOB_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        return rcs

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()


# a follower that stops itself (SIGSTOP) right after it receives a study's
# header, once the file stop_follower exists in its working directory
STOP_AFTER_HEADER = r"""
import os
import signal
import sys
from nm03_capstone_project_tpu_torch.parallel import distributed
from nm03_capstone_project_tpu_torch.serving import server

real = distributed._broadcast_header


def stop_after_a_study_header(head):
    got = real(head)
    if got[0] == distributed.OP_STUDY and os.path.exists("stop_follower"):
        os.kill(os.getpid(), signal.SIGSTOP)
    return got


distributed._broadcast_header = stop_after_a_study_header
sys.exit(server.main(sys.argv[1:]))
"""


def _process_state(pid: int) -> str:
    return pathlib.Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]


def _study_parts(cohort: pathlib.Path, pid: str) -> bytes:
    """A patient's series as one ``application/x-nm03-dicom-parts`` body."""
    from nm03_capstone_project_tpu_torch.data.discovery import load_dicom_files_for_patient

    raws = [f.read_bytes() for f in load_dicom_files_for_patient(cohort, pid)]
    return b"".join(len(r).to_bytes(4, "little") + r for r in raws)


FIT_WORKER = r"""
import sys
import numpy as np
import torch
from nm03_capstone_project_tpu_torch import models as pm
from nm03_capstone_project_tpu_torch.parallel import distributed

rank, world, port = (int(a) for a in sys.argv[1:4])
torch.set_num_threads(1)
assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
z = np.load("fit_inputs.npz")
# the driver's rule: slices rank::world, padded to the size every rank agreed
x, lb, dm = pm.pad_local_shard(z["x"][rank::world], z["labels"][rank::world],
                               z["dims"][rank::world], int(z["per_rank"]))
model = pm.init_unet(torch.Generator().manual_seed(0), base=8, device="cpu")
model.load_state_dict(torch.load("fit_init.pt"))
model, losses = pm.fit_distributed(model, x, lb, dm, steps=3, lr=1e-3)
np.savez(f"fit_r{rank}.npz", losses=np.asarray(losses),
         **{k: v.numpy() for k, v in model.state_dict().items()})
print("FITOK", rank, x.shape[0])
distributed.shutdown()
"""


@pytest.mark.multiproc
class TestTwoProcessTrainingAndServing:
    def test_batched_zshard_over_a_process_group_equals_in_process(self, tmp_path):
        script = tmp_path / "batch_worker.py"
        script.write_text(BATCH_ZSHARD_WORKER)
        outs = run_job_with_port_retry(
            lambda r, port: [sys.executable, str(script), str(r), "2", str(port)], tmp_path)
        rows = {}
        for r, out in enumerate(outs):
            lines = [ln.split(maxsplit=6) for ln in out.splitlines() if ln.startswith("BZOK")]
            assert len(lines) == 9, out
            for _, rank, layout, morph, cap, ok, rest in lines:
                assert int(rank) == r and ok == "1", out
                rows.setdefault((layout, morph, cap), set()).add(rest)
        # both ranks hold the same whole result; the capped run truncated
        assert all(len(v) == 1 for v in rows.values())
        assert all("False" in next(iter(v)) for k, v in rows.items() if k[2] == "2")
        assert all("False" not in next(iter(v)) for k, v in rows.items() if k[2] == "512")

    def test_train_distributed_reaches_the_one_process_loss(self, tmp_path):
        from nm03_capstone_project_tpu_torch import models as pm

        common = ["--device", "cpu", "--synthetic", "2", "--synthetic-slices", "4",
                  "--canvas", "64", "--min-dim", "32", "--base-channels", "8", "--steps", "8",
                  "--lr", "3e-3"]
        solo = tmp_path / "solo"
        res = subprocess.run(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.train",
             "--output", str(solo), "--results-json", str(tmp_path / "solo.json"), *common],
            cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=JOB_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-2000:]
        out = tmp_path / "out"

        def argv_of(r, port):
            return [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.train",
                    "--output", str(out), "--results-json", str(tmp_path / f"dist{r}.json"),
                    *common, "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(r)]

        outs = run_job_with_port_retry(argv_of, tmp_path)
        assert "process 0/2: 4 slices assigned" in outs[0]
        assert "process 1/2: 4 slices assigned" in outs[1]
        assert "over 2 processes x 1 device (global batch 8)" in outs[0]
        want = json.loads((tmp_path / "solo.json").read_text())
        got = json.loads((tmp_path / "dist0.json").read_text())
        assert got["slices"] == want["slices"] == 8 and got["steps"] == 8
        assert got["final_loss"] == pytest.approx(want["final_loss"], rel=TRAIN_RTOL)
        assert got["iou_vs_teacher"] == pytest.approx(want["iou_vs_teacher"], abs=1e-3)
        # rank 0 alone writes the checkpoint and the results
        assert not (tmp_path / "dist1.json").exists()
        assert sorted(p.name for p in (out / "checkpoint").iterdir()) == sorted(
            p.name for p in (solo / "checkpoint").iterdir())
        a, _ = pm.load_params(out / "checkpoint", device="cpu")
        b, _ = pm.load_params(solo / "checkpoint", device="cpu")
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.allclose(x, y, rtol=TRAIN_RTOL, atol=1e-6), name

    def test_fit_distributed_over_uneven_shards_matches_jax(self, tmp_path):
        import jax

        from nm03_capstone_project_tpu import models as jm
        from nm03_capstone_project_tpu_torch import models as pm
        from nm03_capstone_project_tpu_torch.config import PipelineConfig
        from nm03_capstone_project_tpu_torch.convert import (
            unet_params_from_jax,
            unet_params_to_jax,
        )
        from nm03_capstone_project_tpu_torch.core import pad_to_canvas
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_series

        cfg = PipelineConfig(canvas=64, grow_block_iters=8, grow_max_iters=128)
        b = pad_to_canvas(phantom_series(4, 64, 64, seed=21) + phantom_series(3, 60, 52, seed=22),
                          (64, 64), device="cpu")
        x = pm.prepare_student_inputs(b.pixels, cfg).numpy()
        labels = pm.distill_batch(b.pixels, b.dims, cfg, device="cpu").numpy()
        dims = b.dims.numpy()
        np.savez(tmp_path / "fit_inputs.npz", x=x, labels=labels, dims=dims, per_rank=4)
        rng = np.random.default_rng(23)
        jp = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
                          jm.init_unet(jax.random.PRNGKey(0), base=8))
        torch.save(unet_params_from_jax(jp, device="cpu").state_dict(), tmp_path / "fit_init.pt")
        script = tmp_path / "fit_worker.py"
        script.write_text(FIT_WORKER)
        outs = run_job_with_port_retry(
            lambda r, port: [sys.executable, str(script), str(r), "2", str(port)], tmp_path)
        assert "FITOK 0 4" in outs[0] and "FITOK 1 4" in outs[1]
        # the global batch the two padded shards make: 4 slices, then 3 and
        # the first of them again
        order = [0, 2, 4, 6, 1, 3, 5, 1]
        want_p, want = jm.fit_distributed(jp, x[order], labels[order], dims[order], steps=3,
                                          lr=1e-3)
        ranks = [np.load(tmp_path / f"fit_r{r}.npz") for r in range(2)]
        for z in ranks:
            np.testing.assert_allclose(z["losses"], want, rtol=1e-5)
        model = pm.init_unet(torch.Generator().manual_seed(0), base=8, device="cpu")
        model.load_state_dict({k: torch.from_numpy(ranks[0][k]) for k in model.state_dict()})
        for a, w in zip(jax.tree.leaves(unet_params_to_jax(model)), jax.tree.leaves(want_p)):
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-6)
        # every rank took the same steps
        assert all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0].files)

    def test_served_volumes_equal_the_driver_and_the_golden(self, tmp_path):
        from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage
        from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort

        cohort = tmp_path / "cohort"
        pids = write_synthetic_cohort(cohort, n_patients=2, n_slices=25)
        drv = tmp_path / "driver"
        res = subprocess.run(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.cli.volume", "--device",
             "cpu", "--base-path", str(cohort), "--output", str(drv), "--canvas", "256",
             "--export-mhd"], cwd=tmp_path, env=_env(), capture_output=True, text=True,
            timeout=JOB_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-2000:]
        golden = {g["patient"]: g for g in json.loads(
            (REPO / "nm03_capstone_project_tpu_torch" / "testdata" / "volume_golden.json")
            .read_text())["patients"]}
        job = _ServerJob(tmp_path, ["--canvas", "256", "--volume-depth-buckets", "32"])
        try:
            vols = _get(job.url + "/readyz")["volumes"]
            assert (vols["distributed"], vols["processes"], vols["z_shards"],
                    vols["ready"]) == (True, 2, 2, True)
            for pid in pids:
                status, payload, headers = _post(
                    job.url + "/v1/segment-volume", _study_parts(cohort, pid),
                    {"Content-Type": "application/x-nm03-dicom-parts"})
                assert status == 200, (payload, job.errors())
                assert payload["z_shards"] == 2 and headers.get("X-Nm03-Z-Shards") == "2"
                mask = np.frombuffer(base64.b64decode(payload["mask_b64"]), np.uint8).reshape(
                    payload["shape"])
                assert np.array_equal(mask, read_metaimage(drv / pid / "mask.mhd")[0])
                assert hashlib.sha256(mask.tobytes()).hexdigest() == golden[pid]["mask_sha256"]
                assert payload["grow_converged"] == golden[pid]["grow_converged"]
            assert job.stop() == [0, 0], job.errors()
        finally:
            job.close()
        assert "nm03-serve: rank 1 stopped with the gang" in (tmp_path / "serve_r1.err").read_text()

    def test_a_follower_killed_between_studies_sheds_with_retry_after(self, tmp_path):
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume

        job = _ServerJob(tmp_path, ["--canvas", "64", "--min-dim", "32",
                                    "--volume-depth-buckets", "8", "--volume-timeout-s", "60"])
        vol = phantom_volume(6, 64, 60, seed=1).astype("<f4")
        raw = {"Content-Type": "application/octet-stream", "X-Nm03-Depth": "6",
               "X-Nm03-Height": "64", "X-Nm03-Width": "60"}
        try:
            status, first, _ = _post(job.url + "/v1/segment-volume", vol.tobytes(), raw)
            assert status == 200 and first["z_shards"] == 2, job.errors()
            job.procs[1].kill()
            job.procs[1].wait(timeout=30)
            t0 = time.monotonic()
            status, payload, headers = _post(job.url + "/v1/segment-volume", vol.tobytes(), raw)
            shed_s = time.monotonic() - t0
            assert status == 503 and headers.get("Retry-After"), (status, payload)
            assert shed_s < 60  # inside the request timeout: the gang never hangs
            vols = _get(job.url + "/readyz")["volumes"]
            assert vols["ready"] is False and vols["down_cause"], vols
            # every later study sheds at once, and slices keep serving
            status, _, headers = _post(job.url + "/v1/segment-volume", vol.tobytes(), raw)
            assert status == 503 and headers.get("Retry-After")
            status, sl, _ = _post(job.url + "/v1/segment", vol[0].tobytes(),
                                  {"Content-Type": "application/octet-stream",
                                   "X-Nm03-Height": "64", "X-Nm03-Width": "60"})
            assert status == 200 and sl["mask_pixels"] >= 0
            rcs = job.stop()
            assert rcs[0] == 0 and rcs[1] == -signal.SIGKILL, job.errors()
        finally:
            job.close()

    def test_a_follower_stopped_mid_study_sheds_within_the_bound(self, tmp_path):
        from nm03_capstone_project_tpu_torch.config import PipelineConfig
        from nm03_capstone_project_tpu_torch.core import pad_to_canvas
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
        from nm03_capstone_project_tpu_torch.pipeline import process_slice

        bound = 10.0
        job = _ServerJob(tmp_path, ["--canvas", "64", "--min-dim", "32",
                                    "--volume-depth-buckets", "8",
                                    "--volume-timeout-s", str(bound),
                                    "--result-cache-bytes", "8m"],  # mask_sha256 on slices
                         follower_code=STOP_AFTER_HEADER)
        # three studies: the result tier would answer a repeated one itself
        vol, vol2, vol3 = (phantom_volume(6, 64, 60, seed=s).astype("<f4") for s in (1, 2, 3))
        raw = {"Content-Type": "application/octet-stream", "X-Nm03-Depth": "6",
               "X-Nm03-Height": "64", "X-Nm03-Width": "60"}
        try:
            status, first, _ = _post(job.url + "/v1/segment-volume", vol.tobytes(), raw)
            assert status == 200 and first["z_shards"] == 2, job.errors()
            (tmp_path / "stop_follower").write_text("")
            t0 = time.monotonic()
            status, payload, headers = _post(job.url + "/v1/segment-volume", vol2.tobytes(), raw,
                                             timeout=bound + 60)
            shed_s = time.monotonic() - t0
            assert status == 503 and headers.get("Retry-After"), (status, payload, job.errors())
            assert shed_s < bound + 5, shed_s
            assert _process_state(job.procs[1].pid) == "T"  # stopped, after the header
            assert "passed its bound" in payload["error"], payload
            with urllib.request.urlopen(job.url + "/healthz", timeout=30) as r:
                assert r.status == 200
            vols = _get(job.url + "/readyz")["volumes"]
            assert vols["ready"] is False and vols["down_cause"], vols
            # the next study sheds at once, and slices keep serving, right
            t0 = time.monotonic()
            status, _, headers = _post(job.url + "/v1/segment-volume", vol3.tobytes(), raw)
            assert status == 503 and headers.get("Retry-After") and time.monotonic() - t0 < 5
            status, sl, _ = _post(job.url + "/v1/segment", vol[2].tobytes(),
                                  {"Content-Type": "application/octet-stream",
                                   "X-Nm03-Height": "64", "X-Nm03-Width": "60"})
            b = pad_to_canvas([vol[2]], (64, 64), device="cpu")
            want = process_slice(b.pixels[0], b.dims[0], PipelineConfig(canvas=64, min_dim=32),
                                 device="cpu")["mask"][:64, :60].numpy()
            assert status == 200, (sl, job.errors())
            assert sl["mask_pixels"] == int(np.count_nonzero(want)) > 0
            assert sl["mask_sha256"] == hashlib.sha256(
                np.ascontiguousarray(want).tobytes()).hexdigest()
            assert job.procs[0].poll() is None  # rank 0 lives
            job.procs[1].kill()
            job.procs[1].wait(timeout=30)
            rcs = job.stop()
            assert rcs[0] == 0 and rcs[1] == -signal.SIGKILL, job.errors()
        finally:
            job.close()
