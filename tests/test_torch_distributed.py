"""The port's multi-process jobs over ``torch.distributed``, on the CPU.

In process: :func:`..parallel.distributed.initialize` is a no-op alone,
joins a world of 1, is idempotent, and refuses a world size that differs
from ``--num-processes`` with both numbers.

Three real 2-process ``gloo`` jobs, each on a free port (retried with a
fresh one when the coordinator loses its port, as ``tests/test_multihost.py``
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
   collective, count it failed and go on to the next (no hang).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from nm03_capstone_project_tpu_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parents[1]
JOB_TIMEOUT_S = 120
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
