"""Guards on the PyTorch port: it stands apart from the JAX package, it does
not drift onto the CPU, and its kernels count only real launches.
"""

import ctypes
import json
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import nm03_capstone_project_tpu_torch as port
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core import pad_to_canvas, resolve_device
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice, smoke_cohort
from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.pipeline import process_batch, process_slice

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "nm03_capstone_project_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b)|nm03_capstone_project_tpu\.", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_has_the_slice_modules():
    names = set(_port_modules())
    for mod in (
        "config", "convert", "core.backend", "core.image", "core.padding",
        "data.synthetic", "ops.neighborhood", "ops.elementwise",
        "ops.selection_network", "ops.median", "ops.sharpen", "ops.seeds",
        "ops.morphology", "ops.region_growing", "ops.hopper_median",
        "ops.hopper_region_growing", "kernels.build", "kernels.median_runs",
        "pipeline.slice_pipeline",
        "utils.reporter", "utils.atomicio", "utils.manifest", "utils.timing",
        "resilience.journal", "data.discovery", "data.codecs", "data.dicomlite",
        "data.gdcm_fallback", "native", "native.buildlib", "render.host_render",
        "render.contact_sheet", "render.export", "render.render", "ingest.ring",
        "ingest.pipeline", "ingest.staging", "cli.common", "cli.runner",
        "cli.sequential", "cli.parallel", "cli.test_pipeline",
        "obs.metrics", "obs.events", "obs.spans", "obs.flightrec", "obs.trace", "obs.run",
        "cache.keys", "cache.store", "resilience.policy", "resilience.supervisor",
        "serving.metrics", "serving.queue", "serving.lanes", "serving.graphs",
        "serving.executor", "serving.batcher", "serving.server",
        "ops.volume", "pipeline.volume_pipeline", "data.imageio", "cli.volume",
        "models", "models.unet", "models.unet3d", "models.train", "models.checkpoint",
        "cli.train", "cache.inflight", "serving.volumes", "ops.regionprops",
        "resilience.faultinject", "obs.saturation", "obs.ledger", "obs.slo",
        "utils.profiling", "serving.loadgen",
        "fleet", "fleet.replicas", "fleet.router", "fleet.manager", "fleet.cli",
        "serving.top", "parallel", "parallel.mesh", "parallel.dp", "parallel.zshard",
        "parallel.distributed", "serving.follower",
        "compilehub", "compilehub.persist", "compilehub.cache_cli",
    ):
        assert f"nm03_capstone_project_tpu_torch.{mod}" in names


def test_importing_the_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'nm03_capstone_project_tpu'\n"
        "             or m.startswith('nm03_capstone_project_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


# the front-end modules: stdlib orchestration that must never load a backend
# (nor claim the card) in the process that imports them
BACKEND_FREE = ("fleet", "fleet.replicas", "fleet.router", "fleet.manager", "fleet.cli",
                "serving.top", "obs.trace", "serving.metrics", "obs.metrics",
                "compilehub", "compilehub.persist", "compilehub.cache_cli")


@pytest.mark.parametrize("mod", BACKEND_FREE)
def test_front_end_modules_import_no_torch_numpy_or_jax(mod):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('nm03_capstone_project_tpu_torch.{mod}')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'numpy', 'jax', 'nm03_capstone_project_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_fleet_never_starts_a_cpu_replica():
    """The fleet's entry point takes no --device, names no device in its
    sources, and relaunches a replica only from the argv that replica
    published (tests/test_torch_fleet.py checks the relaunch verbatim): a
    replica started on the card comes back on the card."""
    from nm03_capstone_project_tpu_torch.fleet import cli

    for sub in ("serve", "restart", "flightrec", "profile"):
        with pytest.raises(SystemExit) as exc:
            cli.build_parser().parse_args([sub, "--replicas", "h:1", "--device", "cpu"])
        assert exc.value.code == 2
    for f in sorted((PORT_DIR / "fleet").glob("*.py")):
        src = f.read_text()
        assert "--device" not in src and '"cpu"' not in src, f.name


def test_parallel_imports_no_jax():
    code = (
        "import sys\n"
        "import nm03_capstone_project_tpu_torch.parallel\n"
        "import nm03_capstone_project_tpu_torch.parallel.distributed\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'nm03_capstone_project_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    for f in sorted((PORT_DIR / "parallel").glob("*.py")):
        assert not FORBIDDEN.search(f.read_text()), f.name


def test_sources_name_no_jax():
    files = [
        f for f in sorted(PORT_DIR.rglob("*.py")) + sorted(PORT_DIR.rglob("*.cu"))
        + sorted(PORT_DIR.rglob("*.cpp"))
        if "_build" not in f.relative_to(PORT_DIR).parts  # build output, not source
    ]
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    offenders = [str(f.relative_to(REPO)) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


class TestNoCpuDrift:
    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_process_batch_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        px = np.stack([phantom_slice(32, 32, seed=1)])
        dims = np.asarray([[32, 32]], np.int32)
        with pytest.raises(RuntimeError):
            process_batch(px, dims, PipelineConfig(canvas=32))
        with pytest.raises(RuntimeError):
            process_slice(px[0], dims[0], PipelineConfig(canvas=32))
        with pytest.raises(RuntimeError):
            pad_to_canvas([px[0]], (32, 32))


DRIVERS = ("sequential", "parallel", "test_pipeline", "volume", "train")
DEPLOY_MODEL = ("sequential", "parallel", "volume")  # the drivers that take --model
RESILIENT = ("sequential", "parallel")  # the drivers that take the resilience flags
DISTRIBUTED = ("sequential", "parallel", "volume")  # the drivers that take --distributed
# the drivers that take the observability flags (all but test_pipeline, as in JAX)
OBSERVED = ("sequential", "parallel", "volume", "train")
UNPORTED_FLAGS = [["--use-pallas"], ["--model", "m.ckpt"], ["--distributed"],
                  ["--device", "auto"], ["--fault-plan", "{}"], ["--metrics-out", "m.json"],
                  ["--profile-dir", "p"]]


class TestDrivers:
    DRIVERS = DRIVERS

    @pytest.mark.parametrize("name", DRIVERS)
    def test_default_device_without_cuda_exits_nonzero(self, name, tmp_path, monkeypatch,
                                                       capsys):
        import importlib

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        out = tmp_path / "out"
        argv = ["--output", str(out)]
        if name != "test_pipeline":
            argv += ["--synthetic", "1", "--synthetic-slices", "1", "--canvas", "128"]
        for extra in ([], ["--device", "cuda"]):
            assert driver.main(argv + extra) == 1
            assert "CUDA is not available" in capsys.readouterr().err
        assert not list(out.rglob("*.jpg"))  # nothing ran on the CPU instead
        assert not (out / "checkpoint").exists()  # nor was anything trained

    # ids as they were when every driver refused --model, --fault-plan,
    # --metrics-out, --profile-dir and --distributed
    @pytest.mark.parametrize("name,flag", [
        pytest.param(name, flag, id=f"flag{i}-{name}")
        for i, flag in enumerate(UNPORTED_FLAGS) for name in DRIVERS
        if not (flag[0] == "--model" and name in DEPLOY_MODEL)
        and not (flag[0] == "--fault-plan" and name in RESILIENT)
        and not (flag[0] in ("--metrics-out", "--profile-dir") and name in OBSERVED)
        and not (flag[0] == "--distributed" and name in DISTRIBUTED + ("train",))
    ])
    def test_flags_of_layers_not_ported_are_rejected(self, name, flag, capsys):
        import importlib

        from nm03_capstone_project_tpu_torch.cli import common

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        with pytest.raises(SystemExit) as exc:
            driver.build_parser().parse_args(flag)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        # the JAX driver's flag groups that the port refuses by name
        groups = {"sequential": ("observability", "resilience"),
                  "parallel": ("observability", "resilience"),
                  "volume": ("observability",),
                  "train": ("observability",),
                  "test_pipeline": ()}[name]
        reasons = {f: r for g in groups for f, r in common.NOT_PORTED[g].items()}
        if flag[0] in reasons:
            # the reason and its ROADMAP item, not argparse's bare refusal
            assert f"{flag[0]}: {reasons[flag[0]]}" in err
        else:
            assert "unrecognized arguments" in err or "invalid choice" in err

    @pytest.mark.parametrize("name", OBSERVED)
    def test_sanitize_flag_is_accepted(self, name):
        """``--sanitize`` is ported: every driver with the observability
        group parses it (off by default) instead of refusing it."""
        import importlib

        from nm03_capstone_project_tpu_torch.cli import common

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        assert driver.build_parser().parse_args(["--sanitize"]).sanitize is True
        assert driver.build_parser().parse_args([]).sanitize is False
        assert "--sanitize" not in common.NOT_PORTED["observability"]

    @pytest.mark.parametrize("name", DISTRIBUTED)
    def test_distributed_flags_are_accepted(self, name):
        import importlib

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        args = driver.build_parser().parse_args(
            ["--distributed", "--coordinator-address", "127.0.0.1:1234",
             "--num-processes", "2", "--process-id", "1"])
        assert (args.distributed, args.coordinator_address, args.num_processes,
                args.process_id) == (True, "127.0.0.1:1234", 2, 1)
        assert driver.build_parser().parse_args([]).distributed is False

    @pytest.mark.parametrize("name", DISTRIBUTED)
    def test_distributed_without_a_cluster_runs_single_process(self, name, tmp_path,
                                                               monkeypatch, capsys):
        import importlib

        for var in ("MASTER_ADDR", "SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        out = tmp_path / "out"
        argv = ["--output", str(out), "--device", "cpu", "--synthetic", "1",
                "--synthetic-slices", "2", "--canvas", "64", "--min-dim", "32",
                "--distributed"]
        assert driver.main(argv) == 0
        assert "no cluster detected; running single-process" in capsys.readouterr().err
        assert (out / "manifest.json").exists() and len(list(out.rglob("*.jpg"))) == 4

    def test_train_takes_distributed_and_trains_alone_without_a_cluster(
            self, tmp_path, monkeypatch, capsys):
        """The train driver takes --distributed and its three flags (it
        refused them until data parallel training was ported); with no
        cluster it trains in the one process."""
        from nm03_capstone_project_tpu_torch.cli import train

        args = train.build_parser().parse_args(
            ["--distributed", "--coordinator-address", "127.0.0.1:1234",
             "--num-processes", "2", "--process-id", "1"])
        assert (args.distributed, args.coordinator_address, args.num_processes,
                args.process_id) == (True, "127.0.0.1:1234", 2, 1)
        for var in ("MASTER_ADDR", "SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        out = tmp_path / "out"
        assert train.main(["--output", str(out), "--device", "cpu", "--synthetic", "1",
                           "--synthetic-slices", "3", "--canvas", "64", "--min-dim", "32",
                           "--base-channels", "8", "--steps", "2", "--distributed"]) == 0
        captured = capsys.readouterr()
        assert "no cluster detected; running single-process" in captured.err
        assert "training 2 steps at lr=0.003..." in captured.out
        assert (out / "checkpoint").is_dir()

    def test_train_distributed_refuses_the_3d_student(self, monkeypatch, tmp_path):
        """As the JAX driver: a job of several processes trains the 2D
        student only, and says so before it loads anything."""
        from nm03_capstone_project_tpu_torch.cli import common, train

        monkeypatch.setattr(common, "init_distributed", lambda args: (0, 2))
        with pytest.raises(SystemExit, match="--distributed training supports the 2D student"):
            train.main(["--output", str(tmp_path / "out"), "--device", "cpu", "--synthetic",
                        "1", "--model-3d", "--distributed"])
        assert not (tmp_path / "out").exists()

    @pytest.mark.parametrize("name", OBSERVED)
    @pytest.mark.parametrize("flag", ["--metrics-out", "--log-json", "--profile-dir"])
    def test_telemetry_flags_are_accepted_and_write_their_files(self, name, flag, tmp_path):
        import importlib

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        target = tmp_path / "telemetry"
        argv = ["--device", "cpu", "--synthetic", "1", "--synthetic-slices", "4",
                "--canvas", "64", "--min-dim", "32", "--output", str(tmp_path / "out"),
                "--heartbeat-s", "0", flag, str(target)]
        if name == "train":
            argv += ["--steps", "2", "--base-channels", "8"]
        assert driver.main(argv) == 0
        if flag == "--profile-dir":
            assert (target / "nm03.pt.trace.json").stat().st_size > 0
        elif flag == "--metrics-out":
            assert json.loads(target.read_text())["schema"] == "nm03.metrics.v1"
        else:
            events = [json.loads(line)["event"] for line in target.read_text().splitlines()]
            assert events[0] == "run_started" and events[-1] == "run_finished"
            if name != "train":
                assert events.count("patient_outcome") == 1

    @pytest.mark.parametrize("name", RESILIENT)
    @pytest.mark.parametrize("argv,field,value", [
        (["--retry-max", "5"], "retry_max", 5),
        (["--retry-backoff-s", "0.25"], "retry_backoff_s", 0.25),
        (["--dispatch-timeout-s", "7.5"], "dispatch_timeout_s", 7.5),
    ])
    def test_resilience_flags_reach_the_config(self, name, argv, field, value):
        import importlib

        from nm03_capstone_project_tpu_torch.cli import common

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        res = common.resilience_config_from_args(driver.build_parser().parse_args(argv))
        assert getattr(res, field) == value and res.fault_plan is None

    @pytest.mark.parametrize("name", RESILIENT)
    def test_fault_plan_is_accepted_and_a_bad_one_exits_1(self, name, tmp_path, capsys):
        import importlib

        from nm03_capstone_project_tpu_torch.cli import common

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        spec = '{"seed": 4, "faults": [{"site": "decode", "kind": "error", "stem": "1-01"}]}'
        plan = common.resilience_config_from_args(
            driver.build_parser().parse_args(["--fault-plan", spec])).fault_plan
        assert plan.seed == 4 and [(r.site, r.kind, r.stem) for r in plan.rules] == [
            ("decode", "error", "1-01")]
        # the compile cache's kind is ported: a driver accepts it, as the JAX
        # drivers do, and runs (its stores are the server's drill); an
        # unknown kind of the same site is refused before anything is written
        cache_plan = '{"faults": [{"site": "cache", "kind": "io_error"}]}'
        base = ["--device", "cpu", "--synthetic", "1", "--synthetic-slices", "1",
                "--canvas", "128", "--fault-plan"]
        out = tmp_path / "out"
        assert driver.main(["--output", str(out), *base, cache_plan]) == 0
        assert list(out.rglob("*.jpg"))
        bad_out = tmp_path / "bad"
        bad = '{"faults": [{"site": "cache", "kind": "evict"}]}'
        assert driver.main(["--output", str(bad_out), *base, bad]) == 1
        assert "invalid for site 'cache'" in capsys.readouterr().err
        assert not list(bad_out.rglob("*.jpg"))
        for flag in (["--fallback-cpu"], ["--no-fallback-cpu"]):
            with pytest.raises(SystemExit) as exc:
                driver.build_parser().parse_args(flag)
            assert exc.value.code == 2
            assert common.NOT_PORTED["resilience"][flag[0]] in capsys.readouterr().err

    @pytest.mark.parametrize("name", DEPLOY_MODEL)
    def test_model_is_accepted_and_a_missing_checkpoint_exits_1(self, name, tmp_path, capsys):
        import importlib

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        out = tmp_path / "out"
        argv = ["--output", str(out), "--device", "cpu", "--synthetic", "1",
                "--synthetic-slices", "1", "--canvas", "128", "--model", str(tmp_path / "ck")]
        assert driver.build_parser().parse_args(argv).model == str(tmp_path / "ck")
        assert driver.main(argv) == 1
        assert "no checkpoint at" in capsys.readouterr().err
        assert not list(out.rglob("*.jpg"))

    def test_no_kernels_flag(self):
        from nm03_capstone_project_tpu_torch.cli import common, parallel

        args = parallel.build_parser().parse_args(["--no-kernels", "--no-preprocess-fuse"])
        cfg = common.pipeline_config_from_args(args)
        assert cfg.use_kernels is False and cfg.fuse_preprocess is False
        assert common.pipeline_config_from_args(
            parallel.build_parser().parse_args([])) == PipelineConfig()
        assert common.batch_config_from_args(parallel.build_parser().parse_args(
            ["--batch-size", "7", "--render-stage", "device"])).render_stage == "device"


class TestLaunchCounters:
    def _reset(self):
        for fn in (hm.vector_median_filter_kernel, hm.fused_preprocess_kernel,
                   hg.region_grow_kernel):
            fn.launches = 0

    @pytest.mark.parametrize("fuse", [True, False])
    def test_cpu_tensors_launch_nothing(self, fuse):
        self._reset()
        b = pad_to_canvas([phantom_slice(40, 40, seed=2), phantom_slice(37, 31, seed=3)],
                          (40, 40), device="cpu")
        cfg = PipelineConfig(canvas=40, use_kernels=True, fuse_preprocess=fuse)
        out = process_batch(b.pixels, b.dims, cfg, device="cpu")
        assert int(out["mask"].sum()) > 0
        assert hm.vector_median_filter_kernel.launches == 0
        assert hm.fused_preprocess_kernel.launches == 0
        assert hg.region_grow_kernel.launches == 0

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        self._reset()
        x = torch.rand(2, 16, 16)
        with pytest.raises(ValueError, match="CUDA"):
            hm.vector_median_filter_kernel(x, 7)
        with pytest.raises(ValueError, match="CUDA"):
            hm.fused_preprocess_kernel(x)
        with pytest.raises(ValueError, match="CUDA"):
            hg.region_grow_kernel(x, x > 0.5)
        assert hm.vector_median_filter_kernel.launches == 0
        assert hm.fused_preprocess_kernel.launches == 0
        assert hg.region_grow_kernel.launches == 0

    def test_window_limits_checked_before_launch(self):
        # windows from 17 and sharpen kernels past 31 take routes of their
        # own (tests/test_torch_envelope.py), any odd window included: an
        # even window is refused before the device is looked at, a wide one
        # passes that check and reaches the device check
        wide = hm.MAX_SELECT_WINDOW + 2
        for even in (wide + 1, 0):
            with pytest.raises(ValueError, match="odd"):
                hm.vector_median_filter_kernel(torch.rand(8, 8), even)
            with pytest.raises(ValueError, match="odd"):
                hm.fused_preprocess_kernel(torch.rand(8, 8), median_window=even)
        with pytest.raises(ValueError, match="CUDA"):
            hm.vector_median_filter_kernel(torch.rand(8, 8), wide)
        with pytest.raises(ValueError, match="CUDA"):
            hm.fused_preprocess_kernel(torch.rand(8, 8), median_window=wide)
        with pytest.raises(ValueError, match="sharpen kernel"):
            hm.fused_preprocess_kernel(torch.rand(8, 8), sharpen_kernel=32)


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build._nvcc()

    def test_build_dir_is_ignored_by_git(self):
        lines = (REPO / ".gitignore").read_text().splitlines()
        assert "nm03_capstone_project_tpu_torch/_build/" in lines
        assert build.build_dir().parent == PORT_DIR / "_build"

    @pytest.mark.parametrize("lib", build.SOURCES)
    def test_argtypes_match_the_c_signatures(self, lib):
        # the bindings cannot be compiled here: hold them against the source
        src = (PORT_DIR / "csrc" / f"{lib}.cu").read_text()
        sigs = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(sigs) == set(build.ARGTYPES[lib])
        for fn, params in sigs.items():
            want = []
            for p in (q.strip() for q in params.split(",")):
                if "*" in p:
                    want.append(ctypes.c_void_p)
                elif p.startswith("float"):
                    want.append(ctypes.c_float)
                elif p.startswith("long long "):
                    want.append(ctypes.c_longlong)
                else:
                    assert p.startswith("int "), p
                    want.append(ctypes.c_int)
            assert build.ARGTYPES[lib][fn] == want, fn


def test_smoke_cohort_shape():
    cohort = smoke_cohort(n_patients=3, n_slices=2)
    assert [a.shape for a in cohort] == [(256, 256)] * 2 + [(251, 241)] * 2 + [(256, 199)] * 2
    assert all(a.dtype == np.float32 for a in cohort)


class TestServer:
    """``python -m nm03_capstone_project_tpu_torch.serving.server``."""

    def test_default_device_without_cuda_exits_nonzero(self, monkeypatch, capsys, tmp_path):
        from nm03_capstone_project_tpu_torch.serving import server

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        port_file = tmp_path / "port"
        for extra in ([], ["--device", "cuda"]):
            argv = ["--port", "0", "--port-file", str(port_file), "--heartbeat-s", "0"] + extra
            assert server.main(argv) == 1
            assert "CUDA is not available" in capsys.readouterr().err
        assert not port_file.exists()  # never listened
        # nor armed the process-wide flight recorder (its dumps land in the cwd)
        from nm03_capstone_project_tpu_torch.obs import flightrec

        assert not flightrec.get_recorder().configured

    # the ids stay those of the cases before volume serving, fault plans,
    # the SLO plane, the ledger, --distributed-init, --sanitize and the
    # compile cache were ported (flag0-flag2, flag4-flag8 and flag10 were
    # their flags, now accepted: see the tests below). flag3 was
    # --compile-cache-dir: ported, it still refuses to go without its DIR
    @pytest.mark.parametrize("flag", [pytest.param(f, id=f"flag{i}") for i, f in [
        (3, ["--compile-cache-dir"]),
        (9, ["--no-fallback-cpu"]), (11, ["--device", "auto"]),
    ]])
    def test_flags_of_layers_not_ported_are_rejected(self, flag, capsys):
        from nm03_capstone_project_tpu_torch.serving import server

        with pytest.raises(SystemExit) as exc:
            server.build_parser().parse_args(["--device", "cpu"] + flag)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        if flag[0] in server.NOT_PORTED:
            assert server.NOT_PORTED[flag[0]] in err

    def test_only_the_fallback_flags_are_refused(self):
        from nm03_capstone_project_tpu_torch.serving import server

        assert set(server.NOT_PORTED) == {"--fallback-cpu", "--no-fallback-cpu"}

    def test_compile_cache_dir_is_accepted_and_wins_over_the_variable(
            self, monkeypatch, tmp_path):
        from nm03_capstone_project_tpu_torch.compilehub import ENV_CACHE_DIR
        from nm03_capstone_project_tpu_torch.serving import server

        seen = {}

        class FakeApp:
            def __init__(self, **kw):
                seen.update(kw)

        monkeypatch.setattr(server, "ServingApp", FakeApp)
        monkeypatch.delenv(ENV_CACHE_DIR, raising=False)
        server.app_from_args(server.build_parser().parse_args(["--device", "cpu"]))
        assert seen["compile_cache_dir"] is None
        monkeypatch.setenv(ENV_CACHE_DIR, str(tmp_path / "env"))
        server.app_from_args(server.build_parser().parse_args(["--device", "cpu"]))
        assert seen["compile_cache_dir"] == str(tmp_path / "env")
        args = server.build_parser().parse_args(
            ["--device", "cpu", "--compile-cache-dir", str(tmp_path / "flag")])
        server.app_from_args(args)
        assert seen["compile_cache_dir"] == str(tmp_path / "flag")

    def test_sanitize_flag_is_accepted(self):
        """``--sanitize`` (the runtime twins, utils/sanitize.py) is ported:
        parsed, not refused, and off by default."""
        from nm03_capstone_project_tpu_torch.serving import server

        assert "--sanitize" not in server.NOT_PORTED
        assert server.build_parser().parse_args(["--device", "cpu", "--sanitize"]).sanitize
        assert not server.build_parser().parse_args(["--device", "cpu"]).sanitize

    @pytest.mark.parametrize("flag,attr,value", [
        (["--volume-serving"], "volume_serving", True),
        (["--volume-depth-buckets", "4,8,12"], "volume_depth_buckets", (4, 8, 12)),
        (["--volume-queue-capacity", "3"], "volume_queue_capacity", 3),
        (["--volume-timeout-s", "12.5"], "volume_timeout_s", 12.5),
    ])
    def test_volume_flags_parse_and_reach_the_app(self, flag, attr, value, monkeypatch):
        from nm03_capstone_project_tpu_torch.serving import server

        seen = {}

        class FakeApp:
            def __init__(self, **kw):
                seen.update(kw)

        monkeypatch.setattr(server, "ServingApp", FakeApp)
        args = server.build_parser().parse_args(["--device", "cpu", "--volume-serving"] + flag)
        server.app_from_args(args)
        assert seen["volume_serving"] is True and seen[attr] == value
        # without the flag, no gang and the JAX package's defaults
        seen.clear()
        server.app_from_args(server.build_parser().parse_args(["--device", "cpu"]))
        assert (seen["volume_serving"], seen["volume_depth_buckets"],
                seen["volume_queue_capacity"], seen["volume_timeout_s"]) == (
            False, None, 4, 300.0)

    @pytest.mark.parametrize("flag,attr,value", [
        (["--slo-availability", "99.5"], "slo", {"availability_pct": 99.5}),
        (["--slo-p99-ms", "250"], "slo", {"availability_pct": 99.0,
                                          "latency_target_ms": 250.0}),
        (["--slo-p99-ms", "250", "--slo-fast-window-s", "60", "--slo-slow-window-s", "600"],
         "slo", {"window_fast_s": 60.0, "window_slow_s": 600.0}),
        (["--ledger-profile-interval-s", "2"], "ledger_profile_interval_s", 2.0),
        (["--ledger-profile-ms", "150"], "ledger_profile_ms", 150),
        (["--fault-plan", '{"seed": 2, "faults": [{"site": "dispatch", "kind": "transient"}]}'],
         "fault_plan", {"seed": 2}),
    ])
    def test_operations_flags_parse_and_reach_the_app(self, flag, attr, value, monkeypatch):
        from nm03_capstone_project_tpu_torch.serving import server

        seen = {}

        class FakeApp:
            def __init__(self, **kw):
                seen.update(kw)

        monkeypatch.setattr(server, "ServingApp", FakeApp)
        monkeypatch.delenv("NM03_FAULT_PLAN", raising=False)
        server.app_from_args(server.build_parser().parse_args(["--device", "cpu"] + flag))
        got = seen[attr]
        if attr == "slo":
            assert {k: got.describe()[k] for k in value} == value
        elif attr == "fault_plan":
            assert got.seed == value["seed"] and got.has_site("dispatch")
        else:
            assert got == value
        # without the flags: no objective, no plan, the sampler off
        seen.clear()
        server.app_from_args(server.build_parser().parse_args(["--device", "cpu"]))
        assert (seen["slo"], seen["fault_plan"], seen["ledger_profile_interval_s"],
                seen["ledger_profile_ms"]) == (None, None, 0.0, 200)

    def test_distributed_init_reaches_the_app_and_alone_serves_alone(self, monkeypatch,
                                                                      capsys):
        """``--distributed-init`` (refused until multi-process serving was
        ported) reaches the app and its gang; outside a job joining is a
        no-op that says so, and a job of several processes without
        --volume-serving is refused (its other ranks would have nothing
        to follow)."""
        from nm03_capstone_project_tpu_torch.parallel import distributed
        from nm03_capstone_project_tpu_torch.serving import server

        seen = {}

        class FakeApp:
            def __init__(self, **kw):
                seen.update(kw)

        monkeypatch.setattr(server, "ServingApp", FakeApp)
        args = server.build_parser().parse_args(["--device", "cpu", "--distributed-init"])
        server.app_from_args(args)
        assert seen["distributed_init"] is True
        server.app_from_args(server.build_parser().parse_args(["--device", "cpu"]))
        assert seen["distributed_init"] is False
        for var in ("MASTER_ADDR", "SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        assert server._join_job(args) is None and not distributed.is_initialized()
        assert "no job detected; serving alone" in capsys.readouterr().err
        monkeypatch.setattr(distributed, "initialize", lambda device=None: True)
        monkeypatch.setattr(distributed, "process_count", lambda: 2)
        monkeypatch.setattr(distributed, "shutdown", lambda: None)
        with pytest.raises(ValueError, match="needs --volume-serving"):
            server._join_job(args)

    @pytest.mark.parametrize("flag,rc,reason", [
        (["--slo-availability", "100"], 2, "availability_pct"),
        (["--slo-p99-ms", "-5"], 2, "latency_target_s"),
        # the id stays that of the case before cache/io_error was ported (the
        # compile cache's kind, then refused): a kind neither cache tier has
        pytest.param(["--fault-plan", '{"faults": [{"site": "cache", "kind": "evict"}]}'], 1,
                     "invalid for site 'cache'", id="flag2-1-compile cache"),
        (["--fault-plan", '{"faults": [{"site": "nowhere", "kind": "x"}]}'], 1,
         "unknown fault site"),
    ])
    def test_a_bad_objective_or_plan_is_refused_before_binding(self, flag, rc, reason,
                                                               tmp_path, capsys):
        from nm03_capstone_project_tpu_torch.serving import server

        port_file = tmp_path / "port"
        argv = ["--device", "cpu", "--port", "0", "--port-file", str(port_file),
                "--heartbeat-s", "0"] + flag
        if rc == 2:  # a usage error, as the JAX server makes it
            with pytest.raises(SystemExit) as exc:
                server.main(argv)
            assert exc.value.code == 2
        else:
            assert server.main(argv) == 1
        assert reason in capsys.readouterr().err
        assert not port_file.exists()

    def test_parser_matches_the_drivers_pipeline_flags(self):
        from nm03_capstone_project_tpu_torch.cli import common
        from nm03_capstone_project_tpu_torch.serving import server

        args = server.build_parser().parse_args(["--no-preprocess-fuse", "--canvas", "128"])
        cfg = common.pipeline_config_from_args(args)
        assert cfg == PipelineConfig(canvas=128, fuse_preprocess=False)
        assert args.device == "cuda" and args.buckets == "1,2,4,8,16"

    def test_graphs_refuse_cpu(self):
        from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph

        with pytest.raises(ValueError, match="CUDA"):
            BucketGraph(PipelineConfig(canvas=32), 1, "cpu", None, None)
        with pytest.raises(ValueError, match="CUDA"):
            BucketGraph(PipelineConfig(canvas=32), 1, torch.device("cpu"), None, None)

    def test_graphs_refuse_the_jump_schedule(self):
        # the jump schedule is ported, but its rounds sync the host: the
        # server says so before any capture instead of failing inside one
        from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph

        cfg = PipelineConfig(canvas=32, grow_algorithm="jump")
        with pytest.raises(ValueError, match="cannot capture"):
            BucketGraph(cfg, 1, "cuda", None, None)


class TestVolumeDriver:
    """``python -m nm03_capstone_project_tpu_torch.cli.volume``'s --z-shard."""

    @pytest.mark.parametrize("n", [2, 4])
    def test_z_shard_runs_on_several_devices(self, monkeypatch, capsys, tmp_path, n):
        """On n local devices (n CPU entries here, the counterpart of n
        cards) --z-shard runs the z-sharded path, and its files equal a
        one-device run's byte for byte."""
        from nm03_capstone_project_tpu_torch.cli import volume
        from nm03_capstone_project_tpu_torch.parallel import mesh

        argv = ["--synthetic", "2", "--synthetic-slices", "5", "--canvas", "64",
                "--min-dim", "32", "--device", "cpu", "--export-mhd", "--z-shard"]
        assert volume.main(argv + ["--output", str(tmp_path / "one")]) == 0
        assert "--z-shard ignored: single device" in capsys.readouterr().err
        monkeypatch.setattr(mesh, "local_devices", lambda device=None: [torch.device("cpu")] * n)
        results = tmp_path / "r.json"
        assert volume.main(argv + ["--output", str(tmp_path / "many"),
                                   "--results-json", str(results)]) == 0
        assert f"z-sharding volumes over {n} local devices" in capsys.readouterr().out
        rec = json.loads(results.read_text())
        assert rec["z_sharded"] is True and rec["z_shards"] == n

        def files(root):
            return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                    if p.is_file() and "synthetic" not in str(p)}

        one, many = files(tmp_path / "one"), files(tmp_path / "many")
        assert len(one) == 2 * (2 * 5 + 2) + 1 and one == many

    def test_z_shard_ignored_on_one_device(self, monkeypatch, capsys, tmp_path):
        from nm03_capstone_project_tpu_torch.cli import volume

        argv = ["--output", str(tmp_path / "out"), "--synthetic", "1",
                "--synthetic-slices", "2", "--canvas", "128", "--device", "cpu", "--z-shard"]
        assert volume.main(argv) == 0
        assert "--z-shard ignored: single device" in capsys.readouterr().err

    def test_parser_takes_the_drivers_flags(self):
        from nm03_capstone_project_tpu_torch.cli import common, volume

        args = volume.build_parser().parse_args(
            ["--no-kernels", "--no-preprocess-fuse", "--grow-algorithm", "jump",
             "--render-stage", "device", "--export-mhd", "--mhd-compressed"])
        cfg = common.pipeline_config_from_args(args)
        assert cfg == PipelineConfig(use_kernels=False, fuse_preprocess=False,
                                     grow_algorithm="jump")
        assert args.device == "cuda" and args.output == "out-volume"
        assert args.render_stage == "device" and args.export_mhd and args.mhd_compressed


class TestParallelDriverMesh:
    """``cli.parallel`` over a ``data`` mesh of the local devices."""

    @pytest.mark.parametrize("n,stage", [(2, "host"), (3, "device")])
    def test_batches_split_over_several_devices(self, monkeypatch, tmp_path, n, stage):
        """On n local devices (n CPU entries here) each batch runs through
        process_batch_sharded, padded to the mesh, and the files equal a
        one-device run's byte for byte."""
        from nm03_capstone_project_tpu_torch import parallel as par
        from nm03_capstone_project_tpu_torch.cli import parallel
        from nm03_capstone_project_tpu_torch.parallel import mesh

        argv = ["--synthetic", "2", "--synthetic-slices", "5", "--canvas", "64",
                "--min-dim", "32", "--device", "cpu", "--batch-size", "4",
                "--render-stage", stage]
        assert parallel.main(argv + ["--output", str(tmp_path / "one")]) == 0
        real, chunks = par.process_batch_sharded, []

        def counted(px, dm, cfg, m, **kw):
            chunks.append((len(px), m.shape["data"]))
            return real(px, dm, cfg, m, **kw)

        monkeypatch.setattr(par, "process_batch_sharded", counted)
        monkeypatch.setattr(mesh, "local_devices", lambda device=None: [torch.device("cpu")] * n)
        assert parallel.main(argv + ["--output", str(tmp_path / "many")]) == 0
        # batches of 4 (n=2) or 3 (n=3): 5 slices a patient, the short batch padded
        want = [(4, 2), (2, 2)] if n == 2 else [(3, 3), (3, 3)]
        assert chunks == want * 2

        def files(root):
            return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                    if p.is_file() and "synthetic" not in str(p) and p.suffix == ".jpg"}

        one, many = files(tmp_path / "one"), files(tmp_path / "many")
        assert len(one) == 2 * 2 * 5 and one == many

    def test_the_mesh_starts_at_the_runs_device(self, monkeypatch):
        from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor
        from nm03_capstone_project_tpu_torch.parallel import mesh

        cards = [torch.device("cuda", i) for i in range(3)]
        monkeypatch.setattr(mesh, "local_devices", lambda device=None: list(cards))
        proc = object.__new__(CohortProcessor)
        proc.process_count, proc.model = 1, None
        proc.device = torch.device("cuda", 1)
        assert proc._data_mesh().axis_devices("data") == [cards[1], cards[2], cards[0]]

    @pytest.mark.parametrize("n,stage", [(2, "host"), (3, "device")])
    def test_a_student_run_splits_over_the_mesh(self, monkeypatch, tmp_path, n, stage):
        """With --model on n local devices (it ran on one device before the
        student was ported over the mesh) every batch splits over the data
        mesh, one student copy a distinct device, and the files equal a
        one-device --model run's byte for byte."""
        from nm03_capstone_project_tpu_torch import models as pm
        from nm03_capstone_project_tpu_torch.cli import parallel, runner
        from nm03_capstone_project_tpu_torch.parallel import mesh

        ckpt = tmp_path / "ckpt"
        pm.save_params(ckpt, pm.init_unet(torch.Generator().manual_seed(5), base=8,
                                          device="cpu"), meta={"model_3d": False})
        argv = ["--synthetic", "2", "--synthetic-slices", "5", "--canvas", "64",
                "--min-dim", "32", "--device", "cpu", "--batch-size", "4",
                "--render-stage", stage, "--model", str(ckpt)]
        assert parallel.main(argv + ["--output", str(tmp_path / "one")]) == 0
        real, chunks = runner.CohortProcessor._student_sharded, []

        def counted(self, px, dm, m):
            chunks.append((len(px), m.shape["data"]))
            out = real(self, px, dm, m)
            # a repeated device shares the run's own copy of the student
            assert set(map(id, self._replicas.values())) == {id(self.model)}
            return out

        monkeypatch.setattr(runner.CohortProcessor, "_student_sharded", counted)
        monkeypatch.setattr(mesh, "local_devices", lambda device=None: [torch.device("cpu")] * n)
        assert parallel.main(argv + ["--output", str(tmp_path / "many")]) == 0
        want = [(4, 2), (2, 2)] if n == 2 else [(3, 3), (3, 3)]
        assert chunks == want * 2

        def files(root):
            return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                    if p.is_file() and "synthetic" not in str(p) and p.suffix == ".jpg"}

        one, many = files(tmp_path / "one"), files(tmp_path / "many")
        assert len(one) == 2 * 2 * 5 and one == many
