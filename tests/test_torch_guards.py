"""Guards on the PyTorch port: it stands apart from the JAX package, it does
not drift onto the CPU, and its kernels count only real launches.
"""

import ctypes
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


class TestDrivers:
    DRIVERS = ("sequential", "parallel", "test_pipeline")

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

    @pytest.mark.parametrize("name", DRIVERS)
    @pytest.mark.parametrize("flag", [["--use-pallas"], ["--model", "m.ckpt"],
                                      ["--distributed"], ["--device", "auto"],
                                      ["--fault-plan", "{}"], ["--metrics-out", "m.json"],
                                      ["--profile-dir", "p"]])
    def test_flags_of_layers_not_ported_are_rejected(self, name, flag, capsys):
        import importlib

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        with pytest.raises(SystemExit) as exc:
            driver.build_parser().parse_args(flag)
        assert exc.value.code == 2
        capsys.readouterr()

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
        with pytest.raises(ValueError, match="odd"):
            hm.vector_median_filter_kernel(torch.rand(8, 8), 17)
        with pytest.raises(ValueError, match="odd"):
            hm.fused_preprocess_kernel(torch.rand(8, 8), median_window=17)
        with pytest.raises(ValueError, match="sharpen kernel"):
            hm.fused_preprocess_kernel(torch.rand(8, 8), sharpen_kernel=33)


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

    @pytest.mark.parametrize("flag", [
        ["--volume-serving"], ["--volume-depth-buckets", "8,16"], ["--distributed-init"],
        ["--compile-cache-dir", "c"], ["--fault-plan", "{}"], ["--slo-availability", "99"],
        ["--slo-p99-ms", "100"], ["--ledger-profile-interval-s", "1"],
        ["--ledger-profile-ms", "100"], ["--no-fallback-cpu"], ["--sanitize"],
        ["--device", "auto"],
    ])
    def test_flags_of_layers_not_ported_are_rejected(self, flag, capsys):
        from nm03_capstone_project_tpu_torch.serving import server

        with pytest.raises(SystemExit) as exc:
            server.build_parser().parse_args(["--device", "cpu"] + flag)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        if flag[0] in server.NOT_PORTED:
            assert server.NOT_PORTED[flag[0]] in err

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
