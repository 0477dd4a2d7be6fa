"""``--sanitize`` in the port (``nm03_capstone_project_tpu_torch/utils/sanitize.py``).

* a NaN planted in a stage's input raises, naming the stage;
* a host array handed to a guarded dispatch for the card raises, naming
  the site, on the dispatching thread and on a supervisor's worker;
* the recompile watchdog counts captures and library loads after warm-up
  only, into ``pipeline_recompiles_total``;
* the drivers and the server accept the flag, and their outputs are
  byte-identical with and without it.
"""

from __future__ import annotations

import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core import pad_to_canvas
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
from nm03_capstone_project_tpu_torch.obs.metrics import MetricsRegistry
from nm03_capstone_project_tpu_torch.pipeline import process_batch, slice_pipeline
from nm03_capstone_project_tpu_torch.utils import sanitize

CANVAS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def session():
    st = sanitize.enable()
    try:
        yield st
    finally:
        sanitize.disable()


def _batch(n=3):
    slices = [phantom_slice(CANVAS, CANVAS - 4 * i, seed=i) for i in range(n)]
    return pad_to_canvas(slices, (CANVAS, CANVAS), device="cpu")


def _cfg(**kw):
    return PipelineConfig(canvas=CANVAS, min_dim=16, **kw)


class TestNonFiniteStages:
    def test_a_nan_in_the_pixels_names_the_first_stage(self, session):
        b = _batch()
        px = b.pixels.clone()
        px[1, 5, 7] = float("nan")
        with pytest.raises(sanitize.NonFiniteStage) as e:
            process_batch(px, b.dims, _cfg(), device="cpu")
        assert e.value.stage == "extend_edges" and "[1, 5, 7]" in str(e.value)

    @pytest.mark.parametrize("fused,patched,stage", [
        (True, "_fused", "fused_preprocess"),
        (False, "clip_intensity", "clip_intensity"),
        (False, "median_filter", "median_filter"),
        (False, "sharpen", "sharpen"),
    ])
    def test_a_nan_planted_in_a_stage_names_it(self, session, monkeypatch, fused, patched,
                                               stage):
        real = getattr(slice_pipeline, patched)

        def planted(*a, **kw):
            out = real(*a, **kw).clone()
            out[0, 3, 3] = float("inf")
            return out

        monkeypatch.setattr(slice_pipeline, patched, planted)
        b = _batch()
        with pytest.raises(sanitize.NonFiniteStage) as e:
            process_batch(b.pixels, b.dims, _cfg(fuse_preprocess=fused), device="cpu")
        assert e.value.stage == stage

    def test_off_the_checks_cost_nothing_and_raise_nothing(self):
        assert not sanitize.active()
        b = _batch()
        px = b.pixels.clone()
        px[1, 5, 7] = float("nan")
        process_batch(px, b.dims, _cfg(), device="cpu")  # no check: no raise

    def test_clean_masks_are_the_unsanitized_ones(self, session):
        b = _batch()
        on = process_batch(b.pixels, b.dims, _cfg(), device="cpu")
        sanitize.disable()
        off = process_batch(b.pixels, b.dims, _cfg(), device="cpu")
        assert torch.equal(on["mask"], off["mask"])
        assert torch.equal(on["grow_converged"], off["grow_converged"])


class TestUploadGuard:
    def _proc(self, tmp_path, timeout_s):
        from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor
        from nm03_capstone_project_tpu_torch.resilience import ResilienceConfig

        proc = CohortProcessor(tmp_path, tmp_path / "out", cfg=_cfg(), mode="sequential",
                               device="cpu",
                               resilience=ResilienceConfig(dispatch_timeout_s=timeout_s))
        proc.device = torch.device("cuda")  # a dispatch meant for the card
        return proc

    @pytest.mark.parametrize("timeout_s", [0.0, 30.0], ids=["inline", "supervised"])
    def test_a_host_array_in_a_guarded_dispatch_names_the_site(self, session, monkeypatch,
                                                               tmp_path, timeout_s):
        # the pipeline's entry resolves the card; the guard raises before any copy
        monkeypatch.setattr(slice_pipeline, "resolve_device",
                            lambda d=None: torch.device("cuda"))
        b = _batch(1)
        px, dm = b.pixels[0], b.dims[0]
        for pixels in (px, px.numpy()):
            rec = {"stem": "s0", "index": 0, "pixels": pixels, "dims": dm,
                   "pixels_host": px.numpy(), "dims_host": dm.numpy()}
            out = self._proc(tmp_path, timeout_s)._dispatch_slice(rec, True, "P1")
            err = out.get("error")
            assert isinstance(err, sanitize.ImplicitUpload), repr(err)
            assert err.site == "cli/runner.py::_dispatch_slice"
            kind = "CPU tensor" if isinstance(pixels, torch.Tensor) else "host ndarray"
            assert kind in str(err)

    def test_outside_a_guard_or_off_nothing_raises(self, monkeypatch):
        sanitize.check_upload(np.zeros(3), torch.device("cuda"))  # off
        st = sanitize.enable()
        try:
            sanitize.check_upload(np.zeros(3), torch.device("cuda"))  # no guard
            with sanitize.guard_dispatch("x"):
                sanitize.check_upload(np.zeros(3), torch.device("cpu"))  # not the card
                with pytest.raises(sanitize.ImplicitUpload):
                    sanitize.check_upload(np.zeros(3), torch.device("cuda"))
            assert sanitize.current_site() is None
        finally:
            sanitize.disable()
        assert st.recompiles == 0

    def test_the_guard_is_per_thread(self, session):
        seen = {}
        with sanitize.guard_dispatch("here"):
            t = threading.Thread(target=lambda: seen.update(site=sanitize.current_site()))
            t.start()
            t.join()
            assert sanitize.current_site() == "here"
        assert seen == {"site": None}

    def test_the_supervisor_rearms_the_guard_on_its_worker(self, session):
        from nm03_capstone_project_tpu_torch.resilience import (
            DispatchSupervisor,
            ResilienceConfig,
        )

        sup = DispatchSupervisor(ResilienceConfig(dispatch_timeout_s=30.0))
        with sanitize.guard_dispatch("site-a"):
            got = sup.run(lambda: (threading.current_thread().name, sanitize.current_site()))
        assert got == ("nm03-dispatch", "site-a")
        assert sup.run(sanitize.current_site) is None  # unguarded caller


class TestRecompileWatchdog:
    def test_counts_after_warm_up_only(self):
        reg = MetricsRegistry()
        st = sanitize.enable(reg)
        try:
            counter = reg.get("pipeline_recompiles_total")
            assert counter.value == 0
            sanitize.note_compile("library", "libfused.so")
            assert (st.warmup_compiles, st.recompiles, counter.value) == (1, 0, 0)
            sanitize.mark_warm()
            sanitize.note_compile("graph", "bucket 4")
            assert (st.warmup_compiles, st.recompiles, counter.value) == (1, 1, 1)
            assert st.events == [("graph", "bucket 4")]
        finally:
            sanitize.disable()
        sanitize.note_compile("graph", "after")  # off: a no-op
        assert st.recompiles == 1

    def test_a_library_load_reaches_the_watchdog(self, monkeypatch, tmp_path):
        from nm03_capstone_project_tpu_torch.kernels import build

        monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
        monkeypatch.setattr(build, "_RECORDS", {})  # this load's record stays here
        (tmp_path / "libfused.so").write_bytes(b"")
        monkeypatch.setattr(build.ctypes, "CDLL", lambda path: type("L", (), {
            "nm03_fused_preprocess": type("F", (), {})(),
            "nm03_sharpen": type("F", (), {})()})())
        st = sanitize.enable()
        try:
            sanitize.mark_warm()
            build.load.cache_clear()
            build.load("fused")
            assert st.events == [("library", "libfused.so")]
        finally:
            sanitize.disable()
            build.load.cache_clear()


def _files(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.suffix in (".jpg", ".json")
            and p.name != "results.json"}


class TestDrivers:
    @pytest.mark.parametrize("name", ["parallel", "sequential", "volume"])
    def test_outputs_are_byte_identical_with_and_without_the_flag(self, name, tmp_path):
        import importlib

        driver = importlib.import_module(f"nm03_capstone_project_tpu_torch.cli.{name}")
        runs = {}
        for flag in ([], ["--sanitize"]):
            out = tmp_path / ("on" if flag else "off")
            metrics = tmp_path / f"m{len(flag)}.json"
            argv = ["--device", "cpu", "--synthetic", "2", "--synthetic-slices", "3",
                    "--canvas", str(CANVAS), "--min-dim", "16", "--output", str(out),
                    "--metrics-out", str(metrics)] + flag
            assert driver.main(argv) == 0
            assert not sanitize.active()  # the run's session ended with it
            runs[bool(flag)] = _files(out)
            snap = {m["name"]: m.get("value") for m in json.loads(metrics.read_text())["metrics"]}
            assert snap.get("pipeline_recompiles_total") == (0 if flag else None)
        assert runs[True] == runs[False] and any(k.endswith(".jpg") for k in runs[True])


class TestServer:
    def test_the_flag_is_parsed_and_reaches_main(self, monkeypatch):
        from nm03_capstone_project_tpu_torch.serving import server

        assert server.build_parser().parse_args(["--sanitize"]).sanitize is True
        assert "--sanitize" not in server.NOT_PORTED
        seen = {}

        def fake_serve(args, argv):
            seen["sanitize"] = args.sanitize
            return 0

        monkeypatch.setattr(server, "_serve", fake_serve)
        assert server.main(["--device", "cpu", "--sanitize"]) == 0
        assert seen == {"sanitize": True}

    def test_served_masks_are_equal_and_a_nan_body_is_refused_by_stage(self):
        from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

        import urllib.error
        import urllib.request

        a = phantom_slice(CANVAS, CANVAS - 8, seed=3).astype("<f4")
        bad = a.copy()
        bad[4, 4] = np.nan

        def post(port, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/segment", data=body.tobytes(),
                headers={"Content-Type": "application/octet-stream",
                         "X-Nm03-Height": str(a.shape[0]), "X-Nm03-Width": str(a.shape[1])},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read() or b"null")

        served = {}
        for on in (False, True):
            if on:
                sanitize.enable()
            try:
                app = ServingApp(cfg=_cfg(), buckets=(1,), device="cpu")
                httpd, _, port = serve_in_thread(app)
                sanitize.mark_warm()
                try:
                    served[on] = post(port, a)
                    if on:
                        served["nan"] = post(port, bad)
                finally:
                    httpd.shutdown()
                    httpd.server_close()
                    app.begin_drain(reason="test")
                    app.close()
            finally:
                sanitize.disable()
        assert served[True][0] == served[False][0] == 200
        fields = ("shape", "grow_converged", "mask_pixels", "original_jpeg_b64",
                  "processed_jpeg_b64")
        assert [served[True][1][k] for k in fields] == [served[False][1][k] for k in fields]
        status, payload = served["nan"]
        assert status >= 500 and "extend_edges" in json.dumps(payload)
