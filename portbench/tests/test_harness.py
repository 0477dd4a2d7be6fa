"""The harness on the CPU at a tiny size: found by name, run, checked.

The throwaway configuration, traffic mix, cell and metric of ``tiny_root``
are added as files and entries only; the harness lists and runs them. The
timed path is then broken underneath (the program's own functions
replaced) and the run must come out not correct.
"""

from __future__ import annotations

import json
import re

import pytest
import torch

from nm03_capstone_project_tpu_torch.pipeline import slice_pipeline
from portbench import catalog, harness, trace
from portbench.run import run_cell
from portbench.tests.tiny import tiny_root  # noqa: F401 (a fixture)

REAL_CELLS = ["tcia256.study_slices", "brats240.study_volume", "brats240.study_slices"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_the_benchmark_file_keeps_to_its_contract():
    bench = catalog.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    assert catalog.workloads() == REAL_CELLS
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
        assert (catalog.ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        layers.add(m["layer"])
    assert layers == {"kernels", "ops around the kernels", "pipeline entry", "device"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((catalog.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])


@pytest.mark.parametrize("name", REAL_CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(name):
    cell = catalog.cell(name)
    e2e = [m["name"] for m in cell["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(catalog.reader(catalog.ROOT, m["name"]))
    assert hasattr(cell["entry"], "program") and hasattr(cell["entry"], "reference")


def test_a_cell_added_as_files_is_listed_and_runs(tiny_root):
    assert "tiny.cell" in catalog.workloads(tiny_root)
    result, lines = run_cell("tiny.cell", 2**31 + 5, 0.5, False, device="cpu", root=tiny_root)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"slices_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert lines[0] == "check mask_voxels_differ 0 limit 0"
    traced, _ = run_cell("tiny.cell", 6, 0.5, True, device="cpu", root=tiny_root)
    assert traced["correct"]
    assert traced["metrics"]["tiny_studies"]["value"] > 0
    assert "dispatch_ms_per_study" in traced["metrics"]
    assert "fused_roofline" not in traced["metrics"]  # no device records on the CPU


def test_the_control_is_not_correct(tiny_root):
    result, lines = run_cell("tiny.cell", 8, 0.5, False, device="cpu", root=tiny_root,
                             engine="control")
    assert not result["correct"]
    assert result["checks"]["mask_voxels_differ"]["value"] > 0


def _state_unchanged(image, seeds, low, high, **kw):
    return seeds.to(torch.uint8), torch.ones(image.shape[:-2], dtype=torch.bool)


def _half_the_batch(process):
    def run(px, dm, cfg):
        half = px.shape[0] // 2
        out = process(px[:half], dm[:half], cfg)
        mask = torch.zeros(px.shape, dtype=torch.uint8)
        mask[:half] = out["mask"]
        conv = torch.ones(px.shape[0], dtype=torch.bool)
        conv[:half] = out["grow_converged"]
        return {"original": px, "mask": mask, "grow_converged": conv}
    return run


def _one_voxel_altered(process):
    def run(px, dm, cfg):
        out = process(px, dm, cfg)
        out["mask"] = out["mask"].clone()
        out["mask"][0, 0, 0] ^= 1
        return out
    return run


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    """Each fault the cells can have (one card: no exchange between chips)."""
    if fault == "state_unchanged":
        monkeypatch.setattr(slice_pipeline, "grow_dispatch", _state_unchanged)
    elif fault == "half_the_batch":
        monkeypatch.setattr(slice_pipeline, "_process", _half_the_batch(slice_pipeline._process))
    else:
        monkeypatch.setattr(slice_pipeline, "_process",
                            _one_voxel_altered(slice_pipeline._process))
    result, _ = run_cell("tiny.cell", 12, 0.5, False, device="cpu", root=tiny_root)
    assert not result["correct"]
    assert result["checks"]["mask_voxels_differ"]["value"] > 0


def test_the_sample_is_drawn_from_the_seed(tiny_root):
    cell = catalog.cell("tiny.cell", tiny_root)
    picks = []
    for seed in (3, 3, 4):
        h = harness.Harness(cell, seed, "cpu")
        picks.append([h._out_slot(True) for _ in range(200)])
    assert picks[0] == picks[1] and picks[0] != picks[2]
    assert picks[0][:4] == [0, 1, 2, 3]
    # the answers left in the slots are uniform over the 200: mean index ~100
    kept = []
    for seed in range(40):
        h = harness.Harness(cell, seed, "cpu")
        slots = [h._out_slot(True) for _ in range(200)]
        kept += [max(i for i, s in enumerate(slots) if s == k) for k in range(4)]
    assert 80 < sum(kept) / len(kept) < 120


class _Ev:
    def __init__(self, name, start, end, cuda=True):
        self._n, self._s, self._e, self._cuda = name, start, end, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_the_trace_summary_reads_busy_time_gaps_and_kernels():
    events = [
        _Ev("Memcpy HtoD (Pinned -> Device)", 100, 200),
        _Ev("Memcpy HtoD (Pinned -> Device)", 150, 160),
        _Ev("void (anonymous namespace)::fused_kernel<7, 16>(float const*, float*)", 300, 400),
        _Ev("void at::native::vectorized_elementwise_kernel<4, X>(int, X)", 350, 500),
        _Ev("portbench.pass", 0, 1000),  # a range's shadow on the device: not work
        _Ev("aten::add", 300, 310, cuda=False),
        _Ev("void grow_kernel(float const*)", 900, 1200),  # cut at the pass's end
    ]
    spans = [(0, 1000, "portbench.pass"), (0, 100, "portbench.stage"),
             (200, 300, "portbench.dispatch"), (500, 900, "portbench.wait")]
    s = trace.summarize(_Prof(events), 1, frozenset({"fused_kernel", "grow_kernel"}), spans)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((100 + 200 + 100) * 1e-9)
    assert s.kernel_s == pytest.approx({"fused_kernel": 100e-9,
                                        "at::native::vectorized_elementwise_kernel": 150e-9,
                                        "grow_kernel": 100e-9})
    assert s.copy_s == pytest.approx(110e-9)
    assert s.idle_by_host == pytest.approx({"stage": 100e-9, "dispatch": 100e-9, "wait": 400e-9})
    assert s.complete and s.staged_copies == 2
    assert s.breakdown()["device_ops"][0][0] == "at::native::vectorized_elementwise_kernel"
    assert trace.summarize(_Prof(events), 2, frozenset(), spans).complete is False
    assert trace.summarize(_Prof(events), 1, frozenset(), spans[1:]) is None


def test_the_program_s_kernels_are_its_global_functions():
    import nm03_capstone_project_tpu_torch as port
    from pathlib import Path

    names = trace.handwritten_kernels(Path(port.__file__).parent)
    assert {"fused_kernel", "grow_kernel", "band_kernel", "windowed_sharpen_kernel"} <= names
    assert trace.base_name("void (anonymous namespace)::grow_kernel<4>(float const*)") == \
        "grow_kernel"
