"""The port's 2D pipeline held against the JAX package's, on the CPU.

The same phantom batches (numpy, from a seed) go through both packages'
``process_batch`` and ``process_slice_stages``: masks and ``grow_converged``
must be bit-identical. The preprocessed image is held bit for bit against
the JAX composition evaluated op by op (every op rounded, as the port's
plain ops and CUDA kernels round), and within ``JIT_ULP`` of the jitted
composition the JAX pipeline runs: XLA:CPU contracts ``a*b+c`` into fused
multiply-adds, and the unsharp update (c + 2(c - blur)) amplifies the
blur's last-bit differences (12 ulp on the phantoms of
``tests/test_torch_kernels.py``, which prints them when run as a script).

Also pins ``nm03_capstone_project_tpu_torch/testdata/smoke_masks.json``,
the golden ``chip_smoke.py`` holds the card's masks against: recomputed
here from the JAX package. Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py --write
"""

import dataclasses
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.core import pad_to_canvas as jax_pad  # noqa: E402
from nm03_capstone_project_tpu.pipeline import (  # noqa: E402
    preprocess as jax_preprocess,
    process_batch as jax_process_batch,
    process_slice_stages as jax_stages,
)
from nm03_capstone_project_tpu_torch.convert import config_from_jax  # noqa: E402
from nm03_capstone_project_tpu_torch.core import pad_to_canvas  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import (  # noqa: E402
    phantom_slice,
    smoke_cohort,
)
from nm03_capstone_project_tpu_torch.pipeline import (  # noqa: E402
    preprocess,
    process_batch,
    process_slice,
    process_slice_stages,
)

JIT_ULP = 16
GOLDEN = (
    pathlib.Path(__file__).resolve().parents[1]
    / "nm03_capstone_project_tpu_torch" / "testdata" / "smoke_masks.json"
)
GOLDEN_SLICES = 50  # the first two smoke-cohort patients
GOLDEN_CANVAS = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _mixed_batch(canvas=64):
    slices = [
        phantom_slice(64, 64, seed=1, lesion_radius=0.14),
        phantom_slice(61, 53, seed=2),
        phantom_slice(47, 64, seed=3, lesion_radius=0.12),
        phantom_slice(59, 43, seed=4, lesion_radius=0.11),
    ]
    return jax_pad(slices, (canvas, canvas))


def _both(jcfg):
    return jcfg, config_from_jax(dataclasses.asdict(jcfg))


class TestProcessBatch:
    @pytest.mark.parametrize("fuse", [True, False])
    def test_masks_bitwise_mixed_dims(self, fuse):
        b = _mixed_batch()
        jcfg, cfg = _both(JaxConfig(canvas=64, fuse_preprocess=fuse))
        want = jax.jit(lambda p, d: jax_process_batch(p, d, jcfg))(b.pixels, b.dims)
        got = process_batch(b.pixels, b.dims, cfg, device="cpu")
        assert got["mask"].dtype == torch.uint8
        assert got["grow_converged"].dtype == torch.bool
        assert got["grow_converged"].shape == (4,)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        np.testing.assert_array_equal(
            got["grow_converged"].numpy(), np.asarray(want["grow_converged"])
        )
        assert np.asarray(want["mask"]).sum() > 0

    def test_truncating_cap_flags_per_slice(self):
        # a cap of one block stops the larger lesions mid-growth: both
        # packages must agree on which slices report converged=False
        b = _mixed_batch()
        jcfg, cfg = _both(JaxConfig(canvas=64, grow_block_iters=2, grow_max_iters=2))
        want = jax.jit(lambda p, d: jax_process_batch(p, d, jcfg))(b.pixels, b.dims)
        got = process_batch(b.pixels, b.dims, cfg, device="cpu")
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        conv = got["grow_converged"].numpy()
        np.testing.assert_array_equal(conv, np.asarray(want["grow_converged"]))
        assert not conv.all()

    def test_process_slice_matches_batch_row(self):
        b = _mixed_batch()
        _, cfg = _both(JaxConfig(canvas=64))
        batch = process_batch(b.pixels, b.dims, cfg, device="cpu")
        one = process_slice(b.pixels[1], b.dims[1], cfg, device="cpu")
        assert one["grow_converged"].shape == ()
        np.testing.assert_array_equal(one["mask"].numpy(), batch["mask"][1].numpy())

    def test_rejects_wrong_rank(self):
        b = _mixed_batch()
        with pytest.raises(ValueError, match="process_batch"):
            process_batch(b.pixels[0], b.dims[0], device="cpu")


class TestPreprocessArithmetic:
    def test_bitwise_vs_reference_op_by_op(self):
        # JAX evaluated eagerly rounds every op, as the port does
        b = _mixed_batch()
        jcfg, cfg = _both(JaxConfig(canvas=64))
        want = np.asarray(jax_preprocess(b.pixels, b.dims, jcfg))
        got = preprocess(b.pixels, b.dims, cfg, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)

    def test_within_jit_bound(self):
        b = _mixed_batch()
        jcfg, cfg = _both(JaxConfig(canvas=64))
        want = np.asarray(jax.jit(lambda p, d: jax_preprocess(p, d, jcfg))(b.pixels, b.dims))
        got = preprocess(b.pixels, b.dims, cfg, device="cpu").numpy()
        assert _ulp(got, want) <= JIT_ULP


class TestStages:
    def test_all_stages_match(self):
        b = _mixed_batch()
        jcfg, cfg = _both(JaxConfig(canvas=64))
        want = jax.jit(jax.vmap(lambda p, d: jax_stages(p, d, jcfg)))(b.pixels, b.dims)
        got = process_slice_stages(b.pixels, b.dims, cfg, device="cpu")
        assert set(got) == set(want)
        for key, w in want.items():
            w, g = np.asarray(w), got[key].numpy()
            assert g.dtype == w.dtype, key
            if key == "preprocessed_image":
                assert _ulp(g, w) <= JIT_ULP
            else:
                np.testing.assert_array_equal(g, w, err_msg=key)

    @pytest.mark.parametrize(
        "seed,radius", [(17, 0.10), (3, 0.13), (11, 0.16)]
    )
    def test_golden_phantoms_at_canvas_256(self, seed, radius):
        # the three phantoms tests/golden/make_goldens.py pins, one slice each
        px = phantom_slice(256, 256, seed=seed, lesion_radius=radius)
        dims = np.asarray([256, 256], np.int32)
        jcfg, cfg = _both(JaxConfig(canvas=256))
        want = jax.jit(lambda p, d: jax_stages(p, d, jcfg))(px, dims)
        got = process_slice_stages(px, dims, cfg, device="cpu")
        for key in ("segmentation", "erosion_result", "final_dilated_result",
                    "grow_converged"):
            np.testing.assert_array_equal(
                got[key].numpy(), np.asarray(want[key]), err_msg=key
            )
        assert int(got["segmentation"].sum()) > 0
        assert _ulp(got["preprocessed_image"].numpy(),
                    np.asarray(want["preprocessed_image"])) <= JIT_ULP


def golden_records(masks: np.ndarray, dims: np.ndarray, conv: np.ndarray):
    """One record per slice: true dims, sha256 of the uint8 canvas mask
    bytes (C order), mask area and converged."""
    return [
        {
            "index": i,
            "dims": [int(dims[i, 0]), int(dims[i, 1])],
            "sha256": hashlib.sha256(np.ascontiguousarray(masks[i]).tobytes()).hexdigest(),
            "area": int(masks[i].sum()),
            "converged": bool(conv[i]),
        }
        for i in range(masks.shape[0])
    ]


def jax_golden() -> dict:
    """The golden recomputed with the JAX package, in batches of 25."""
    cohort = smoke_cohort(n_patients=2)[:GOLDEN_SLICES]
    b = jax_pad(cohort, (GOLDEN_CANVAS, GOLDEN_CANVAS))
    jcfg = JaxConfig(canvas=GOLDEN_CANVAS)
    run = jax.jit(lambda p, d: jax_process_batch(p, d, jcfg))
    masks, conv = [], []
    for i in range(0, GOLDEN_SLICES, 25):
        out = run(b.pixels[i : i + 25], b.dims[i : i + 25])
        masks.append(np.asarray(out["mask"]))
        conv.append(np.asarray(out["grow_converged"]))
    return {
        "what": "process_batch masks of smoke_cohort(n_patients=2), the first "
                "50 slices of the chip_smoke cohort, made by the JAX package on the CPU",
        "canvas": GOLDEN_CANVAS,
        "slices": golden_records(np.concatenate(masks), b.dims, np.concatenate(conv)),
    }


class TestSmokeGolden:
    def test_golden_is_current(self):
        assert json.loads(GOLDEN.read_text()) == jax_golden()

    def test_port_matches_golden(self):
        golden = json.loads(GOLDEN.read_text())
        cohort = smoke_cohort(n_patients=2)[:GOLDEN_SLICES]
        b = pad_to_canvas(cohort, (GOLDEN_CANVAS, GOLDEN_CANVAS), device="cpu")
        _, cfg = _both(JaxConfig(canvas=GOLDEN_CANVAS))
        out = process_batch(b.pixels, b.dims, cfg, device="cpu")
        got = golden_records(
            out["mask"].numpy(), b.dims.numpy(), out["grow_converged"].numpy()
        )
        assert got == golden["slices"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_pipeline.py --write")
    GOLDEN.write_text(json.dumps(jax_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
