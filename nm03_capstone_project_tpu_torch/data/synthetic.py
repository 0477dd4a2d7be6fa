"""Synthetic brain-MRI phantoms and cohorts (numpy only).

A copy of the JAX package's ``data/synthetic.py`` phantoms, so the port and
``chip_smoke.py`` can build a cohort on their own. The phantoms have the
contrast structure the pipeline's hard-coded thresholds assume:

* raw intensities on the reference's [0, 10000] normalization window,
* brain tissue below the segmentation band, a central hyperintense lesion
  whose normalized intensity lands inside the region-growing band
  [0.74, 0.91] (raw ~1200-2050 after the [0.5, 2.5] window maps back),
* a bright skull rim above the band.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from nm03_capstone_project_tpu_torch.config import DEFAULT_BATCH_SIZE

# True (height, width) of each smoke-cohort patient, cycled: square,
# non-square and prime sizes on the 256 canvas.
SMOKE_DIMS: Tuple[Tuple[int, int], ...] = (
    (256, 256),
    (251, 241),
    (256, 199),
    (227, 256),
    (256, 256),
    (197, 233),
)


def phantom_slice(
    height: int = 256,
    width: int = 256,
    lesion_radius: float = 0.16,
    seed: int = 0,
    noise: float = 40.0,
) -> np.ndarray:
    """One synthetic T1+C-like slice, float32 (height, width), raw intensities.

    Layout (fractions of min(h, w)): elliptical head of tissue ~800 raw,
    skull rim ~6000 raw, central lesion ~1600 raw (inside the band after
    normalization), smooth low-amplitude noise everywhere.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    r = min(height, width)

    # normalized elliptical radius of the head
    head = ((yy - cy) / (0.46 * height)) ** 2 + ((xx - cx) / (0.40 * width)) ** 2

    img = np.zeros((height, width), np.float32)
    tissue = head < 1.0
    img[tissue] = 800.0
    rim = (head >= 1.0) & (head < 1.21)
    img[rim] = 6000.0

    # ventricles: two dark lobes slightly above center
    for sx in (-1.0, 1.0):
        vent = ((yy - (cy - 0.08 * r)) / (0.10 * r)) ** 2 + (
            (xx - (cx + sx * 0.09 * r)) / (0.05 * r)
        ) ** 2
        img[(vent < 1.0) & tissue] = 350.0

    # the lesion: centered so the reference's central seeds hit it
    lesion = ((yy - cy) / (lesion_radius * r)) ** 2 + (
        (xx - cx) / (lesion_radius * r)
    ) ** 2
    img[(lesion < 1.0) & tissue] = 1600.0

    # smooth noise that stays well inside each class's margin
    if noise > 0:
        low = rng.normal(0.0, 1.0, (height // 8 + 1, width // 8 + 1))
        coarse = np.kron(low, np.ones((8, 8)))[:height, :width]
        img = img + noise * coarse.astype(np.float32) * (img > 0)

    return np.clip(img, 0.0, 10000.0).astype(np.float32)


def phantom_series(
    n_slices: int = 22,
    height: int = 256,
    width: int = 256,
    seed: int = 0,
) -> list[np.ndarray]:
    """A patient series: the lesion waxes and wanes across slices."""
    out = []
    for i in range(n_slices):
        # lesion radius sweeps 0 -> max -> 0 across the stack
        t = i / max(n_slices - 1, 1)
        radius = 0.16 * float(np.sin(np.pi * t))
        out.append(
            phantom_slice(
                height,
                width,
                lesion_radius=max(radius, 1e-3),
                seed=seed * 1000 + i,
            )
        )
    return out


def smoke_cohort(
    n_patients: int = 20, n_slices: int = DEFAULT_BATCH_SIZE
) -> List[np.ndarray]:
    """The cohort ``chip_smoke.py`` drives: ``n_patients`` series in order.

    Patient p is ``phantom_series(n_slices, *SMOKE_DIMS[p % 6], seed=p)``.
    The default, 20 patients of 25 slices, is the size of the TCIA
    Brain-Tumor-Progression cohort the reference targets.
    """
    out: List[np.ndarray] = []
    for p in range(n_patients):
        h, w = SMOKE_DIMS[p % len(SMOKE_DIMS)]
        out.extend(phantom_series(n_slices, h, w, seed=p))
    return out


def write_synthetic_cohort(
    root,
    n_patients: int = 3,
    n_slices: int = 8,
    height: int = 256,
    width: int = 256,
    seed: int = 0,
) -> list[str]:
    """Materialize a phantom cohort with the reference's directory layout.

    Creates ``<root>/PGBM-000i/<series>/1-<j>.dcm`` mirroring the TCIA
    Brain-Tumor-Progression layout the discovery contract expects
    (main_sequential.cpp:93-168); returns the patient IDs. The files are
    byte-identical to the JAX package's ``write_synthetic_cohort`` (a test
    pins it), so ``--synthetic N`` builds the same cohort in both packages,
    and they round-trip through :mod:`.dicomlite`, so discovery, DICOM
    decode, padding and the pipeline run as they would on real data.
    """
    from pathlib import Path

    from nm03_capstone_project_tpu_torch.data.dicomlite import write_dicom

    root = Path(root)
    patient_ids = []
    for p in range(n_patients):
        pid = f"PGBM-{p + 1:04d}"
        patient_ids.append(pid)
        series_dir = root / pid / f"01-01-2000-MR-BRAIN-{p + 1:03d}"
        series_dir.mkdir(parents=True, exist_ok=True)
        series = phantom_series(n_slices, height, width, seed=seed * 100 + p)
        for j, img in enumerate(series):
            write_dicom(
                series_dir / f"1-{j + 1:02d}.dcm",
                np.clip(img, 0, 65535).astype(np.uint16),
                patient_id=pid,
                series_uid=f"1.2.826.0.1.3680043.9999.{p + 1}",
                instance_number=j + 1,
            )
    return patient_ids
