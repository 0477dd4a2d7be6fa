"""Seeded studies: brain-MRI phantoms made on the device from ``--seed``.

A configuration's ``cohort`` block fixes the set of studies: how many,
their planes, canvas and true in-plane sizes, and each study's lesion. The
seed fixes only the order in which the studies are served and the noise in
their pixels, so every seed gives the same set of sizes and the same
lesions (the same work) in another order, and one seed always gives the
same pixels on the same kind of device.

The phantoms have the contrast the pipeline's fixed thresholds assume, as
in the reference's test data: raw intensities on the [0, 10000]
normalization window; brain tissue (800) and ventricles (350) below the
region-growing band after normalization and clipping, a skull rim (6000,
where the cohort is not skull-stripped) above it, and an enhancing lesion
whose intensity falls from its core (1900, inside the band) to its rim
(1150, below it) with the square of the radius, so the band's lower edge
cuts through the lesion on a ramp, as enhancement fades in real scans.
Noise: smooth noise in 8 x 8 blocks and voxel noise. Outside a slice's
true size the canvas holds zeros.

Lesion profiles across the planes:

* ``sin``: a series whose lesion waxes and wanes from the first plane to
  the last (radius ``r * sin(pi * z / (planes - 1))``);
* ``ellipsoid``: a 3D lesion of half-height ``half_planes`` centred at
  ``centre`` (a fraction of the planes), its in-plane radius
  ``r * sqrt(1 - ((z - zc) / half_planes) ** 2)``; the brain is an
  ellipsoid across the planes too.
"""

from __future__ import annotations

import math
import random
from typing import List, NamedTuple

import torch


class Study(NamedTuple):
    """One study: ``pixels`` (planes, canvas, canvas) float32 and its true
    in-plane ``dims`` (height, width), and its index in the cohort."""

    index: int
    pixels: torch.Tensor
    dims: tuple


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def study_order(n_studies: int, seed: int) -> List[int]:
    """The cohort's studies in the order the seed serves them."""
    order = list(range(n_studies))
    random.Random(int(seed) * 2654435761 + 1).shuffle(order)
    return order


def make_study(cohort: dict, index: int, seed: int, device) -> Study:
    """Study ``index`` of ``cohort`` with the seed's noise, on ``device``."""
    planes, canvas = int(cohort["planes"]), int(cohort["canvas"])
    dims_list = cohort["dims"]
    h, w = (int(v) for v in dims_list[index % len(dims_list)])
    lesion = cohort["lesions"][index % len(cohort["lesions"])]
    level = cohort["intensity"]
    dev = torch.device(device)
    g = _generator(int(seed) * 1009 + index, dev)

    z = torch.arange(planes, device=dev, dtype=torch.float32).view(planes, 1, 1)
    yy = torch.arange(canvas, device=dev, dtype=torch.float32).view(1, canvas, 1)
    xx = torch.arange(canvas, device=dev, dtype=torch.float32).view(1, 1, canvas)
    cy, cx, r = (h - 1) / 2.0, (w - 1) / 2.0, float(min(h, w))

    if cohort["profile"] == "sin":
        brain = torch.ones_like(z)
        t = z / max(planes - 1, 1)
        radius = (lesion["r"] * torch.sin(math.pi * t)).clamp(min=1e-3)
    else:
        zb = (planes - 1) / 2.0
        brain = (1.0 - ((z - zb) / (cohort["brain_half_planes"])) ** 2).clamp(min=0.0).sqrt()
        zc = lesion["centre"] * (planes - 1)
        radius = lesion["r"] * (1.0 - ((z - zc) / lesion["half_planes"]) ** 2).clamp(min=0.0).sqrt()
        radius = radius.clamp(min=1e-3)
    brain = brain.clamp(min=1e-6)

    head = ((yy - cy) / (0.46 * h * brain)) ** 2 + ((xx - cx) / (0.40 * w * brain)) ** 2
    tissue = head < 1.0
    img = torch.where(tissue, level["tissue"], 0.0)
    if cohort["skull"]:
        img = torch.where((head >= 1.0) & (head < 1.21), level["skull"], img)
    for sx in (-1.0, 1.0):
        vent = ((yy - (cy - 0.08 * r * brain)) / (0.10 * r * brain)) ** 2 + (
            (xx - (cx + sx * 0.09 * r * brain)) / (0.05 * r * brain)) ** 2
        img = torch.where((vent < 1.0) & tissue, level["ventricle"], img)
    rho2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (radius * r) ** 2
    lesion = level["lesion_core"] + (level["lesion_rim"] - level["lesion_core"]) * rho2
    img = torch.where((rho2 < 1.0) & tissue, lesion, img)

    blocks = canvas // 8 + 1
    coarse = torch.randn((planes, blocks, blocks), generator=g, device=dev)
    coarse = coarse.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)[:, :canvas, :canvas]
    fine = torch.randn((planes, canvas, canvas), generator=g, device=dev)
    img = img + (cohort["noise"] * coarse + cohort["voxel_noise"] * fine) * (img > 0)
    img = torch.where((yy < h) & (xx < w), img, 0.0)
    return Study(index, img.clamp(0.0, 10000.0).to(torch.float32).contiguous(), (h, w))


def make_cohort(cohort: dict, seed: int, device) -> List[Study]:
    """Every study of the cohort, indexed as the configuration lists them."""
    return [make_study(cohort, i, seed, device) for i in range(int(cohort["studies"]))]
