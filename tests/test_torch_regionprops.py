"""The port's ``ops/regionprops.py`` held against the JAX package's, on the CPU.

Masks are made from a seed with numpy and go through both packages:
``connected_components`` labels bitwise at 4 and 8 connectivity, converged
and truncated by ``max_iters`` (the cap is checked a block at a time in
both); ``bounding_box`` bitwise, empty masks included; ``region_properties``
with area, label and bbox bitwise (area ties broken in ``lax.top_k``'s
order) and the centroid within 1e-6 relative (the two packages sum the
coordinates in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu.ops import regionprops as jax_regionprops
from nm03_capstone_project_tpu_torch import ops
from nm03_capstone_project_tpu_torch.ops import regionprops


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mask(seed: int, shape=(2, 17, 23), p=0.55) -> np.ndarray:
    return np.random.default_rng(seed).random(shape) > p


def _serpentine(h: int = 15, w: int = 16) -> np.ndarray:
    """One long snake of a component: its labels need ~h*w/2 steps."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def test_exported_from_ops():
    assert ops.connected_components is regionprops.connected_components
    assert ops.region_properties is regionprops.region_properties
    assert ops.bounding_box is regionprops.bounding_box


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_converged_bitwise(connectivity, seed):
    m = _mask(seed)
    want = np.asarray(jax_regionprops.connected_components(jnp.asarray(m), connectivity))
    got = regionprops.connected_components(torch.from_numpy(m), connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("block_iters,max_iters", [(1, 1), (1, 5), (4, 8), (16, 16)])
def test_connected_components_truncated_bitwise(connectivity, block_iters, max_iters):
    m = _serpentine()
    want = np.asarray(jax_regionprops.connected_components(
        jnp.asarray(m), connectivity, block_iters=block_iters, max_iters=max_iters))
    got = regionprops.connected_components(
        torch.from_numpy(m), connectivity, block_iters=block_iters, max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    # truncated: the snake still carries more than one label
    assert len(np.unique(want[m])) > 1


def test_labels_are_the_smallest_linear_index():
    m = _serpentine()
    lab = regionprops.connected_components(torch.from_numpy(m), 4).numpy()
    assert set(np.unique(lab[m])) == {1}  # one component, its first pixel (0, 0)
    assert np.all(lab[~m] == 0)


def test_bounding_box_bitwise():
    m = _mask(3, (3, 12, 14), p=0.9)
    m[1] = False  # an empty mask: -1s
    want = np.asarray(jax_regionprops.bounding_box(jnp.asarray(m)))
    got = regionprops.bounding_box(torch.from_numpy(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].tolist() == [-1, -1, -1, -1]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("max_regions", [3, 8, 400])
def test_region_properties(connectivity, max_regions):
    m = _mask(4, (19, 21), p=0.6)
    want = jax_regionprops.region_properties(jnp.asarray(m), connectivity, max_regions)
    got = regionprops.region_properties(torch.from_numpy(m), connectivity, max_regions)
    for key in ("area", "label", "bbox"):
        assert got[key].dtype == torch.int32, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["centroid"].numpy(), np.asarray(want["centroid"]), rtol=1e-6)
    # past the few largest, many small components tie on area: they come
    # out lowest label first, as lax.top_k orders them
    if max_regions > 3:
        area = got["area"].numpy()
        assert len(set(area[area > 0])) < (area > 0).sum()


def test_region_properties_empty_and_batch_refused():
    got = regionprops.region_properties(torch.zeros((6, 7), dtype=torch.bool), 4, 3)
    assert got["area"].tolist() == [0, 0, 0] and got["label"].tolist() == [-1, -1, -1]
    assert got["bbox"].tolist() == [[-1] * 4] * 3
    with pytest.raises(ValueError, match="single"):
        regionprops.region_properties(torch.zeros((2, 6, 7), dtype=torch.bool))
