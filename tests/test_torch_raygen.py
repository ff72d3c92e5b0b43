"""Port ray generation against the JAX reference (CPU).

Tolerances: pixel tables, origins, tmin/tmax and slot ids exactly equal;
directions within atol 1e-6 (a unit vector; the two frameworks may take the
norm's square root of a sum reduced in another order, which moves the last
ulp); safe_inv_dir bit-equal to the numpy formulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.ops.aabb import safe_inv_dir as np_safe_inv_dir
from ntrace_tpu.ray import pixel_table as jax_pixel_table
from ntrace_tpu.ray import raygen as jax_raygen
from ntrace_tpu.scenes import default_camera
from ntrace_tpu_torch.ops.aabb import safe_inv_dir
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import unsort

SIZES = [(64, 48), (33, 17), (1, 1), (320, 240)]


@pytest.mark.parametrize("width,height", SIZES)
def test_pixel_table_matches_reference(width, height):
    order, inv = pixel_table(width, height)
    ref_order, ref_inv = jax_pixel_table(width, height)
    np.testing.assert_array_equal(order, ref_order)
    np.testing.assert_array_equal(inv, ref_inv)
    assert order.dtype == np.int32 and not order.flags.writeable


@pytest.mark.parametrize("scene", ["conference", "sibenik", "fairy"])
@pytest.mark.parametrize("width,height", [(64, 48), (33, 17)])
def test_primary_matches_reference(scene, width, height):
    cam = default_camera(scene)
    order, _ = pixel_table(width, height)
    ca = raygen.camera_arrays(cam, width, height, "cpu")
    jca = jax_raygen.camera_arrays(cam, width, height)
    for k, v in ca.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jca[k]))
    got = raygen.primary(ca, width, height, torch.from_numpy(order.copy()))
    ref = jax_raygen.primary(jca, width, height, jnp.asarray(order))
    assert got.num_rays == width * height
    for k in ("orig", "tmin", "tmax", "slot_to_id"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    np.testing.assert_allclose(got.dirn.numpy(), np.asarray(ref.dirn),
                               rtol=0, atol=1e-6)
    for k in ("orig", "dirn", "tmin", "tmax"):
        assert getattr(got, k).is_contiguous()


def test_safe_inv_dir_bit_equal():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    tiny = np.float32(np.exp2(-80.0))
    d[:8, 0] = [0.0, -0.0, tiny, -tiny, tiny * 2, -tiny * 2, 1e-30, -1e-30]
    d[8:12, 1] = [np.inf, -np.inf, 3.0e38, -3.0e38]
    got = safe_inv_dir(torch.from_numpy(d)).numpy()
    ref = np_safe_inv_dir(np, d)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_unsort_inverts_slot_order():
    order, _ = pixel_table(16, 8)
    slot_to_id = torch.from_numpy(order.copy())
    values = torch.arange(128, dtype=torch.float32)[:, None].repeat(1, 3)
    back = unsort(values, slot_to_id)
    np.testing.assert_array_equal(back.numpy()[order], values.numpy())
