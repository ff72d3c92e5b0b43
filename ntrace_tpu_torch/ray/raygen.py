"""Primary ray generation (counterpart of ntrace_tpu/ray/raygen.py:25-67).

The op order is the reference's: the NDC formula, the basis combination
summed left to right, then d / ||d|| with ||d|| = sqrt((x*x + y*y) + z*z).
Secondary generators (shadow, ao, diffuse) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ntrace_tpu_torch.host import Camera
from ntrace_tpu_torch.ray.raybatch import RayBatch


def camera_arrays(camera: Camera, width: int, height: int,
                  device) -> dict:
    """A host Camera as 0-d / (3,) float32 tensors on `device`."""
    right, up, fwd = camera.basis()
    tan_half = np.tan(np.radians(camera.fov_deg) / 2.0)
    aspect = width / height

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    return dict(
        pos=f32(camera.position),
        right=f32(right),
        up=f32(up),
        fwd=f32(fwd),
        tan_x=f32(tan_half * aspect),
        tan_y=f32(tan_half),
        znear=f32(camera.znear),
        zfar=f32(camera.zfar),
    )


def norm3(d: torch.Tensor) -> torch.Tensor:
    """(R, 3) -> (R, 1) Euclidean length, summed x, y, z in that order."""
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])[:, None]


def primary(cam: dict, width: int, height: int,
            pixel_order: torch.Tensor) -> RayBatch:
    """One ray per pixel in the slot order of `pixel_order` ((W*H,) int32,
    from pixel_table), on the device of the camera tensors."""
    p = torch.as_tensor(pixel_order, device=cam["pos"].device)
    x = (p % width).to(torch.float32)
    y = torch.div(p, width, rounding_mode="floor").to(torch.float32)
    ndc_x = (x + 0.5) / width * 2.0 - 1.0
    ndc_y = 1.0 - (y + 0.5) / height * 2.0
    d = (ndc_x[:, None] * (cam["tan_x"] * cam["right"])[None, :]
         + ndc_y[:, None] * (cam["tan_y"] * cam["up"])[None, :]
         + cam["fwd"][None, :])
    d = d / norm3(d)
    n = p.shape[0]
    return RayBatch(
        orig=cam["pos"].expand(n, 3).contiguous(),
        dirn=d.contiguous(),
        tmin=cam["znear"].expand(n).contiguous(),
        tmax=cam["zfar"].expand(n).contiguous(),
        slot_to_id=p.to(torch.int32),
    )
