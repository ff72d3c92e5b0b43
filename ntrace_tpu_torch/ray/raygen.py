"""Ray generation (counterpart of ntrace_tpu/ray/raygen.py).

`camera_arrays` and `primary` (25-67): the NDC formula, the basis
combination summed left to right, then d / ||d|| with
||d|| = sqrt((x*x + y*y) + z*z). The secondary generators `_onb`,
`cosine_hemisphere`, `surface_frame`, `shadow`, `ao` and `diffuse`
(70-146) keep the reference's op order; their random numbers come from
`ray/rng.py`, bit-equal to jax.random. cos, sin and sqrt of torch and of
XLA on the CPU may differ in the last bit, so directions agree with the
reference within a few ulps, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ntrace_tpu_torch.host import Camera
from ntrace_tpu_torch.ray import rng
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


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 3), (R, 3) -> (R,) dot products, summed x, y, z in that order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


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


def _onb(n: torch.Tensor):
    """Branchless orthonormal basis around unit normals n (..., 3) (Duff
    et al. 2017)."""
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(n2 >= 0, 1.0, -1.0)
    a = -1.0 / (sign + n2)
    b = n0 * n1 * a
    b1 = torch.stack([1.0 + sign * n0 * n0 * a, sign * b, -sign * n0], dim=-1)
    b2 = torch.stack([b, sign + n1 * n1 * a, -n1], dim=-1)
    return b1, b2


def cosine_hemisphere(key: torch.Tensor, n: torch.Tensor, shape: tuple):
    """Cosine-weighted directions about unit normals n, broadcast to
    shape + (3,); key is an rng key on n's device."""
    u = rng.uniform(key, tuple(shape) + (2,))
    r = torch.sqrt(u[..., 0])
    phi = float(np.float32(2.0 * np.pi)) * u[..., 1]
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    b1, b2 = _onb(n)
    return lx[..., None] * b1 + ly[..., None] * b2 + lz[..., None] * n


def surface_frame(hit_tri: torch.Tensor, dirn: torch.Tensor,
                  geom_normals: torch.Tensor, eps_scale: float):
    """Unit geometric normal of each hit, flipped against the incoming ray,
    and the self-intersection offset magnitude."""
    gn = geom_normals[hit_tri.clamp(min=0).long()]
    gn = gn / (norm3(gn) + 1e-30)
    flip = dot3(gn, dirn) > 0
    return torch.where(flip[:, None], -gn, gn), float(np.float32(eps_scale))


def shadow(hit_pos: torch.Tensor, normal: torch.Tensor,
           light_pos: torch.Tensor, eps) -> RayBatch:
    """Any-hit rays from surface points toward a point light."""
    o = hit_pos + normal * eps
    to_l = light_pos[None, :] - o
    dist = norm3(to_l)[:, 0]
    d = to_l / (dist[:, None] + 1e-30)
    r = o.shape[0]
    return RayBatch(
        orig=o, dirn=d,
        tmin=torch.zeros((r,), dtype=torch.float32, device=o.device),
        tmax=dist * float(np.float32(1.0 - 1e-4)),
        slot_to_id=torch.arange(r, dtype=torch.int32, device=o.device))


def ao(key: torch.Tensor, hit_pos: torch.Tensor, normal: torch.Tensor,
       samples: int, radius, eps) -> RayBatch:
    """`samples` cosine-weighted rays per surface point, tmax = radius
    (any-hit). Ray i * samples + s belongs to surface point i."""
    r = hit_pos.shape[0]
    d = cosine_hemisphere(key, normal[:, None, :], (r, samples)).reshape(-1, 3)
    o = torch.repeat_interleave(hit_pos + normal * eps, samples, dim=0)
    n = r * samples
    return RayBatch(
        orig=o, dirn=d,
        tmin=torch.zeros((n,), dtype=torch.float32, device=o.device),
        tmax=torch.full((n,), float(np.float32(radius)), dtype=torch.float32,
                        device=o.device),
        slot_to_id=torch.arange(n, dtype=torch.int32, device=o.device))


def diffuse(key: torch.Tensor, hit_pos: torch.Tensor, normal: torch.Tensor,
            samples: int, tfar, eps) -> RayBatch:
    """Cosine-weighted bounce rays (closest hit): the incoherent workload."""
    return ao(key, hit_pos, normal, samples, tfar, eps)
