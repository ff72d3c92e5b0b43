"""Ray generation (counterpart of ntrace_tpu/ray/raygen.py).

`camera_arrays` and `primary` (25-67): the NDC formula, the basis
combination summed left to right, then d / ||d|| with
||d|| = sqrt((x*x + y*y) + z*z). The secondary generators `_onb`,
`cosine_hemisphere`, `surface_frame`, `shadow`, `ao` and `diffuse`
(70-146) keep the reference's op order; their random numbers come from
`ray/rng.py`, bit-equal to jax.random. cos, sin and sqrt of torch and of
XLA on the CPU may differ in the last bit, so directions agree with the
reference within a few ulps, not bit for bit.

`secondary_rays` makes a frame's whole AO or diffuse batch and its sort
key from the primary rays and their hits: on a CUDA device in one launch
of the hand-written kernel csrc/secondary_rays.cu (which replaces no TPU
kernel), on the CPU through its plain version `secondary_rays_ref`, the
torch chain of surface_frame, ao and raybatch.morton_sort_key. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.host import Camera
from ntrace_tpu_torch.ray import rng
from ntrace_tpu_torch.ray.raybatch import DEAD_KEY, RayBatch, morton_sort_key
from ntrace_tpu_torch.utils import timing


def camera_arrays(camera: Camera, width: int, height: int,
                  device) -> dict:
    """A host Camera as 0-d / (3,) float32 tensors on `device`."""
    right, up, fwd = camera.basis()
    tan_half = np.tan(np.radians(camera.fov_deg) / 2.0)
    aspect = width / height

    def f32(a):
        return timing.upload(np.asarray(a, dtype=np.float32), device)

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
    from pixel_table), on the device of the camera tensors. An int32
    `pixel_order` on that device is the batch's slot_to_id itself, not a
    copy: callers write into neither."""
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


def cosine_hemisphere(key, n: torch.Tensor, shape: tuple):
    """Cosine-weighted directions about unit normals n, broadcast to
    shape + (3,); key is an rng key on n's device or its host words."""
    u = rng.uniform(key, tuple(shape) + (2,), n.device)
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


def ao(key, hit_pos: torch.Tensor, normal: torch.Tensor,
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


def diffuse(key, hit_pos: torch.Tensor, normal: torch.Tensor,
            samples: int, tfar, eps) -> RayBatch:
    """Cosine-weighted bounce rays (closest hit): the incoherent workload."""
    return ao(key, hit_pos, normal, samples, tfar, eps)


def secondary_rays_ref(words: tuple[int, int], batch: RayBatch,
                       tri: torch.Tensor, t: torch.Tensor,
                       geom_normals: torch.Tensor, samples: int, length,
                       eps, scene_lo: torch.Tensor, scene_hi: torch.Tensor,
                       direction_major: bool):
    """The plain version of `secondary_rays`: the surface frame of each
    primary hit, `ao`'s rays from the key words, tmax 0 where the primary
    ray missed, and morton_sort_key with DEAD_KEY on dead rays."""
    hit_mask = tri >= 0
    normals = surface_frame(tri, batch.dirn, geom_normals, 0.0)[0]
    hit_pos = batch.orig + torch.where(hit_mask, t, 0.0)[:, None] \
        * batch.dirn
    sec = ao(words, hit_pos, normals, samples, length, eps)
    live = torch.repeat_interleave(hit_mask, samples)
    tmax = torch.where(live, sec.tmax, 0.0)
    key = morton_sort_key(sec.orig, sec.dirn, scene_lo, scene_hi,
                          direction_major=direction_major)
    key = torch.where(tmax <= sec.tmin, DEAD_KEY, key)
    return RayBatch(sec.orig, sec.dirn, sec.tmin, tmax), key


def secondary_rays(words: tuple[int, int], batch: RayBatch,
                   tri: torch.Tensor, t: torch.Tensor,
                   geom_normals: torch.Tensor, samples: int, length, eps,
                   scene_lo: torch.Tensor, scene_hi: torch.Tensor,
                   direction_major: bool, bits: torch.Tensor | None = None):
    """The `samples` cosine-weighted rays of each primary ray of `batch`
    with hits (tri, t), unsorted (ray i * samples + s of primary ray i, no
    slot_to_id), and their int32 sort key: AO rays for direction_major
    False, diffuse rays for True. `words` are rng.key_words(seed); `length`
    is every live ray's tmax (the AO radius or the diffuse ray length),
    rays of missed primary rays are dead (tmax 0, key DEAD_KEY). `bits`,
    where given on a CUDA device, an (R * samples, 2) int32 tensor,
    receives the random words the kernel drew for each ray (to check them
    against rng.random_bits32's). Returns (RayBatch, key)."""
    n = batch.num_rays * samples
    if not uses_kernel(tri):
        if bits is not None:
            raise ValueError("bits= reads the kernel's random words; the "
                             "plain version on the CPU has none to give")
        return secondary_rays_ref(words, batch, tri, t, geom_normals,
                                  samples, length, eps, scene_lo, scene_hi,
                                  direction_major)
    if bits is not None and (bits.shape != (n, 2) or bits.dtype !=
                             torch.int32 or not bits.is_contiguous()
                             or bits.device != tri.device):
        raise ValueError(f"bits must be a contiguous ({n}, 2) int32 tensor "
                         "on tri's device")
    R, dev = batch.num_rays, tri.device
    ins = [batch.orig, batch.dirn, tri, t, geom_normals, scene_lo, scene_hi]
    f32, i32 = torch.float32, torch.int32
    want = [((R, 3), f32), ((R, 3), f32), ((R,), i32), ((R,), f32),
            ((geom_normals.shape[0], 3), f32), ((3,), f32), ((3,), f32)]
    got = [(tuple(a.shape), a.dtype) for a in ins]
    if got != want or any(a.device != dev for a in ins):
        raise ValueError(f"secondary_rays takes {want} on one device, got "
                         f"{got} on {[str(a.device) for a in ins]}")
    ins = [a.contiguous() for a in ins]
    out = RayBatch(
        orig=torch.empty((n, 3), dtype=torch.float32, device=dev),
        dirn=torch.empty((n, 3), dtype=torch.float32, device=dev),
        tmin=torch.empty((n,), dtype=torch.float32, device=dev),
        tmax=torch.empty((n,), dtype=torch.float32, device=dev))
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(ins, words, R, samples, length, eps, direction_major, out, key,
            bits)
    secondary_rays.launches += 1
    return out, key


secondary_rays.launches = 0   # kernel launches since the last reset


def _launch(ins, words, rays, samples, length, eps, direction_major, out,
            key, bits):
    """One call of ntrace_secondary_rays on the current CUDA stream."""
    from ntrace_tpu_torch.kernels.build import launch

    dev = key.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("ntrace_secondary_rays", *(a.data_ptr() for a in ins),
               *words, rays, samples, float(np.float32(length)),
               float(np.float32(eps)), int(direction_major),
               out.orig.data_ptr(), out.dirn.data_ptr(),
               out.tmin.data_ptr(), out.tmax.data_ptr(), key.data_ptr(),
               None if bits is None else bits.data_ptr(), stream)
