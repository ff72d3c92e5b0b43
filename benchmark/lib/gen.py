"""The benchmark's own copy of the renderer's ray generation.

Frozen here so that a change to the program's `ray/` package cannot change
the traffic the benchmark offers or the rays its reference re-derives:

  - `pixel_table`: the Morton pixel order of `ray/pixeltable.py`;
  - `camera_arrays`, `primary`: `ray/raygen.py` (camera_arrays, primary);
  - `prng_key`, `threefry2x32`, `uniform_at`: `ray/rng.py` (jax.random's
    threefry2x32 under `jax_threefry_partitionable`), with the counters
    given explicitly so that the reference can draw the numbers of a few
    rays without drawing all of them;
  - `cosine_hemisphere`, `surface_frame`, `secondary`: `ray/raygen.py`
    (ao, diffuse) and `Renderer.gen_secondary` for the AO and diffuse modes;
  - `sort_rays`: `ray/raybatch.py:morton_sort_rays` with `ops/morton.py`.

Each keeps the program's op order, so the rays are bit-equal to the ones
`render()` makes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
DEAD_KEY = 0x7FFFFFFF


@dataclass
class Rays:
    orig: torch.Tensor                 # (R, 3) f32
    dirn: torch.Tensor                 # (R, 3) f32
    tmin: torch.Tensor                 # (R,) f32
    tmax: torch.Tensor                 # (R,) f32
    slot_to_id: torch.Tensor           # (R,) i32: ray id of each slot

    @property
    def num_rays(self) -> int:
        return int(self.orig.shape[0])

    def take(self, idx: torch.Tensor) -> "Rays":
        return Rays(self.orig[idx], self.dirn[idx], self.tmin[idx],
                    self.tmax[idx], self.slot_to_id[idx])


# -- pixels and primary rays ------------------------------------------------

def _part1by1(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    v = (v | (v << np.uint32(8))) & np.uint32(0x00FF00FF)
    v = (v | (v << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    v = (v | (v << np.uint32(2))) & np.uint32(0x33333333)
    v = (v | (v << np.uint32(1))) & np.uint32(0x55555555)
    return v


def pixel_table(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """(index_to_pixel, pixel_to_index), (W*H,) int32: ray slot i holds
    pixel y*W + x, in the 2-D Morton order of (x, y), y in the high bits."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    codes = ((_part1by1(yy.ravel()) << np.uint32(1))
             | _part1by1(xx.ravel())).astype(np.int64)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    return order, inv


def camera_arrays(position, forward, up, fov_deg, znear, zfar, width,
                  height, device) -> dict:
    """A pinhole camera as 0-d / (3,) float32 tensors: the basis and the
    normalisations of the program's host Camera, then ray/raygen.py's
    camera_arrays."""
    pos = np.asarray(position, np.float32)
    f = np.asarray(forward, np.float64)
    fwd32 = (f / np.linalg.norm(f)).astype(np.float32)
    u = np.asarray(up, np.float64)
    up32 = (u / np.linalg.norm(u)).astype(np.float32)
    f64 = fwd32.astype(np.float64)
    r = np.cross(f64, up32.astype(np.float64))
    if np.linalg.norm(r) < 1e-12:
        r = np.cross(f64, np.array([1.0, 0.0, 0.0]))
    r = r / np.linalg.norm(r)
    true_up = np.cross(r, f64)
    tan_half = np.tan(np.radians(fov_deg) / 2.0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return dict(pos=f32(pos), right=f32(r.astype(np.float32)),
                up=f32(true_up.astype(np.float32)), fwd=f32(f64),
                tan_x=f32(tan_half * (width / height)), tan_y=f32(tan_half),
                znear=f32(znear), zfar=f32(zfar))


def norm3(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])[:, None]


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def primary(cam: dict, width: int, height: int,
            pixels: torch.Tensor) -> Rays:
    """One ray per pixel id in `pixels` ((n,) int32), in that slot order."""
    p = pixels.to(cam["pos"].device)
    x = (p % width).to(torch.float32)
    y = torch.div(p, width, rounding_mode="floor").to(torch.float32)
    ndc_x = (x + 0.5) / width * 2.0 - 1.0
    ndc_y = 1.0 - (y + 0.5) / height * 2.0
    d = (ndc_x[:, None] * (cam["tan_x"] * cam["right"])[None, :]
         + ndc_y[:, None] * (cam["tan_y"] * cam["up"])[None, :]
         + cam["fwd"][None, :])
    d = d / norm3(d)
    n = p.shape[0]
    return Rays(cam["pos"].expand(n, 3).contiguous(), d.contiguous(),
                cam["znear"].expand(n).contiguous(),
                cam["zfar"].expand(n).contiguous(), p.to(torch.int32))


# -- random numbers ---------------------------------------------------------

def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed) for a seed in the int32 range."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return 0, seed & M32


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on uint32 words held in int64."""
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def uniform_at(key: tuple[int, int], index: torch.Tensor) -> torch.Tensor:
    """Element `index` (int64, row-major) of jax.random.uniform(key, shape,
    float32), for any shape that holds it."""
    b1, b2 = threefry2x32(key[0], key[1], index >> 32, index & M32)
    fbits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


# -- secondary rays ---------------------------------------------------------

def _onb(n: torch.Tensor):
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(n2 >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n2)
    b = n0 * n1 * a
    b1 = torch.stack([1.0 + sign * n0 * n0 * a, sign * b, -sign * n0], dim=-1)
    b2 = torch.stack([b, sign + n1 * n1 * a, -n1], dim=-1)
    return b1, b2


def cosine_hemisphere(u0: torch.Tensor, u1: torch.Tensor, n: torch.Tensor):
    """Cosine-weighted directions about unit normals n from the uniform
    pairs (u0, u1), broadcast as raygen.cosine_hemisphere does."""
    r = torch.sqrt(u0)
    phi = float(np.float32(2.0 * np.pi)) * u1
    lx, ly = r * torch.cos(phi), r * torch.sin(phi)
    lz = torch.sqrt(torch.clamp_min(1.0 - u0, 0.0))
    b1, b2 = _onb(n)
    return lx[..., None] * b1 + ly[..., None] * b2 + lz[..., None] * n


def geometric_normals(tri_verts: torch.Tensor) -> torch.Tensor:
    """(M, 3) unnormalised cross(v1 - v0, v2 - v0) of (M, 3, 3) vertices."""
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    return torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                        e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)


def unit_normal(gn: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """The unit geometric normal of each hit triangle (tri -1: triangle 0)."""
    g = gn[tri.clamp(min=0).long()]
    return g / (norm3(g) + 1e-30)


def surface_frame(gn: torch.Tensor, tri: torch.Tensor, dirn: torch.Tensor):
    """Unit normals of the hits, flipped against the incoming rays."""
    g = unit_normal(gn, tri)
    return torch.where((dot3(g, dirn) > 0)[:, None], -g, g)


@dataclass(frozen=True)
class Scale:
    """What the renderer derives from the scene's box: its diagonal, the
    self-intersection offset and the box itself."""
    lo: torch.Tensor
    hi: torch.Tensor
    diag: float
    eps: float

    @staticmethod
    def of(positions: np.ndarray, device) -> "Scale":
        lo, hi = positions.min(axis=0), positions.max(axis=0)
        diag = float(np.linalg.norm(hi - lo))
        return Scale(torch.as_tensor(lo, device=device),
                     torch.as_tensor(hi, device=device), diag,
                     float(np.float32(diag * 1e-4)))

    def box(self) -> tuple[np.ndarray, np.ndarray]:
        return self.lo.cpu().numpy(), self.hi.cpu().numpy()


def secondary_tmax(mode: str, scale: Scale, ao_radius: float) -> float:
    """The ray length of an AO or diffuse ray, as gen_secondary sets it."""
    arg = ao_radius if mode == "ao" else scale.diag * 10.0
    return float(np.float32(arg))


def secondary(key: tuple[int, int], mode: str, prim: Rays, tri: torch.Tensor,
              t: torch.Tensor, gn: torch.Tensor, scale: Scale, samples: int,
              ao_radius: float, slots: torch.Tensor | None = None) -> Rays:
    """The AO or diffuse rays of the primary slots `slots` (all slots when
    None), `samples` a slot, as Renderer.gen_secondary makes them before its
    sort: ray i * samples + s belongs to primary slot i, and rays of missed
    slots are dead (tmax 0). `prim`, `tri` and `t` hold the primary rays and
    hits of those slots only."""
    n = prim.num_rays
    if slots is None:
        slots = torch.arange(n, device=prim.orig.device)
    hit = tri >= 0
    normal = surface_frame(gn, tri, prim.dirn)
    hit_pos = prim.orig + torch.where(hit, t, 0.0)[:, None] * prim.dirn
    # uniform(key, (R, S, 2)): element ((slot * S) + s) * 2 + c.
    base = (slots.long()[:, None] * samples
            + torch.arange(samples, device=slots.device)[None, :]) * 2
    u0, u1 = uniform_at(key, base), uniform_at(key, base + 1)
    d = cosine_hemisphere(u0, u1, normal[:, None, :]).reshape(-1, 3)
    o = torch.repeat_interleave(hit_pos + normal * scale.eps, samples, dim=0)
    m = n * samples
    length = secondary_tmax(mode, scale, ao_radius)
    live = torch.repeat_interleave(hit, samples)
    return Rays(o, d, torch.zeros((m,), dtype=torch.float32, device=o.device),
                torch.where(live, length, 0.0).to(torch.float32),
                torch.arange(m, dtype=torch.int32, device=o.device))


# -- the Morton re-sort -----------------------------------------------------

def _expand_bits_3d(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64) & M32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _morton_codes_3d(pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    scale = float(np.float32(1023))
    ext = torch.clamp(hi - lo, min=float(np.float32(1e-30)))
    q = (torch.clamp((pts - lo) / ext, 0.0, 1.0) * scale).to(torch.int32)
    return ((_expand_bits_3d(q[:, 0]) << 2) | (_expand_bits_3d(q[:, 1]) << 1)
            | _expand_bits_3d(q[:, 2])).to(torch.int32)


def _sort_key(rays: Rays, lo, hi, direction_major: bool) -> torch.Tensor:
    oc = _morton_codes_3d(rays.orig, lo, hi)
    d = rays.dirn
    if not direction_major:
        octant = ((d[:, 0] < 0).to(torch.int32) * 4
                  + (d[:, 1] < 0).to(torch.int32) * 2
                  + (d[:, 2] < 0).to(torch.int32))
        return (oc & ~7) | octant
    unit = d / torch.clamp_min(norm3(d), 1e-30)
    n2 = ((unit + 1.0) * 2.0).to(torch.int32).clamp(0, 3)
    dir6 = torch.zeros_like(oc)
    for b in range(2):
        dir6 = (dir6 | ((n2[:, 0] >> b) & 1) << (3 * b + 2)
                | ((n2[:, 1] >> b) & 1) << (3 * b + 1)
                | ((n2[:, 2] >> b) & 1) << (3 * b + 0))
    return (dir6 << 25) | (oc >> 5)


def sort_rays(rays: Rays, scale: Scale, direction_major: bool) -> Rays:
    """Rays in coherence order, dead rays last, slot_to_id carried along
    (AO: origin-major; diffuse: direction-major)."""
    key = _sort_key(rays, scale.lo, scale.hi, direction_major)
    key = torch.where(rays.tmax <= rays.tmin, DEAD_KEY, key)
    return rays.take(torch.argsort(key, stable=True))
