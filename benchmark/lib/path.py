"""The plain reference of a path frame: each sampled pixel's whole path,
re-derived from the scene alone, in float32 torch with TF32 off.

It repeats the program's path mode (`Renderer._path_trace` as of the
commit that added this file), op for op, for the pixels it is given:

  - the pixel's primary ray (lib/gen.py:primary) and its closest hit; a
    primary miss adds the sky term 0.05;
  - for each bounce b below `bounces`, on the ray's last hit: the hit's
    material, its emission added under the running throughput, the
    throughput times its diffuse colour (both where the path is alive);
    the unit geometric normal flipped against the incoming ray; the hit
    point and the origin moved eps along the normal; the key split as
    jax.random.split does (threefry of the counters (0, 0) and (0, 1):
    the first half goes on, the second draws) and the cosine-weighted
    direction from elements 2s and 2s + 1 of uniform(sub, (R, 2)), s the
    pixel's slot in the frame's R-ray batch (the Morton pixel order);
    tmin 0 and tmax ten scene diagonals, 0 where the path has died; its
    closest hit; the sky term 0.8 times the throughput where a live path
    misses; the path dies at a miss;
  - the last hit's emission and throughput;
  - the last bounce's hit, which the program keeps (RenderResult.bounce_tri)
    for the check.

Departures from `_path_trace`: the bounce rays are neither Morton-sorted
nor compacted to their live prefix (a ray's hit does not depend on its
batch: the sort only reorders, and a dead ray, tmax 0, misses either
way); only the sampled pixels' rays are traced, every one against every
triangle (lib/reference.py:closest_hits, or the caller's `trace`); the
bounce rays are this chain of torch operations, where the program makes
them in one kernel launch on a CUDA device (within 2 ulps of the chain).
It imports nothing of the program: the scene's vertices, triangles and
materials are handed in as tensors.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

from benchmark.lib import gen

PRIMARY_SKY = 0.05
BOUNCE_SKY = 0.8


@dataclass
class Materials:
    ids: torch.Tensor          # (M,) int64: each triangle's material
    diffuse: torch.Tensor      # (K, 3) float32
    emissive: torch.Tensor     # (K, 3) float32


@contextmanager
def no_tf32():
    """float32 matrix products and convolutions in float32 inside."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """jax.random.split(key, 2) as host words: (the key that goes on, the
    key that draws)."""
    b1, b2 = gen.threefry2x32(key[0], key[1],
                              torch.zeros(2, dtype=torch.int64),
                              torch.arange(2, dtype=torch.int64))
    return (int(b1[0]), int(b2[0])), (int(b1[1]), int(b2[1]))


def radiance(key: tuple[int, int], slots: torch.Tensor, prim: gen.Rays,
             trace, gn: torch.Tensor, mats: Materials, scale: gen.Scale,
             bounces: int) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(colour (n, 3) float32, primary triangle (n,) int32, the path's last
    triangle (n,) int32: the last bounce's hit, -1 where the path ended
    before it) of the n pixels whose primary rays are `prim`, in ray slots
    `slots` ((n,) int64).
    trace(orig, dirn, tmin, tmax) -> (tri, t) gives closest hits, first of
    the primary rays, then of each bounce's."""
    with no_tf32():
        return _radiance(key, slots, prim, trace, gn, mats, scale, bounces)


def _radiance(key, slots, prim, trace, gn, mats, scale, bounces):
    n = prim.num_rays
    dev = prim.orig.device
    tri, t = trace(prim.orig, prim.dirn, prim.tmin, prim.tmax)
    primary_tri = tri
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    total = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = tri >= 0
    total = total + torch.where(alive[:, None], 0.0, PRIMARY_SKY)
    orig, dirn = prim.orig, prim.dirn
    length = gen.secondary_tmax("diffuse", scale, 0.0)
    for b in range(bounces + 1):
        mat = mats.ids[tri.clamp(min=0).long()]
        emis = mats.emissive[mat]
        diff = mats.diffuse[mat]
        total = total + torch.where(alive[:, None], throughput * emis, 0.0)
        throughput = throughput * torch.where(alive[:, None], diff, 0.0)
        if b == bounces:
            break
        normal = gen.surface_frame(gn, tri, dirn)
        hit_pos = orig + torch.where(alive, t, 0.0)[:, None] * dirn
        key, sub = split(key)
        base = slots.long() * 2
        d = gen.cosine_hemisphere(gen.uniform_at(sub, base),
                                  gen.uniform_at(sub, base + 1), normal)
        o = hit_pos + normal * scale.eps
        tmax = torch.where(alive, length, 0.0).to(torch.float32)
        tri, t = trace(o, d, torch.zeros((n,), dtype=torch.float32,
                                         device=dev), tmax)
        orig, dirn = o, d
        sky = (tri < 0) & alive
        total = total + torch.where(sky[:, None], throughput * BOUNCE_SKY,
                                    0.0)
        alive = alive & (tri >= 0)
    return total, primary_tri, tri
