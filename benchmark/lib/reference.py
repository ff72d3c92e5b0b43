"""The plain reference: every ray against every triangle, in torch.

It imports nothing of the program and takes nothing the program made: it
reads the scene's vertices and the rays, and nothing else. A closest hit is
the smallest t, the lowest triangle id on a tie in t; an any hit is any
valid hit. A hit is valid where det != 0, u >= 0, v >= 0, u + v <= 1 and
tmin < t < tmax (the kernels accept a hit only below the running distance,
which starts at tmax). The Moller-Trumbore arithmetic keeps the op order of
the program's twins (trace/packet_common.py:mt_row_best as of the commit
that froze this file), so a sound program agrees with it bit for bit.

`dtype` is the precision the whole computation runs in: float32 for the
reference, bfloat16 for the control, the reference put in the program's
place one precision lower (the step a later PR compressing vertices or
boxes would take).
"""

from __future__ import annotations

import torch

INF = 3.0e38
INT_MAX = 0x7FFFFFFF
# Elements of one (rays, triangles) block: memory stays a few GB.
BLOCK_ELEMENTS = 1 << 26


class Triangles:
    """v0, e1, e2 of every triangle, computed in `dtype` from the float32
    vertices (M, 3, 3)."""

    def __init__(self, tri_verts: torch.Tensor, dtype=torch.float32):
        v = tri_verts.to(dtype)
        self.dtype = dtype
        self.v0 = v[:, 0].T.contiguous()              # (3, M)
        self.e1 = (v[:, 1] - v[:, 0]).T.contiguous()
        self.e2 = (v[:, 2] - v[:, 0]).T.contiguous()
        self.count = int(v.shape[0])


def _block_hits(tris: Triangles, c0: int, c1: int, o, d, tn, tx):
    """(t, u, v, valid) of rays (B,) against triangles c0..c1, (B, C)."""
    dt = tris.dtype
    v0x, v0y, v0z = (a[None, c0:c1] for a in tris.v0)
    e1x, e1y, e1z = (a[None, c0:c1] for a in tris.e1)
    e2x, e2y, e2z = (a[None, c0:c1] for a in tris.e2)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    one = torch.ones((), dtype=dt, device=det.device)
    inv = one / torch.where(det == 0, one, det)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > tn[:, None]) & (t < tx[:, None]))
    return t, u, v, valid


def _blocks(tris: Triangles, n_rays: int):
    """(rays a block, triangles a chunk)."""
    chunk = min(tris.count, BLOCK_ELEMENTS)
    return max(1, BLOCK_ELEMENTS // max(chunk, 1)), max(chunk, 1)


def closest_hits(tris: Triangles, orig, dirn, tmin, tmax):
    """(tri i32, t, u, v) float32 of each ray's closest hit; a miss is tri
    -1 with t, u, v 0."""
    dt, dev = tris.dtype, orig.device
    n = orig.shape[0]
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out = [torch.zeros((n,), dtype=torch.float32, device=dev)
           for _ in range(3)]
    rays_a_block, chunk = _blocks(tris, n)
    for r0 in range(0, n, rays_a_block):
        r1 = min(n, r0 + rays_a_block)
        o, d = orig[r0:r1].to(dt), dirn[r0:r1].to(dt)
        tn, tx = tmin[r0:r1].to(dt), tmax[r0:r1].to(dt)
        best_t = torch.full((r1 - r0,), INF, dtype=torch.float32, device=dev)
        best_id = torch.full((r1 - r0,), INT_MAX, dtype=torch.int64,
                             device=dev)
        best_u, best_v = torch.zeros_like(best_t), torch.zeros_like(best_t)
        for c0 in range(0, tris.count, chunk):
            c1 = min(tris.count, c0 + chunk)
            t, u, v, valid = _block_hits(tris, c0, c1, o, d, tn, tx)
            tt = torch.where(valid, t.float(), INF)
            ct = tt.min(dim=1).values
            ids = torch.arange(c0, c1, device=dev)[None, :]
            cand = valid & (tt == ct[:, None])
            cid = torch.where(cand, ids, INT_MAX).min(dim=1).values
            col = (cid - c0).clamp(0, c1 - c0 - 1)[:, None]
            cu = u.gather(1, col)[:, 0].float()
            cv = v.gather(1, col)[:, 0].float()
            take = (cid != INT_MAX) & ((ct < best_t)
                                       | ((ct == best_t) & (cid < best_id)))
            best_t = torch.where(take, ct, best_t)
            best_id = torch.where(take, cid, best_id)
            best_u = torch.where(take, cu, best_u)
            best_v = torch.where(take, cv, best_v)
        hit = best_id != INT_MAX
        tri[r0:r1] = torch.where(hit, best_id, -1).to(torch.int32)
        for a, b in zip(out, (best_t, best_u, best_v)):
            a[r0:r1] = torch.where(hit, b, 0.0)
    return (tri, *out)


def any_hits(tris: Triangles, orig, dirn, tmin, tmax) -> torch.Tensor:
    """(R,) bool: the ray is blocked by some triangle."""
    dt, dev = tris.dtype, orig.device
    n = orig.shape[0]
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    rays_a_block, chunk = _blocks(tris, n)
    for r0 in range(0, n, rays_a_block):
        r1 = min(n, r0 + rays_a_block)
        o, d = orig[r0:r1].to(dt), dirn[r0:r1].to(dt)
        tn, tx = tmin[r0:r1].to(dt), tmax[r0:r1].to(dt)
        for c0 in range(0, tris.count, chunk):
            c1 = min(tris.count, c0 + chunk)
            blocked[r0:r1] |= _block_hits(tris, c0, c1, o, d, tn,
                                          tx)[3].any(dim=1)
    return blocked
