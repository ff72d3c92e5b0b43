"""The stage both screen-space engines share: project, clip, bin.

Counterpart of ntrace_tpu/trace/binraster.py: `INF` and `Z_MARGIN`
(56-57), `_project` (89-99) and `_counts` (102-179). The v1 engine's prep
and kernel are not ported yet (ROADMAP queue 2).

The arithmetic is the reference's, op for op, so that both packages bin
every triangle alike: the camera-space dot products are written out as
`(q0*f0 + q1*f1) + q2*f2`, and `lax.rsqrt` is `torch.rsqrt`. Float bin
coordinates are clamped to the grid before they are cast to int32, which
is what XLA's saturating cast followed by `clip` gives, without relying
on an out-of-range cast.
"""

from __future__ import annotations

import numpy as np
import torch

INF = np.float32(3.0e38)
Z_MARGIN = np.float32(3e-5)   # relative slack: projection vs MT rounding


def _dot3(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) . (3,) over the last axis, summed left to right."""
    return (q[..., 0] * f[0] + q[..., 1] * f[1]) + q[..., 2] * f[2]


def _project(verts: torch.Tensor, cam: dict):
    """Camera-space x, y, z of every vertex, each (n, 3)."""
    q = verts - cam["pos"]
    return _dot3(q, cam["right"]), _dot3(q, cam["up"]), _dot3(q, cam["fwd"])


def _bin_index(p: torch.Tensor, tile: int, nbins: int) -> torch.Tensor:
    ts = torch.tensor(tile, dtype=torch.float32, device=p.device)
    return torch.floor(p / ts).clamp(0, nbins - 1).to(torch.int32)


def _counts(verts: torch.Tensor, cam: dict, *, width: int, height: int,
            tile: int):
    """Per-triangle bin rectangle, pair count and conservative zmin.

    verts: (n, 3, 3) float32. Returns (tx0, tx1, ty0, ty1, cnt) int32 and
    zmin float32, each (n,). Near-plane crossers are clipped exactly at 99%
    of the nearest plane a primary hit can reach, and culled triangles get
    cnt 0 (see the reference's docstring for the exactness argument).
    """
    f32 = dict(dtype=torch.float32, device=verts.device)
    txn, tyn = width // tile, height // tile
    xc, yc, zc = _project(verts, cam)
    tanx, tany = cam["tan_x"], cam["tan_y"]
    zclip = torch.maximum(
        cam["znear"] * torch.rsqrt(1.0 + tanx * tanx + tany * tany)
        * torch.tensor(0.99, **f32), torch.tensor(1e-30, **f32))
    half_w = torch.tensor(0.5 * width, **f32)
    half_h = torch.tensor(0.5 * height, **f32)
    big = torch.tensor(3e38, **f32)
    vin = zc >= zclip                                   # (n, 3)
    wsafe = torch.where(vin, zc, torch.ones_like(zc))
    pxv = (xc / wsafe / tanx + 1.0) * half_w
    pyv = (1.0 - yc / wsafe / tany) * half_h
    minx = torch.where(vin, pxv, big).amin(dim=1)
    maxx = torch.where(vin, pxv, -big).amax(dim=1)
    miny = torch.where(vin, pyv, big).amin(dim=1)
    maxy = torch.where(vin, pyv, -big).amax(dim=1)
    anyc = torch.zeros_like(vin[:, 0])
    for i, j in ((0, 1), (1, 2), (2, 0)):
        cross = vin[:, i] != vin[:, j]
        zi, zj = zc[:, i], zc[:, j]
        # Near-parallel crossers: clamp s to the segment and also cover
        # both endpoints projected at the clip plane (reference 137-161).
        s = ((zclip - zi) / torch.where(cross, zj - zi, torch.ones_like(zi))
             ).clamp(0.0, 1.0)
        xi = xc[:, i] + s * (xc[:, j] - xc[:, i])
        yi = yc[:, i] + s * (yc[:, j] - yc[:, i])
        pxe = (xi / zclip / tanx + 1.0) * half_w
        pye = (1.0 - yi / zclip / tany) * half_h
        minx = torch.minimum(minx, torch.where(cross, pxe, big))
        maxx = torch.maximum(maxx, torch.where(cross, pxe, -big))
        miny = torch.minimum(miny, torch.where(cross, pye, big))
        maxy = torch.maximum(maxy, torch.where(cross, pye, -big))
        npar = cross & ((zj - zi).abs() < torch.tensor(1e-4, **f32) * zclip)
        for xe, ye in ((xc[:, i], yc[:, i]), (xc[:, j], yc[:, j])):
            pxn = (xe / zclip / tanx + 1.0) * half_w
            pyn = (1.0 - ye / zclip / tany) * half_h
            minx = torch.minimum(minx, torch.where(npar, pxn, big))
            maxx = torch.maximum(maxx, torch.where(npar, pxn, -big))
            miny = torch.minimum(miny, torch.where(npar, pyn, big))
            maxy = torch.maximum(maxy, torch.where(npar, pyn, -big))
        anyc = anyc | cross
    pad = torch.where(anyc, torch.tensor(2.0, **f32),
                      torch.tensor(1e-2, **f32))
    minx, maxx = minx - pad, maxx + pad
    miny, maxy = miny - pad, maxy + pad
    contrib = vin.any(dim=1)
    offscreen = (maxx < 0) | (minx > width) | (maxy < 0) | (miny > height)
    cull = ~contrib | offscreen
    tx0, tx1 = _bin_index(minx, tile, txn), _bin_index(maxx, tile, txn)
    ty0, ty1 = _bin_index(miny, tile, tyn), _bin_index(maxy, tile, tyn)
    cnt = torch.where(cull, 0, (tx1 - tx0 + 1) * (ty1 - ty0 + 1))
    zmin_v = torch.where(vin, zc, big).amin(dim=1)
    zmin = torch.where(anyc, torch.minimum(zmin_v, zclip), zmin_v)
    zmin = torch.where(cull, torch.zeros_like(zmin), zmin)
    return tx0, tx1, ty0, ty1, cnt.to(torch.int32), zmin
