"""Brute-force CPU reference intersector -- the root of trust.

The reference validated by eyeballing screenshots (SURVEY.md SS5); this
rebuild validates every engine against exhaustive O(rays x tris)
intersection instead. Chunked over both rays and triangles so memory stays
bounded; closest-hit ties break to the lowest triangle index.

Both intersectors are exposed: Moller-Trumbore on raw vertices (independent
formulation) and Woop on the flattened records (shared formulation with the
GPU-path engines) -- agreement between the two validates the woopify
transform itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu_torch.host.core import Scene
from ntrace_tpu_torch.host.ops.intersect import moller_trumbore
from ntrace_tpu_torch.host.ops.woop import woop_intersect, woopify


@dataclass
class HitRecord:
    tri: np.ndarray  # (R,) int32, -1 = miss
    t: np.ndarray    # (R,) float32, +inf on miss
    u: np.ndarray    # (R,) float32
    v: np.ndarray    # (R,) float32


def _brute_force(test_chunk, n_tris, orig, dirn, tmin, tmax,
                 ray_chunk=4096, tri_chunk=2048, any_hit=False):
    R = orig.shape[0]
    best_t = np.full((R,), np.inf, dtype=np.float32)
    best_id = np.full((R,), -1, dtype=np.int32)
    best_u = np.zeros((R,), dtype=np.float32)
    best_v = np.zeros((R,), dtype=np.float32)
    for r0 in range(0, R, ray_chunk):
        r1 = min(r0 + ray_chunk, R)
        o = orig[r0:r1, None, :]
        d = dirn[r0:r1, None, :]
        t0 = tmin[r0:r1, None]
        t1 = tmax[r0:r1, None]
        done = np.zeros((r1 - r0,), dtype=bool)
        for c0 in range(0, n_tris, tri_chunk):
            c1 = min(c0 + tri_chunk, n_tris)
            valid, t, u, v = test_chunk(c0, c1, o, d, t0, t1)
            tt = np.where(valid, t, np.float32(np.inf))
            pos = np.argmin(tt, axis=1)
            rows = np.arange(r1 - r0)
            ct = tt[rows, pos]
            cid = (c0 + pos).astype(np.int32)
            # Lowest-tri-index tie-break: chunks scan ascending and argmin
            # returns the first minimum, so strict < keeps the earliest.
            better = ct < best_t[r0:r1]
            np.copyto(best_t[r0:r1], ct, where=better)
            np.copyto(best_id[r0:r1], cid, where=better)
            np.copyto(best_u[r0:r1], u[rows, pos], where=better)
            np.copyto(best_v[r0:r1], v[rows, pos], where=better)
            if any_hit:
                done |= best_id[r0:r1] >= 0
                if done.all():
                    break
    return HitRecord(best_id, best_t, best_u, best_v)


def brute_force_mt(scene: Scene, orig, dirn, tmin, tmax, **kw) -> HitRecord:
    """Exhaustive Moller-Trumbore closest hit."""
    tv = scene.tri_verts()

    def test_chunk(c0, c1, o, d, t0, t1):
        v0 = tv[None, c0:c1, 0]
        v1 = tv[None, c0:c1, 1]
        v2 = tv[None, c0:c1, 2]
        return moller_trumbore(np, o, d, v0, v1, v2, t0, t1)

    return _brute_force(test_chunk, scene.num_tris,
                        np.asarray(orig, np.float32), np.asarray(dirn, np.float32),
                        np.asarray(tmin, np.float32), np.asarray(tmax, np.float32), **kw)


def brute_force_woop(scene: Scene, orig, dirn, tmin, tmax, woop12=None, **kw) -> HitRecord:
    """Exhaustive Woop-record closest hit (validates woopify)."""
    if woop12 is None:
        woop12 = woopify(scene.tri_verts())

    def test_chunk(c0, c1, o, d, t0, t1):
        return woop_intersect(np, woop12[None, c0:c1], o, d, t0, t1)

    return _brute_force(test_chunk, scene.num_tris,
                        np.asarray(orig, np.float32), np.asarray(dirn, np.float32),
                        np.asarray(tmin, np.float32), np.asarray(tmax, np.float32), **kw)


def brute_force_anyhit(scene: Scene, orig, dirn, tmin, tmax) -> np.ndarray:
    """(R,) bool: does any triangle block the segment [tmin, tmax]?"""
    rec = brute_force_mt(scene, orig, dirn, tmin, tmax, any_hit=True)
    return rec.tri >= 0
