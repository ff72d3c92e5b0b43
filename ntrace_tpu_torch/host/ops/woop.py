"""Woop unit-triangle transform and intersection test.

Reference parity (SURVEY.md SS3.3; expected rt/cuda/CudaBVH.cpp woopifyTri +
src/rt/kernels/CudaTracerKernels.hpp): each triangle is stored as three
float4 rows m0, m1, m2 of the inverse of the affine matrix whose columns are
(e1, e2, n, p0) with e1=p1-p0, e2=p2-p0, n=cross(e1,e2):

    m0 = ( inv[2,0], inv[2,1], inv[2,2], -inv[2,3] )
    m1 =   inv[0,:]
    m2 =   inv[1,:]

and the GPU test is:

    Oz = m0.w - dot(orig, m0.xyz);  invDz = 1/dot(dir, m0.xyz);  t = Oz*invDz
    if tmin < t < hitT:
        u = (m1.w + dot(orig, m1.xyz)) + t * dot(dir, m1.xyz)
        if u >= 0:
            v = (m2.w + dot(orig, m2.xyz)) + t * dot(dir, m2.xyz)
            if v >= 0 and u + v <= 1: hit (t, u, v)

Deviation from the reference (documented per repo policy): we compute the
inverse in float64 via the closed-form adjugate before casting the stored
rows to float32 (the reference inverts in float32). Both the golden tracer
and the TPU engines consume the SAME stored f32 rows, so parity between our
engines is unaffected; the f64 inverse only improves conditioning on sliver
triangles. Degenerate triangles (|n|^2 == 0) get a poison record that can
never report a hit.
"""

from __future__ import annotations

import numpy as np


def woopify(tri_verts: np.ndarray) -> np.ndarray:
    """(T, 3, 3) float32 triangle vertices -> (T, 12) float32 woop rows.

    Output row layout: [m0.x m0.y m0.z m0.w  m1.x.. m1.w  m2.x.. m2.w].
    """
    p0 = tri_verts[:, 0].astype(np.float64)
    p1 = tri_verts[:, 1].astype(np.float64)
    p2 = tri_verts[:, 2].astype(np.float64)
    e1 = p1 - p0
    e2 = p2 - p0
    n = np.cross(e1, e2)
    det = np.einsum("ij,ij->i", n, n)  # = e1 . (e2 x n) = |n|^2
    ok = det != 0.0
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]

    # Rows of A^-1 for A = [e1 e2 n] (columns), via the adjugate:
    r0 = np.cross(e2, n) * inv_det  # u row
    r1 = np.cross(n, e1) * inv_det  # v row
    r2 = n * inv_det                # z row

    # Affine inverse translation: inv[:,3] = -A^-1 @ p0
    t0 = -np.einsum("ij,ij->i", r0, p0)
    t1 = -np.einsum("ij,ij->i", r1, p0)
    t2 = -np.einsum("ij,ij->i", r2, p0)

    out = np.empty((tri_verts.shape[0], 12), dtype=np.float32)
    out[:, 0:3] = r2
    out[:, 3] = -t2  # m0.w = -inv[2,3]
    out[:, 4:7] = r0
    out[:, 7] = t0
    out[:, 8:11] = r1
    out[:, 11] = t1

    # Poison degenerate triangles: m0=(0,0,0,0) makes t = 0*inf = NaN (all
    # comparisons false) and m1.w=-1 forces u<0 even if t were finite.
    bad = ~ok
    if bad.any():
        out[bad] = 0.0
        out[bad, 7] = -1.0
        out[bad, 11] = -1.0
    return out


def woop_intersect(ns, woop12, orig, dirn, tmin, tmax):
    """Batched Woop test against (..., 12) woop rows.

    orig, dirn : (..., 3); tmin, tmax : (...)
    Returns (valid, t, u, v); invalid lanes carry garbage t/u/v -- mask them.
    NaNs from parallel rays / poison records fail every comparison => miss.
    """
    one = np.float32(1.0)
    oz = woop12[..., 3] - (
        orig[..., 0] * woop12[..., 0]
        + orig[..., 1] * woop12[..., 1]
        + orig[..., 2] * woop12[..., 2]
    )
    dz = (
        dirn[..., 0] * woop12[..., 0]
        + dirn[..., 1] * woop12[..., 1]
        + dirn[..., 2] * woop12[..., 2]
    )
    # inf on parallel rays; NaN propagates to a miss. Intentional IEEE
    # semantics -- silence the numpy warnings so benchmark/test provenance
    # logs stay clean (jnp never warns; errstate is a no-op there).
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_dz = one / dz
        t = oz * inv_dz

    ou = woop12[..., 7] + (
        orig[..., 0] * woop12[..., 4]
        + orig[..., 1] * woop12[..., 5]
        + orig[..., 2] * woop12[..., 6]
    )
    du = (
        dirn[..., 0] * woop12[..., 4]
        + dirn[..., 1] * woop12[..., 5]
        + dirn[..., 2] * woop12[..., 6]
    )
    with np.errstate(invalid="ignore"):
        u = ou + t * du

    ov = woop12[..., 11] + (
        orig[..., 0] * woop12[..., 8]
        + orig[..., 1] * woop12[..., 9]
        + orig[..., 2] * woop12[..., 10]
    )
    dv = (
        dirn[..., 0] * woop12[..., 8]
        + dirn[..., 1] * woop12[..., 9]
        + dirn[..., 2] * woop12[..., 10]
    )
    with np.errstate(invalid="ignore"):
        v = ov + t * dv

    valid = (t > tmin) & (t < tmax) & (u >= 0) & (v >= 0) & (u + v <= one)
    return valid, t, u, v


# Sentinel marking the end of a leaf's triangle run in the flattened woop
# array: m0.x bit pattern 0x80000000 (== -0.0f), as in the reference layout.
LEAF_END_BITS = np.int32(-0x80000000)


def is_leaf_end(ns, woop_m0x):
    """True where a woop record is the 0x80000000 end-of-leaf sentinel."""
    if ns is not np:
        raise TypeError("the port's host copy is numpy only")
    return woop_m0x.view(np.int32) == LEAF_END_BITS if woop_m0x.dtype == np.float32 else woop_m0x == LEAF_END_BITS
