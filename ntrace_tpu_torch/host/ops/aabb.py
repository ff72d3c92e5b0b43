"""AABB helpers and the ray/slab test used by every traversal engine.

The slab test reproduces the reference kernels' formulation (expected
src/rt/kernels/CudaTracerKernels.hpp + fermi_speculative_while_while.cu; see
SURVEY.md SS3.3): per-child t-spans computed as (plane - origin) * inv_dir,
span begin/end via NaN-suppressing min/max (CUDA fminf/fmaxf semantics ==
numpy/jax fmin/fmax), child hit iff max(tmin_span, ray_tmin) <=
min(tmax_span, ray_tmax).

Namespace-generic: pass `ns` = numpy or jax.numpy so the golden tracer and
the TPU engines share one formulation bit-for-bit.
"""

from __future__ import annotations

import numpy as np


def surface_area(ns, lo, hi):
    """Full surface area 2*(xy+yz+zx) of AABBs.

    lo, hi: (..., 3). Degenerate (inverted) boxes yield 0.
    """
    d = ns.maximum(hi - lo, np.float32(0.0))
    return np.float32(2.0) * (
        d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]
    )


def union(ns, lo_a, hi_a, lo_b, hi_b):
    return ns.minimum(lo_a, lo_b), ns.maximum(hi_a, hi_b)


def safe_inv_dir(ns, d):
    """1/dir with the reference's epsilon guard against +-0 components.

    The Aila-Laine kernels compute ooeps = exp2(-80) and use
    1 / (fabs(d) > ooeps ? d : copysign(ooeps, d)) so inv_dir stays finite.
    """
    ooeps = np.float32(np.exp2(-80.0))
    mag = ns.abs(d)
    guarded = ns.where(mag > ooeps, d, ns.where(d >= 0, ooeps, -ooeps))
    return np.float32(1.0) / guarded


def slab_test(ns, lo, hi, orig, inv_dir, tmin, tmax):
    """Ray vs AABB slab test.

    lo, hi      : (..., 3) box corners
    orig        : (..., 3) ray origin (broadcastable)
    inv_dir     : (..., 3) reciprocal direction (see safe_inv_dir)
    tmin, tmax  : (...) current ray interval

    Returns (hit, span_begin) with span_begin = entry distance clamped to
    tmin (the traversal's near-child ordering key).
    """
    t0 = (lo - orig) * inv_dir
    t1 = (hi - orig) * inv_dir
    near = ns.fmin(t0, t1)
    far = ns.fmax(t0, t1)
    span_begin = ns.fmax(ns.fmax(near[..., 0], near[..., 1]), ns.fmax(near[..., 2], tmin))
    span_end = ns.fmin(ns.fmin(far[..., 0], far[..., 1]), ns.fmin(far[..., 2], tmax))
    return span_begin <= span_end, span_begin


def node_slab_test_2(ns, node16, orig, inv_dir, tmin, tmax):
    """Slab-test BOTH children of a flattened 64-byte node record.

    node16 : (..., 16) float32 = the 4xfloat4 node layout of SURVEY.md SS3.3:
       [ c0lo.x c0hi.x c0lo.y c0hi.y | c1lo.x c1hi.x c1lo.y c1hi.y |
         c0lo.z c0hi.z c1lo.z c1hi.z | bits(c0idx) bits(c1idx) pad pad ]
    orig/inv_dir : (..., 3); tmin/tmax : (...)

    Returns (hit0, hit1, t0, t1): per-child hit flags and entry distances.
    Formulation matches the reference kernel: per-axis (plane-o)*idir then
    NaN-suppressing min/max reduction.
    """
    ox, oy, oz = orig[..., 0], orig[..., 1], orig[..., 2]
    ix, iy, iz = inv_dir[..., 0], inv_dir[..., 1], inv_dir[..., 2]

    c0lox = (node16[..., 0] - ox) * ix
    c0hix = (node16[..., 1] - ox) * ix
    c0loy = (node16[..., 2] - oy) * iy
    c0hiy = (node16[..., 3] - oy) * iy
    c0loz = (node16[..., 8] - oz) * iz
    c0hiz = (node16[..., 9] - oz) * iz

    c1lox = (node16[..., 4] - ox) * ix
    c1hix = (node16[..., 5] - ox) * ix
    c1loy = (node16[..., 6] - oy) * iy
    c1hiy = (node16[..., 7] - oy) * iy
    c1loz = (node16[..., 10] - oz) * iz
    c1hiz = (node16[..., 11] - oz) * iz

    t0_begin = ns.fmax(
        ns.fmax(ns.fmin(c0lox, c0hix), ns.fmin(c0loy, c0hiy)),
        ns.fmax(ns.fmin(c0loz, c0hiz), tmin),
    )
    t0_end = ns.fmin(
        ns.fmin(ns.fmax(c0lox, c0hix), ns.fmax(c0loy, c0hiy)),
        ns.fmin(ns.fmax(c0loz, c0hiz), tmax),
    )
    t1_begin = ns.fmax(
        ns.fmax(ns.fmin(c1lox, c1hix), ns.fmin(c1loy, c1hiy)),
        ns.fmax(ns.fmin(c1loz, c1hiz), tmin),
    )
    t1_end = ns.fmin(
        ns.fmin(ns.fmax(c1lox, c1hix), ns.fmax(c1loy, c1hiy)),
        ns.fmin(ns.fmax(c1loz, c1hiz), tmax),
    )
    return t0_begin <= t0_end, t1_begin <= t1_end, t0_begin, t1_begin


def tri_aabbs(ns, tri_verts):
    """(M,3,3) triangle vertices -> ((M,3) lo, (M,3) hi)."""
    return tri_verts.min(axis=1), tri_verts.max(axis=1)
