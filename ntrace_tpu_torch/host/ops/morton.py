"""Morton (Z-order) codes: 30-bit 3D for LBVH builds, 2D for pixel tables.

Reference parity: the HLBVH path computes 30-bit Morton codes from triangle
centroids quantized to a 1024^3 grid over the scene AABB (expected
rt/bvh/HLBVH/*, per Pantaleoni-Luebke 2010 / Garanzha 2011; mount empty --
see SURVEY.md SS0). PixelTable uses 2D Morton order so consecutive primary
rays are screen-coherent (expected rt/ray/PixelTable.*).

Implementations are namespace-generic (numpy or jax.numpy) and integer-exact.
"""

from __future__ import annotations

import numpy as np


def _expand_bits_3d(ns, v):
    """Spread the low 10 bits of v so there are 2 zero bits between each.

    Classic magic-number sequence (public domain bit trick, also used by the
    reference's Morton kernels).
    """
    v = v.astype(np.uint32) if ns is np else v.astype("uint32")
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(ns, x, y, z):
    """Interleave three 10-bit ints -> 30-bit Morton code (int32).

    Bit layout: code = x_i<<(3i+2) | y_i<<(3i+1) | z_i<<(3i), i.e. x is the
    most significant axis, matching the common LBVH convention.
    """
    xe = _expand_bits_3d(ns, x)
    ye = _expand_bits_3d(ns, y)
    ze = _expand_bits_3d(ns, z)
    code = (xe << np.uint32(2)) | (ye << np.uint32(1)) | ze
    return code.astype(np.int32) if ns is np else code.astype("int32")


def quantize_points(ns, pts, lo, hi, bits=10):
    """Quantize (N,3) points to integer grid coords in [0, 2^bits - 1]."""
    scale = np.float32(float((1 << bits) - 1))
    ext = ns.maximum(hi - lo, np.float32(1e-30))
    t = (pts - lo) / ext
    t = ns.clip(t, np.float32(0.0), np.float32(1.0))
    q = (t * scale).astype("int32" if ns is not np else np.int32)
    return q


def morton_codes_3d(ns, pts, lo, hi):
    """(N,3) float32 points + scene AABB -> (N,) int32 30-bit Morton codes."""
    q = quantize_points(ns, pts, lo, hi, bits=10)
    return morton3d(ns, q[..., 0], q[..., 1], q[..., 2])


def _part1by1(ns, v):
    """Spread low 16 bits of v with 1 zero bit between each (2D Morton)."""
    v = v.astype(np.uint32) if ns is np else v.astype("uint32")
    v = (v | (v << np.uint32(8))) & np.uint32(0x00FF00FF)
    v = (v | (v << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    v = (v | (v << np.uint32(2))) & np.uint32(0x33333333)
    v = (v | (v << np.uint32(1))) & np.uint32(0x55555555)
    return v


def morton2d(ns, x, y):
    """Interleave two 16-bit ints -> 32-bit 2D Morton code (y high bits)."""
    code = (_part1by1(ns, y) << np.uint32(1)) | _part1by1(ns, x)
    return code.astype(np.int64) if ns is np else code.astype("int64")


def morton3d_ref_scalar(x: int, y: int, z: int) -> int:
    """Bit-by-bit scalar reference for tests (independent formulation)."""
    code = 0
    for i in range(10):
        code |= ((x >> i) & 1) << (3 * i + 2)
        code |= ((y >> i) & 1) << (3 * i + 1)
        code |= ((z >> i) & 1) << (3 * i)
    return code


def morton2d_ref_scalar(x: int, y: int) -> int:
    code = 0
    for i in range(16):
        code |= ((x >> i) & 1) << (2 * i)
        code |= ((y >> i) & 1) << (2 * i + 1)
    return code
