"""Morton codes and bit helpers on torch integer tensors (counterpart of
ntrace_tpu/ops/morton.py: `_part1by1` 60-67, `_expand_bits_3d` 17-28,
`morton3d` 31-42, `quantize_points` 44-51, `morton_codes_3d` 54-57).

torch has no full uint32 arithmetic, so the bit spreads run in int64 and
every step is masked to 32 bits: the result equals the reference's uint32
value, and the 30-bit 3-D codes are bit-equal to the numpy and jnp ones.
`clz32` is `jax.lax.clz` on int32, computed exactly by a binary search on
the bits (a float log2 rounds up just below powers of two).
The host-side Morton codes of the bin grid stay numpy (`host.morton2d`).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of v with one zero bit between each (int64)."""
    v = v.to(torch.int64) & _M32
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def expand_bits_3d(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v with two zero bits between each (int64);
    the reference's uint32 multiply-and-mask sequence, wrapped to 32 bits."""
    v = v.to(torch.int64) & _M32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Interleave three 10-bit ints into a 30-bit Morton code (int32), x the
    most significant axis."""
    code = ((expand_bits_3d(x) << 2) | (expand_bits_3d(y) << 1)
            | expand_bits_3d(z))
    return code.to(torch.int32)


def quantize_points(pts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    bits: int = 10) -> torch.Tensor:
    """Quantize (N, 3) float32 points to int32 grid coords in
    [0, 2^bits - 1], with the reference's float32 op order."""
    scale = float(np.float32((1 << bits) - 1))
    ext = torch.clamp(hi - lo, min=float(np.float32(1e-30)))
    t = torch.clamp((pts - lo) / ext, 0.0, 1.0)
    return (t * scale).to(torch.int32)


def morton_codes_3d(pts: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """(N, 3) float32 points and the scene AABB -> (N,) int32 30-bit codes."""
    q = quantize_points(pts, lo, hi, bits=10)
    return morton3d(q[..., 0], q[..., 1], q[..., 2])


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of each int32's 32-bit pattern (int32, 32 for 0),
    equal to jax.lax.clz."""
    v = x.to(torch.int64) & _M32
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        top_clear = v < (1 << (32 - s))
        n = n + top_clear.to(torch.int64) * s
        v = torch.where(top_clear, v << s, v)
    return (n + (v == 0).to(torch.int64)).to(torch.int32)
