"""2D Morton bit spreading on torch integer tensors (counterpart of
ntrace_tpu/ops/morton.py:_part1by1, 60-67).

torch has no full uint32 arithmetic, so the spread runs in int64 and every
step is masked to 32 bits: the result equals the reference's uint32 value.
The host-side Morton codes of the bin grid stay numpy (`host.morton2d`).
"""

from __future__ import annotations

import torch


def part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of v with one zero bit between each (int64)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v
