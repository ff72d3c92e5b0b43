"""Ray helpers on torch tensors (counterpart of ntrace_tpu/ops/aabb.py)."""

from __future__ import annotations

import numpy as np
import torch

OOEPS = float(np.exp2(np.float32(-80.0)))   # exactly 2^-80 in float32


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/dir with the Aila-Laine guard: 1 / (|d| > 2^-80 ? d : ±2^-80),
    one float32 division, bit-equal to ops/aabb.py safe_inv_dir(np, d)."""
    eps = torch.full_like(d, OOEPS)
    guarded = torch.where(d.abs() > eps, d, torch.where(d >= 0, eps, -eps))
    return torch.ones_like(d) / guarded
