"""RayBatch on torch tensors (counterpart of ntrace_tpu/ray/raybatch.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RayBatch:
    orig: torch.Tensor                 # (R, 3) f32
    dirn: torch.Tensor                 # (R, 3) f32
    tmin: torch.Tensor                 # (R,) f32
    tmax: torch.Tensor                 # (R,) f32
    slot_to_id: torch.Tensor | None = None  # (R,) i32: ray id of each slot

    @property
    def num_rays(self) -> int:
        return int(self.orig.shape[0])


def unsort(values: torch.Tensor, slot_to_id: torch.Tensor) -> torch.Tensor:
    """Scatter per-slot values back to ray-id order."""
    out = torch.empty_like(values)
    out[slot_to_id.long()] = values
    return out
