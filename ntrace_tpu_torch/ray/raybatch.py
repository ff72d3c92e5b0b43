"""RayBatch on torch tensors and the Morton re-sort of secondary rays
(counterpart of ntrace_tpu/ray/raybatch.py: `_direction_octant` 44-50,
`morton_sort_key` 53-86, `morton_sort_rays` 89-112, `unsort` 115-124).
`sort_by_key` is the sort's shared half: morton_sort_rays computes the key
in torch, raygen.secondary_rays takes it from its kernel.

The sort keys are int32 and bit-equal to the reference's; the sort is
stable, as `jnp.argsort` is, so equal keys keep their order and the
permutation is the reference's. Dead rays (tmax <= tmin) take the key
0x7FFFFFFF and so sort last.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ntrace_tpu_torch.ops.morton import morton_codes_3d

DEAD_KEY = 0x7FFFFFFF


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


def _direction_octant(dirn: torch.Tensor) -> torch.Tensor:
    """3-bit direction octant code (sign bits of x, y, z), int32."""
    return ((dirn[:, 0] < 0).to(torch.int32) * 4
            + (dirn[:, 1] < 0).to(torch.int32) * 2
            + (dirn[:, 2] < 0).to(torch.int32))


def morton_sort_key(orig: torch.Tensor, dirn: torch.Tensor,
                    scene_lo: torch.Tensor, scene_hi: torch.Tensor,
                    direction_major: bool = True) -> torch.Tensor:
    """Coherence sort key (int32). direction_major=True: a 6-bit direction
    code (2 bits per axis, interleaved) above the origin's Morton code, for
    long bounce rays; False: the origin's Morton code with the direction
    octant in the low 3 bits, for short (AO) rays."""
    oc = morton_codes_3d(orig, scene_lo, scene_hi)
    if not direction_major:
        return (oc & ~7) | _direction_octant(dirn)
    norm = torch.sqrt(dirn[:, 0] * dirn[:, 0] + dirn[:, 1] * dirn[:, 1]
                      + dirn[:, 2] * dirn[:, 2])[:, None]
    unit = dirn / torch.clamp_min(norm, 1e-30)
    n2 = ((unit + 1.0) * 2.0).to(torch.int32).clamp(0, 3)
    dir6 = torch.zeros_like(oc)
    for b in range(2):
        dir6 = (dir6
                | ((n2[:, 0] >> b) & 1) << (3 * b + 2)
                | ((n2[:, 1] >> b) & 1) << (3 * b + 1)
                | ((n2[:, 2] >> b) & 1) << (3 * b + 0))
    return (dir6 << 25) | (oc >> 5)


def sort_by_key(batch: RayBatch, key: torch.Tensor) -> RayBatch:
    """A new RayBatch in the stable order of `key`, with slot_to_id carried
    along (the order itself where the batch has none: its ids are its
    slots). Rows are gathered by index_select: on an H100 the sort of a
    3,145,728-ray diffuse batch took 0.47 ms so, 0.70 ms through
    `tensor[order]`."""
    order = torch.argsort(key, stable=True)
    ids = (order.to(torch.int32) if batch.slot_to_id is None
           else batch.slot_to_id.index_select(0, order))
    return RayBatch(orig=batch.orig.index_select(0, order),
                    dirn=batch.dirn.index_select(0, order),
                    tmin=batch.tmin.index_select(0, order),
                    tmax=batch.tmax.index_select(0, order), slot_to_id=ids)


def morton_sort_rays(batch: RayBatch, scene_lo: torch.Tensor,
                     scene_hi: torch.Tensor,
                     direction_major: bool = True) -> RayBatch:
    """A new RayBatch sorted for coherence, dead rays last, with slot_to_id
    carried along."""
    key = morton_sort_key(batch.orig, batch.dirn, scene_lo, scene_hi,
                          direction_major=direction_major)
    key = torch.where(batch.tmax <= batch.tmin, DEAD_KEY, key)
    return sort_by_key(batch, key)


def unsort(values: torch.Tensor, slot_to_id: torch.Tensor) -> torch.Tensor:
    """Scatter per-slot values, (R,) or (R, k), back to ray-id order."""
    out = torch.empty_like(values)
    out[slot_to_id.long()] = values
    return out
