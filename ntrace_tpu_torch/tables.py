"""Packed BVH tables on a torch device.

The counterpart of device-putting a `PackedBVH` in the reference renderer
(renderer.py:642-646). The tables come from `ntrace_tpu.bvh.packed.pack_bvh`
unchanged, so the JAX and torch paths trace the very same bytes, and the
row layout (`tris_per_row`, `nodes_per_row`) is read from the pack, never
assumed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ntrace_tpu_torch.host import NODE_LANES, TRI_LANES, PackedBVH


@dataclass(frozen=True)
class PackedTables:
    nodes8: torch.Tensor   # (NR, 128) float32, contiguous
    tris12: torch.Tensor   # (TR, 128) float32, contiguous
    nodes_per_row: int
    tris_per_row: int
    num_nodes: int

    @property
    def device(self) -> torch.device:
        return self.nodes8.device

    def nbytes(self) -> int:
        return (self.nodes8.numel() + self.tris12.numel()) * 4


def tables_from_packed(packed: PackedBVH, device) -> PackedTables:
    npr, tpr = int(packed.nodes_per_row), int(packed.tris_per_row)
    if not 1 <= npr * NODE_LANES <= 128 or not 1 <= tpr * TRI_LANES <= 128:
        raise ValueError(f"bad packed layout nodes_per_row={npr} "
                         f"tris_per_row={tpr}")

    def put(a):
        a = np.ascontiguousarray(a, dtype=np.float32)
        if a.ndim != 2 or a.shape[1] != 128:
            raise ValueError(f"packed table must be (N, 128), got {a.shape}")
        return torch.from_numpy(a).to(device).contiguous()

    return PackedTables(nodes8=put(packed.nodes8), tris12=put(packed.tris12),
                        nodes_per_row=npr, tris_per_row=tpr,
                        num_nodes=int(packed.num_nodes))
