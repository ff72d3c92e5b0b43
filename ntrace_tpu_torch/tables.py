"""Packed BVH tables on a torch device.

`tables_from_packed` is the counterpart of device-putting a host
`PackedBVH` in the reference renderer (renderer.py:642-646). The tables
come from `host.pack_bvh`, the port's copy of the reference's packer, so
the JAX and torch paths trace the very same bytes. `tables_from_device`
wraps tables that are already on the device, as the LBVH build emits them
(bvh/lbvh.py:build_lbvh_packed), with no host round trip. The row layout
(`tris_per_row`, `nodes_per_row`) is read from the build, never assumed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

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

    @cached_property
    def max_leaf_rows(self) -> int:
        """The most triangle rows one leaf spans (0 without leaves): the
        leaf-run encodings of packet_ww and packet_ifif hold at most 32.
        Computed once, on the tables' device (one host read)."""
        npr = self.nodes_per_row
        rec = self.nodes8[:, :npr * NODE_LANES].reshape(-1, NODE_LANES)
        rec = rec[:self.num_nodes]
        cnt = torch.where(rec[:, 12:14] < 0, rec[:, 14:16], 0.0)
        return int(cnt.max()) if cnt.numel() else 0


def _check_layout(npr: int, tpr: int):
    if not 1 <= npr * NODE_LANES <= 128 or not 1 <= tpr * TRI_LANES <= 128:
        raise ValueError(f"bad packed layout nodes_per_row={npr} "
                         f"tris_per_row={tpr}")


def _check_table(t: torch.Tensor):
    if t.dim() != 2 or t.shape[1] != 128 or t.dtype != torch.float32:
        raise ValueError(f"packed table must be (N, 128) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def tables_from_packed(packed: PackedBVH, device) -> PackedTables:
    """Host (numpy) packed tables, copied to `device`."""
    npr, tpr = int(packed.nodes_per_row), int(packed.tris_per_row)
    _check_layout(npr, tpr)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        _check_table(t)
        return t.to(device).contiguous()

    return PackedTables(nodes8=put(packed.nodes8), tris12=put(packed.tris12),
                        nodes_per_row=npr, tris_per_row=tpr,
                        num_nodes=int(packed.num_nodes))


def tables_from_device(pnodes: torch.Tensor, ptris: torch.Tensor,
                       num_nodes: int, nodes_per_row: int,
                       tris_per_row: int) -> PackedTables:
    """Tables already on one device (the LBVH build's pnodes / ptris), used
    in place: nothing is copied to the host."""
    _check_layout(nodes_per_row, tris_per_row)
    for t in (pnodes, ptris):
        _check_table(t)
    if pnodes.device != ptris.device:
        raise ValueError(f"pnodes on {pnodes.device}, ptris on "
                         f"{ptris.device}")
    return PackedTables(nodes8=pnodes.contiguous(), tris12=ptris.contiguous(),
                        nodes_per_row=int(nodes_per_row),
                        tris_per_row=int(tris_per_row),
                        num_nodes=int(num_nodes))
