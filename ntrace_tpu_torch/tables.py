"""Packed BVH tables on a torch device.

`tables_from_packed` is the counterpart of device-putting a host
`PackedBVH` in the reference renderer (renderer.py:642-646). The tables
come from `host.pack_bvh`, the port's copy of the reference's packer, so
the JAX and torch paths trace the very same bytes. `tables_from_device`
wraps tables that are already on the device, as the LBVH build emits them
(bvh/lbvh.py:build_lbvh_packed), with no host round trip. The row layout
(`tris_per_row`, `nodes_per_row`) is read from the build, never assumed.
`tables_from_wide` does the same for the 8-ary tables of
`host.pack_wide_bvh` (the reference renderer's packet_wide engine,
renderer.py:580-589).
"""

from __future__ import annotations

from dataclasses import InitVar, dataclass
from functools import cached_property

import numpy as np
import torch

from ntrace_tpu_torch.host import NODE_LANES, TRI_LANES, PackedBVH


# The packed tables store child links, leaf first rows and triangle ids as
# floats (host/bvh/packed.py), exact only below 2**24; a limit kept from the
# reference.
FLOAT_ID_LIMIT = 2 ** 24


def table_top(nodes8: torch.Tensor, tris12: torch.Tensor, nodes_per_row: int,
              tris_per_row: int, num_nodes: int | None = None) -> torch.Tensor:
    """(2,) float32 on the tables' device: the largest |child link or leaf
    code| of the first num_nodes node records (all records when None) and
    the largest triangle id, the values PackedTables checks."""
    rec = nodes8[:, :nodes_per_row * NODE_LANES].reshape(-1, NODE_LANES)
    enc = rec[:num_nodes, 12:14]
    ids = tris12[:, :tris_per_row * TRI_LANES].reshape(-1, tris_per_row,
                                                        TRI_LANES)
    # A link is enc >= 0, a leaf's first row -enc - 1: |enc| must stay
    # below the limit for either to be exact.
    return torch.stack([
        enc.abs().amax() if enc.numel() else enc.new_zeros(()),
        ids[:, :, 9].amax() if ids.numel() else enc.new_zeros(())])


@dataclass(frozen=True)
class PackedTables:
    """The binary engines' tables on a device. Construction refuses tables
    whose float-coded integers reach FLOAT_ID_LIMIT (a child link, a leaf's
    first triangle row, a triangle id, or the node count), with a
    ValueError that names the limit. `top`, where given, is table_top's
    pair already read on the host; else construction reads it."""
    nodes8: torch.Tensor   # (NR, 128) float32, contiguous
    tris12: torch.Tensor   # (TR, 128) float32, contiguous
    nodes_per_row: int
    tris_per_row: int
    num_nodes: int
    top: InitVar[tuple | None] = None

    def __post_init__(self, top):
        if top is None:
            top = table_top(self.nodes8, self.tris12, self.nodes_per_row,
                            self.tris_per_row, self.num_nodes).tolist()
        link_or_row, tid = top
        for what, v in (("node count", self.num_nodes),
                        ("child link or leaf code", link_or_row),
                        ("triangle id", tid)):
            if v >= FLOAT_ID_LIMIT:
                raise ValueError(
                    f"{what} {v:.0f}: the packed tables code it as a float, "
                    f"exact only below 2**24 = {FLOAT_ID_LIMIT}")

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

    @cached_property
    def max_depth(self) -> int:
        """The depth of the deepest internal node, the root at 0: the
        node-batch kernels' stack bound (trace/packet_batch.py) rests on
        it. Pointer jumping over the parent links, ceil(log2(nodes)) + 1
        rounds, on the tables' device (one host read)."""
        n = self.num_nodes
        if n <= 1:
            return 0
        npr, dev = self.nodes_per_row, self.device
        rec = self.nodes8[:, :npr * NODE_LANES].reshape(-1, NODE_LANES)[:n]
        enc = rec[:, 12:14].to(torch.int64)
        node = torch.arange(n, device=dev)
        anc = node.clone()
        inner = (enc >= 0) & (enc < n)
        anc[enc[inner]] = node[:, None].expand(-1, 2)[inner]
        dist = (anc != node).to(torch.int64)
        for _ in range(int(n - 1).bit_length() + 1):
            dist = dist + dist[anc]
            anc = anc[anc]
        return int(dist.max())


def tree_form(nodes8, nodes_per_row: int = 1, root: int = 0) -> tuple:
    """The tree under node `root` of packed node records (numpy or a
    tensor), free of the nodes' numbering: each node is (the bits of its
    child boxes and count lanes, the form of child 0, of child 1), a leaf
    child ("leaf", its first triangle row). Two tables hold the same tree,
    boxes, leaf runs and traversal codes bit for bit, when their forms
    are equal. Iterative, on the host."""
    if isinstance(nodes8, torch.Tensor):
        nodes8 = nodes8.cpu().numpy()
    rec = np.ascontiguousarray(nodes8[:, :nodes_per_row * NODE_LANES],
                               np.float32).reshape(-1, NODE_LANES)
    bits = rec.view(np.int32)
    enc = rec[:, 12:14].astype(np.int64)
    forms, stack = {}, [root]
    while stack:
        i = stack[-1]
        todo = [int(c) for c in enc[i] if c >= 0 and int(c) not in forms]
        if todo:
            stack.extend(todo)
            continue
        stack.pop()
        kids = tuple(forms[int(c)] if c >= 0 else ("leaf", int(c))
                     for c in enc[i])
        forms[i] = (tuple(bits[i, :12]) + tuple(bits[i, 14:]),) + kids
    return forms[root]


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
                       tris_per_row: int, top=None) -> PackedTables:
    """Tables already on one device (the LBVH build's pnodes / ptris), used
    in place: nothing is copied to the host but the check's `top` where the
    caller has not read it (PackedTables)."""
    _check_layout(nodes_per_row, tris_per_row)
    for t in (pnodes, ptris):
        _check_table(t)
    if pnodes.device != ptris.device:
        raise ValueError(f"pnodes on {pnodes.device}, ptris on "
                         f"{ptris.device}")
    return PackedTables(nodes8=pnodes.contiguous(), tris12=ptris.contiguous(),
                        nodes_per_row=int(nodes_per_row),
                        tris_per_row=int(tris_per_row),
                        num_nodes=int(num_nodes), top=top)


# The wide tables' two limits, kept from the reference
# (host/bvh/wide_packed.py): a leaf item is a float, exact while triangle
# rows stay below 2**19, and it holds at most 32 rows of a leaf.
WIDE_MAX_TRI_ROWS = 2 ** 19
WIDE_MAX_LEAF_ROWS = 32


@dataclass(frozen=True)
class WideTables:
    """The 8-ary tables of host.pack_wide_bvh on a device: nodes_w (NW, 128)
    with child slot k at lanes 16k..16k+6 (bounds, then the work item), and
    the shared triangle-row layout. Construction refuses tables past the
    two limits above, with a ValueError that names the limit."""
    nodes_w: torch.Tensor   # (NW, 128) float32, contiguous
    tris12: torch.Tensor    # (TR, 128) float32, contiguous
    tris_per_row: int
    num_nodes: int

    def __post_init__(self):
        rows = self.tris12.shape[0]
        if rows >= WIDE_MAX_TRI_ROWS:
            raise ValueError(
                f"{rows} triangle rows: the wide leaf item is exact only "
                f"below 2**19 = {WIDE_MAX_TRI_ROWS} rows")
        _check_layout(1, self.tris_per_row)
        for t in (self.nodes_w, self.tris12):
            _check_table(t)
        if self.nodes_w.device != self.tris12.device:
            raise ValueError(f"nodes_w on {self.nodes_w.device}, tris12 on "
                             f"{self.tris12.device}")
        if self.max_leaf_rows > WIDE_MAX_LEAF_ROWS:
            raise ValueError(
                f"a leaf may span {self.max_leaf_rows} triangle rows; the "
                f"wide leaf item holds at most {WIDE_MAX_LEAF_ROWS}")

    @property
    def device(self) -> torch.device:
        return self.nodes_w.device

    def nbytes(self) -> int:
        return (self.nodes_w.numel() + self.tris12.numel()) * 4

    @cached_property
    def max_leaf_rows(self) -> int:
        """The most triangle rows a leaf may span (0 without leaves).

        An item holds rows - 1 clipped to 31, so a leaf whose item says 32
        is measured by where it can end: leaves are packed densely in
        order, so it ends in the row where the next leaf starts or the row
        before (the larger is taken), and the last leaf ends at the last
        row that holds a triangle. Computed once (one host read)."""
        items = self.nodes_w[:self.num_nodes, 6::16].reshape(-1)
        v = (-items[items < 0] - 1).to(torch.int64)
        if not v.numel():
            return 0
        first, rem = v >> 5, v & 31
        clipped = first[rem == 31]
        if not clipped.numel():
            return int(rem.max()) + 1
        tpr = self.tris_per_row
        ids = self.tris12[:, :tpr * TRI_LANES].reshape(-1, tpr, TRI_LANES)
        last = torch.nonzero((ids[:, :, 9] >= 0).any(dim=1)).max()
        starts = torch.unique(first)
        k = torch.searchsorted(starts, clipped, right=True)
        nxt = starts[k.clamp(max=starts.numel() - 1)]
        span = torch.where(k < starts.numel(), nxt - clipped + 1,
                           last - clipped + 1)
        return max(int(rem.max()) + 1, int(span.max()))


def tables_from_wide(wp, device) -> WideTables:
    """Host (numpy) wide tables (host.WidePackedBVH), copied to `device`."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(device).contiguous()

    return WideTables(nodes_w=put(wp.nodes_w), tris12=put(wp.tris12),
                      tris_per_row=int(wp.tris_per_row),
                      num_nodes=int(wp.num_nodes))
