"""Lane-packed BVH layout for the Pallas packet traversal kernel.

The reference's GPU kernels (expected src/rt/kernels/*persistent*.cu,
SURVEY.md SS3.3) fetch 64-byte node records and Woop triangle rows through
the texture cache, one ray per CUDA thread. A TPU has no per-lane gather:
the packet kernel (trace/packet_pallas.py) instead traverses one shared
stack per VPU tile of rays and fetches ONE node / triangle row at a time by
scalar index from a VMEM-resident table, broadcasting it to every lane.

That dictates a layout packed for whole-row (128-lane) fetches:

  nodes8 : (NR, 128) float32 -- 8 nodes per row; node i occupies lanes
           16*(i%8) .. 16*(i%8)+15 of row i//8:
      [ 0] c0.lo.x [ 1] c0.hi.x [ 2] c0.lo.y [ 3] c0.hi.y
      [ 4] c0.lo.z [ 5] c0.hi.z [ 6] c1.lo.x [ 7] c1.hi.x
      [ 8] c1.lo.y [ 9] c1.hi.y [10] c1.lo.z [11] c1.hi.z
      [12] enc0    [13] enc1    [14] cnt0    [15] cnt1
    enc  : float-encoded child link. >= 0: internal node index.
           < 0: leaf; first triangle ROW = -enc - 1.
    cnt  : leaf child -> number of rows the leaf's slot run touches.
           Lane 14 of an internal-internal node instead holds the
           traversal order code: axis*2 + (child0 is on the low side),
           consumed with the packet's direction signs for near-first
           ordering without per-step t reductions.
    Floats represent the integers exactly below 2**24 nodes / slots --
    far beyond the 10M-triangle scenes this targets.

  tris12 : (TR, 128) float32 -- 12 triangles per row; triangle slot j
           occupies lanes 10*j .. 10*j+9:
      [v0.x v0.y v0.z  e1.x e1.y e1.z  e2.x e2.y e2.z  tri_id]
    (Moller-Trumbore operands; empty tail slots have e1 = e2 = 0 so the
    determinant is 0 and the slot can never hit, and tri_id = -1.)
    Leaf runs are packed DENSELY -- rows may straddle leaves; the kernel
    tests whole rows, and testing a neighbouring leaf's real triangles
    is closest-hit/any-hit safe. Lanes 120..127 are unused padding.

Both arrays are padded to a multiple of 8 rows so the kernel may fetch
aligned (8, 128) blocks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu_torch.host.bvh.flatten import FlatBVH

NODE_LANES = 16
NODES_PER_ROW = 8   # default; pack_bvh(nodes_per_row=1) kills the in-kernel roll
TRI_LANES = 10
TRIS_PER_ROW = 12   # default; pack_bvh(tris_per_row=4) kills ~3x of leaf VPU
                    # work when SAH leaves average ~2 triangles


@dataclass
class PackedBVH:
    nodes8: np.ndarray   # (NR, 128) float32, NR % 8 == 0
    tris12: np.ndarray   # (TR, 128) float32, TR % 8 == 0
    num_nodes: int       # real (unpadded) internal node count
    num_tris: int        # triangle references stored (>= scene tris if split)
    nodes_per_row: int = NODES_PER_ROW
    tris_per_row: int = TRIS_PER_ROW

    def nbytes(self) -> int:
        return self.nodes8.nbytes + self.tris12.nbytes


def _decode_leaf_runs(flat: FlatBVH):
    """Leaf woop-row runs of a FlatBVH: (starts, counts) sorted by start."""
    children = flat.nodes[:, 12:14].copy().view(np.int32)
    leaf_enc = children[children < 0]
    starts = np.unique(~leaf_enc)  # unique: the 1-leaf tree aliases children
    sentinels = np.flatnonzero(flat.tri_index < 0)
    ends = sentinels[np.searchsorted(sentinels, starts)]
    return starts.astype(np.int64), (ends - starts).astype(np.int64), children


def pack_tris(flat: FlatBVH, tri_verts: np.ndarray, starts, counts,
              tris_per_row: int, tri_id_map: np.ndarray | None = None):
    """Lane-pack the leaf triangle runs (shared by pack_bvh and the 8-wide
    packer).

    DENSE packing: leaf runs are concatenated with no row alignment, so a
    row may straddle leaves. The kernels test every slot of every row a
    leaf's run touches -- neighbouring leaves' triangles are real scene
    triangles, so extra tests cannot change the closest (or any-) hit.
    This keeps rows ~full: SAH leaves average ~2 triangles, and per-leaf
    row alignment was a 6x VMEM and leaf-VPU-work blowup.

    Returns (tris12, first_slot, leaf_row_span, total_slots).
    """
    tpr = tris_per_row
    total = int(counts.sum())
    first_slot = np.concatenate([[0], np.cumsum(counts)[:-1]])
    last_slot = first_slot + counts - 1
    leaf_rows = last_slot // tpr - first_slot // tpr + 1
    TR = -(-total // tpr)
    # >= 3 spare all-zero rows past the last real one: the kernels' leaf
    # unrolling (trace/packet_pallas.py leaf_unroll<=4) may touch up to 3
    # rows past a run's end; zero rows have det==0 and can never hit.
    TR_pad = max(8, -(-(TR + 3) // 8) * 8)

    # Gather triangle ids leaf-by-leaf (vectorized repeat/cumsum walk).
    cumc = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(cumc, counts)
    src_rows = np.repeat(starts, counts) + within
    ids = flat.tri_index[src_rows].astype(np.int64)
    out_ids = ids if tri_id_map is None else tri_id_map[ids]
    slot = np.arange(total, dtype=np.int64)

    tris = np.zeros((TR_pad * tpr, TRI_LANES), dtype=np.float32)
    tris[:, 9] = -1.0
    v0 = tri_verts[ids, 0]
    tris[slot, 0:3] = v0
    tris[slot, 3:6] = tri_verts[ids, 1] - v0
    tris[slot, 6:9] = tri_verts[ids, 2] - v0
    # The id lane may carry GLOBAL ids (forest chunks) while geometry
    # still indexes the local tri_verts.
    tris[slot, 9] = out_ids.astype(np.float32)
    tris12 = np.zeros((TR_pad, 128), dtype=np.float32)
    tris12[:, : tpr * TRI_LANES] = tris.reshape(TR_pad, -1)
    return tris12, first_slot, leaf_rows, total


def pack_bvh(flat: FlatBVH, tri_verts: np.ndarray, *,
             tris_per_row: int = TRIS_PER_ROW,
             nodes_per_row: int = NODES_PER_ROW,
             tri_id_map: np.ndarray | None = None) -> PackedBVH:
    """Re-lay a FlatBVH into the packet kernel's lane-packed tables.

    tri_verts : (num_scene_tris, 3, 3) float32 original vertices (the woop
    rows cannot be inverted exactly, so Moller-Trumbore operands are rebuilt
    from the scene).

    tris_per_row in {4, 12}: 4 fits SAH's ~2-triangle leaves (a third of the
    per-row Moller-Trumbore VPU work, ~3.2x the tris12 bytes), 12 packs big
    scenes into VMEM. nodes_per_row in {1, 8}: 1 puts each node record at
    lane 0 of its own row (no in-kernel roll, 8x the nodes8 bytes).
    """
    TRIS_PER_ROW = tris_per_row
    NODES_PER_ROW = nodes_per_row
    starts, counts, children = _decode_leaf_runs(flat)
    tris12, first_slot, leaf_rows, total = pack_tris(
        flat, tri_verts, starts, counts, tris_per_row, tri_id_map)

    # Node records: remap leaf children (~woopRow) -> -(firstSlot + 1), and
    # the spanned-row count. Internal-internal nodes carry a traversal
    # order code in the cnt0 lane instead (axis*2 + low-side bit).
    I = flat.nodes.shape[0]
    is_leaf = children < 0
    leaf_woop = np.where(is_leaf, ~children, 0)
    leaf_id = np.searchsorted(starts, leaf_woop)  # starts is sorted unique
    first_row = first_slot // TRIS_PER_ROW  # kernel wants the ROW directly
    enc = np.where(is_leaf, -(first_row[leaf_id] + 1), children).astype(np.float32)
    cnt = np.where(is_leaf, leaf_rows[leaf_id], 0).astype(np.float32)

    both_internal = ~is_leaf[:, 0] & ~is_leaf[:, 1]
    f0 = flat.nodes
    c0_center = np.stack([f0[:, 0] + f0[:, 1], f0[:, 2] + f0[:, 3],
                          f0[:, 8] + f0[:, 9]], axis=1)
    c1_center = np.stack([f0[:, 4] + f0[:, 5], f0[:, 6] + f0[:, 7],
                          f0[:, 10] + f0[:, 11]], axis=1)
    sep = c0_center - c1_center
    axis = np.abs(sep).argmax(axis=1).astype(np.int64)
    low_bit = (sep[np.arange(I), axis] <= 0).astype(np.int64)
    order_code = (axis * 2 + low_bit).astype(np.float32)
    cnt[:, 0] = np.where(both_internal, order_code, cnt[:, 0])

    f = flat.nodes
    rec = np.zeros((I, NODE_LANES), dtype=np.float32)
    # flatten.py lane order: c0 x/y at 0..3, c1 x/y at 4..7, z at 8..11.
    rec[:, 0] = f[:, 0]   # c0.lo.x
    rec[:, 1] = f[:, 1]   # c0.hi.x
    rec[:, 2] = f[:, 2]   # c0.lo.y
    rec[:, 3] = f[:, 3]   # c0.hi.y
    rec[:, 4] = f[:, 8]   # c0.lo.z
    rec[:, 5] = f[:, 9]   # c0.hi.z
    rec[:, 6] = f[:, 4]   # c1.lo.x
    rec[:, 7] = f[:, 5]   # c1.hi.x
    rec[:, 8] = f[:, 6]   # c1.lo.y
    rec[:, 9] = f[:, 7]   # c1.hi.y
    rec[:, 10] = f[:, 10]  # c1.lo.z
    rec[:, 11] = f[:, 11]  # c1.hi.z
    rec[:, 12] = enc[:, 0]
    rec[:, 13] = enc[:, 1]
    rec[:, 14] = cnt[:, 0]
    rec[:, 15] = cnt[:, 1]

    n_rows = -(-I // NODES_PER_ROW)
    NR_pad = max(8, -(-n_rows // 8) * 8)
    padded = np.zeros((NR_pad * NODES_PER_ROW, NODE_LANES), dtype=np.float32)
    padded[:I] = rec
    nodes8 = np.zeros((NR_pad, 128), dtype=np.float32)
    nodes8[:, : NODES_PER_ROW * NODE_LANES] = padded.reshape(NR_pad, -1)

    return PackedBVH(nodes8=nodes8, tris12=tris12, num_nodes=I,
                     num_tris=total, nodes_per_row=NODES_PER_ROW,
                     tris_per_row=TRIS_PER_ROW)


def unpack_node(packed: PackedBVH, i: int):
    """Host-side decode of node i (test helper): (bounds(2,2,3), enc(2), cnt(2))."""
    NODES_PER_ROW = packed.nodes_per_row
    row = packed.nodes8[i // NODES_PER_ROW]
    rec = row[16 * (i % NODES_PER_ROW): 16 * (i % NODES_PER_ROW) + 16]
    b = rec[:12].reshape(2, 3, 2)            # child, axis, lo/hi
    bounds = np.stack([b[:, :, 0], b[:, :, 1]], axis=1)  # (child, lo/hi, axis)
    return bounds, rec[12:14].astype(np.int64), rec[14:16].astype(np.int64)


def unpack_tri_slot(packed: PackedBVH, row: int, j: int):
    """Host-side decode of tri slot j of row (test helper)."""
    lanes = packed.tris12[row, TRI_LANES * j: TRI_LANES * j + TRI_LANES]
    return lanes[0:3], lanes[3:6], lanes[6:9], int(lanes[9])


def pick_layout(n_nodes: int, n_refs: int, budget_bytes: int = 96 << 20,
                avg_leaf: float | None = None):
    """(tris_per_row, nodes_per_row) by leaf fatness + VMEM budget.

    Fat leaves (>= ~6 tris, the engine-tuned SAH cost profile) want 12-tri
    rows: a 48-tri leaf is 4 rows instead of 12, and the leaf row cost is
    load latency, not VPU work. Thin (~2-tri) SAH leaves want 4-tri rows
    (measured in round 2's leaf sweeps, scripts/leaf_sweep*.py). npr=1
    (no in-kernel roll) whenever the node table fits.
    """
    if avg_leaf is not None and avg_leaf >= 6.0:
        prefs = ((12, 1), (12, 8), (4, 8))
    else:
        prefs = ((4, 1), (12, 1), (4, 8), (12, 8))
    for tpr, npr in prefs:
        node_rows = -(-n_nodes // npr)
        tri_rows = -(-n_refs // tpr)
        if (node_rows + tri_rows) * 512 <= budget_bytes:
            return tpr, npr
    return TRIS_PER_ROW, NODES_PER_ROW
