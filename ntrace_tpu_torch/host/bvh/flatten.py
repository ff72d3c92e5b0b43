"""Flatten a HostBVH to the reference's GPU memory layout (vectorized).

Layout contract (SURVEY.md SS3.3, ~ rt/cuda/CudaBVH.cpp; the north star
demands the same flattened node/woop-triangle layout semantics):

  nodes : (N, 16) float32, one 64-byte record per internal node:
     [ 0] c0.lo.x  [ 1] c0.hi.x  [ 2] c0.lo.y  [ 3] c0.hi.y
     [ 4] c1.lo.x  [ 5] c1.hi.x  [ 6] c1.lo.y  [ 7] c1.hi.y
     [ 8] c0.lo.z  [ 9] c0.hi.z  [10] c1.lo.z  [11] c1.hi.z
     [12] bits(int c0.idx)  [13] bits(int c1.idx)  [14] pad  [15] pad
  child index >= 0  -> internal node slot (we use SLOT index; the reference
     uses a 64-byte BYTE offset -- same information, documented deviation)
  child index <  0  -> ~woopOffset: first row of the leaf's triangle run in
     the woop array
  woop  : (W, 12) float32 rows m0|m1|m2 per triangle (ops/woop.py); each
     leaf's run is terminated by a sentinel row whose m0.x has bit pattern
     0x80000000 (-0.0f), exactly like the reference
  tri_index : (W,) int32 original triangle id per woop row (-1 on sentinels)

Real (non-sentinel) woop rows are canonicalized so m0.x is never -0.0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu_torch.host.bvh.host_bvh import HostBVH
from ntrace_tpu_torch.host.core import Scene
from ntrace_tpu_torch.host.ops.woop import woopify


@dataclass
class FlatBVH:
    nodes: np.ndarray      # (N, 16) float32 (lanes 12/13 carry int32 bits)
    woop: np.ndarray       # (W, 12) float32
    tri_index: np.ndarray  # (W,) int32
    # Auxiliary (host-only metadata; not part of the layout contract):
    num_tris: int = 0
    sah_cost: float = 0.0

    def nbytes(self) -> int:
        return self.nodes.nbytes + self.woop.nbytes + self.tri_index.nbytes


def _leaf_rows(leaf_first, leaf_count, tri_order):
    """Vectorized woop-row placement for all leaves.

    Returns (ordered_tris, dst_rows, sentinel_rows, total_rows):
      ordered_tris : tri ids grouped leaf-by-leaf in leaf-id order
      dst_rows     : destination woop row of each ordered tri
      sentinel_rows: woop row of each leaf's terminator
    """
    counts = leaf_count.astype(np.int64)
    total = int(counts.sum())
    new_first = np.zeros_like(counts)
    np.cumsum(counts + 1, out=new_first)
    new_first = np.concatenate([[0], new_first[:-1]])
    cumc = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(cumc, counts)
    src_idx = np.repeat(leaf_first.astype(np.int64), counts) + within
    ordered_tris = tri_order[src_idx]
    dst_rows = np.repeat(new_first, counts) + within
    sentinel_rows = new_first + counts
    return ordered_tris, dst_rows, sentinel_rows, total + len(counts)


def flatten_bvh(bvh: HostBVH, scene: Scene) -> FlatBVH:
    I = bvh.num_inner

    # --- woop array with per-leaf sentinel terminators -------------------
    ordered_tris, dst_rows, sentinel_rows, W = _leaf_rows(
        bvh.leaf_first, bvh.leaf_count, bvh.tri_order
    )
    tv = scene.tri_verts()[ordered_tris]
    w = woopify(tv)
    w[:, 0] += np.float32(0.0)  # -0.0 -> +0.0: m0.x never aliases the sentinel

    woop = np.zeros((W, 12), dtype=np.float32)
    woop[dst_rows] = w
    sent = np.zeros((12,), dtype=np.float32)
    sent[0] = np.int32(-0x80000000).view(np.float32)  # 0x80000000 bits
    woop[sentinel_rows] = sent

    tri_index = np.full((W,), -1, dtype=np.int32)
    tri_index[dst_rows] = ordered_tris.astype(np.int32)

    # --- node records ----------------------------------------------------
    # Leaf woop offsets per leaf id:
    counts = bvh.leaf_count.astype(np.int64)
    new_first = np.concatenate([[0], np.cumsum(counts + 1)[:-1]]).astype(np.int64)

    child = bvh.child  # (I, 2) int32
    is_leaf = child < 0
    leaf_ids = np.where(is_leaf, ~child, 0)
    enc = np.where(is_leaf, ~(new_first[leaf_ids].astype(np.int32)), child)

    nodes = np.zeros((I, 16), dtype=np.float32)
    lo = bvh.child_lo  # (I,2,3)
    hi = bvh.child_hi
    nodes[:, 0] = lo[:, 0, 0]
    nodes[:, 1] = hi[:, 0, 0]
    nodes[:, 2] = lo[:, 0, 1]
    nodes[:, 3] = hi[:, 0, 1]
    nodes[:, 4] = lo[:, 1, 0]
    nodes[:, 5] = hi[:, 1, 0]
    nodes[:, 6] = lo[:, 1, 1]
    nodes[:, 7] = hi[:, 1, 1]
    nodes[:, 8] = lo[:, 0, 2]
    nodes[:, 9] = hi[:, 0, 2]
    nodes[:, 10] = lo[:, 1, 2]
    nodes[:, 11] = hi[:, 1, 2]
    nodes[:, 12] = enc[:, 0].astype(np.int32).view(np.float32)
    nodes[:, 13] = enc[:, 1].astype(np.int32).view(np.float32)

    return FlatBVH(
        nodes=nodes,
        woop=woop,
        tri_index=tri_index,
        num_tris=scene.num_tris,
        sah_cost=bvh.sah_cost(),
    )


def flat_children(flat: FlatBVH) -> np.ndarray:
    """(N, 2) int32 decoded child fields (host-side helper for tests)."""
    return flat.nodes[:, 12:14].view(np.int32).copy()
