"""Host-side BVH representation shared by every CPU builder.

Arrays-of-struct equivalent of the reference's pointer-based
InnerNode/LeafNode tree (~ rt/bvh/BVH.hpp + BVHNode.hpp, expected paths):

  child (I, 2) int32   children of each internal node; value >= 0 is an
                       internal node index, value < 0 encodes leaf ~value
  child_lo/hi (I,2,3)  child AABBs (stored on the PARENT, as in the
                       flattened 64-byte layout where a node carries both
                       children's bounds)
  leaf_first (L,)      first entry in tri_order for each leaf
  leaf_count (L,)      triangle count of each leaf (>= 1)
  tri_order (K,)       triangle ids in leaf order; K >= num_tris when a
                       spatial-split builder duplicates references

Root is internal node 0. A single-leaf tree is represented with one internal
node whose both children are the same leaf (the flattener handles it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu_torch.host.ops import aabb as aabb_ops


@dataclass
class HostBVH:
    child: np.ndarray      # (I, 2) int32
    child_lo: np.ndarray   # (I, 2, 3) float32
    child_hi: np.ndarray   # (I, 2, 3) float32
    leaf_first: np.ndarray  # (L,) int32
    leaf_count: np.ndarray  # (L,) int32
    tri_order: np.ndarray   # (K,) int32

    @property
    def num_inner(self) -> int:
        return int(self.child.shape[0])

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_first.shape[0])

    def root_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        lo = np.minimum(self.child_lo[0, 0], self.child_lo[0, 1])
        hi = np.maximum(self.child_hi[0, 0], self.child_hi[0, 1])
        return lo, hi

    def sah_cost(self, node_cost: float = 1.0, tri_cost: float = 1.0) -> float:
        """SAH cost of the tree: sum over nodes of area-weighted costs,
        normalized by root area (~ BVHNode::computeSubtreeSahCost)."""
        lo, hi = self.root_bounds()
        root_area = float(aabb_ops.surface_area(np, lo, hi))
        if root_area <= 0:
            return 0.0
        child_area = aabb_ops.surface_area(np, self.child_lo, self.child_hi)  # (I,2)
        is_leaf = self.child < 0
        leaf_ids = np.where(is_leaf, ~self.child, 0)
        counts = self.leaf_count[leaf_ids]
        cost = np.where(is_leaf, tri_cost * counts, node_cost) * child_area
        # Root itself contributes node_cost * root_area.
        return float((cost.sum() + node_cost * root_area) / root_area)

    def validate(self, num_tris: int) -> None:
        I = self.num_inner
        L = self.num_leaves
        inner_refs = self.child[self.child >= 0]
        assert (inner_refs < I).all(), "inner child index out of range"
        leaf_refs = ~self.child[self.child < 0]
        assert (leaf_refs < L).all(), "leaf id out of range"
        assert (self.leaf_count >= 1).all()
        ends = self.leaf_first + self.leaf_count
        assert (ends <= self.tri_order.shape[0]).all()
        assert self.tri_order.min() >= 0 and self.tri_order.max() < num_tris
        # Every internal node except the root is referenced exactly once.
        counts = np.bincount(inner_refs, minlength=I)
        assert counts[0] == 0 and (counts[1:] == 1).all(), "tree is not a tree"
        # Leaves referenced exactly once (except the degenerate 1-leaf tree).
        if I > 1 or L > 1:
            lc = np.bincount(leaf_refs, minlength=L)
            assert (lc == 1).all(), "leaf multiply referenced"
