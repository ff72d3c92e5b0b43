"""Median-split BVH builder -- the golden-reference tree.

BASELINE.json config #1 mandates a "CPU median-split BVH + CPU traversal
golden reference". This builder is deliberately simple and deterministic:
split the centroid bounds' largest axis at the triangle-count median,
recurse, make a leaf at <= max_leaf_size triangles. Triangle ids inside each
leaf are stored ascending so the closest-hit tie-break (lowest tri index)
falls out of scan order.
"""

from __future__ import annotations

import sys

import numpy as np

from ntrace_tpu_torch.host.core import BuildConfig, Scene
from ntrace_tpu_torch.host.bvh.host_bvh import HostBVH


def build_median_bvh(scene: Scene, config: BuildConfig = BuildConfig()) -> HostBVH:
    tv = scene.tri_verts()
    tlo = tv.min(axis=1)
    thi = tv.max(axis=1)
    cent = ((tlo + thi) * np.float32(0.5)).astype(np.float32)

    child_rows: list[list[int]] = []
    child_lo_rows: list[np.ndarray] = []
    child_hi_rows: list[np.ndarray] = []
    leaf_first: list[int] = []
    leaf_count: list[int] = []
    tri_order_parts: list[np.ndarray] = []
    order_pos = 0

    def make_leaf(ids: np.ndarray) -> int:
        nonlocal order_pos
        leaf_first.append(order_pos)
        leaf_count.append(len(ids))
        tri_order_parts.append(np.sort(ids).astype(np.int32))
        order_pos += len(ids)
        return ~(len(leaf_first) - 1)

    def bounds_of(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return tlo[ids].min(axis=0), thi[ids].max(axis=0)

    sys.setrecursionlimit(10000)

    def build(ids: np.ndarray, depth: int) -> int:
        if len(ids) <= config.max_leaf_size or depth >= config.max_depth:
            return make_leaf(ids)
        c = cent[ids]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        axis = int(np.argmax(chi - clo))
        k = len(ids) // 2
        if chi[axis] == clo[axis]:
            ids_sorted = np.sort(ids)  # identical centroids: arbitrary but stable
            left_ids, right_ids = ids_sorted[:k], ids_sorted[k:]
        else:
            part = np.argpartition(c[:, axis], k)
            left_ids, right_ids = ids[part[:k]], ids[part[k:]]
        node = len(child_rows)
        child_rows.append([0, 0])
        child_lo_rows.append(np.zeros((2, 3), np.float32))
        child_hi_rows.append(np.zeros((2, 3), np.float32))
        c0 = build(left_ids, depth + 1)
        c1 = build(right_ids, depth + 1)
        child_rows[node] = [c0, c1]
        lo0, hi0 = bounds_of(left_ids)
        lo1, hi1 = bounds_of(right_ids)
        child_lo_rows[node] = np.stack([lo0, lo1])
        child_hi_rows[node] = np.stack([hi0, hi1])
        return node

    all_ids = np.arange(scene.num_tris, dtype=np.int64)
    if scene.num_tris == 1:
        # Degenerate scene: one internal node pointing at the same leaf twice
        # is avoided -- emit two single-triangle leaves over the same tri.
        l0 = make_leaf(all_ids)
        l1 = make_leaf(all_ids)
        child_rows.append([l0, l1])
        lo, hi = bounds_of(all_ids)
        child_lo_rows.append(np.stack([lo, lo]))
        child_hi_rows.append(np.stack([hi, hi]))
    else:
        # Force at least one split so the root is always an internal node.
        saved = config.max_leaf_size
        if scene.num_tris <= saved:
            c = cent
            k = scene.num_tris // 2
            order = np.argsort(c[:, int(np.argmax(c.max(0) - c.min(0)))], kind="stable")
            node = len(child_rows)
            child_rows.append([0, 0])
            child_lo_rows.append(np.zeros((2, 3), np.float32))
            child_hi_rows.append(np.zeros((2, 3), np.float32))
            c0 = make_leaf(all_ids[order[:k]])
            c1 = make_leaf(all_ids[order[k:]])
            child_rows[node] = [c0, c1]
            lo0, hi0 = bounds_of(all_ids[order[:k]])
            lo1, hi1 = bounds_of(all_ids[order[k:]])
            child_lo_rows[node] = np.stack([lo0, lo1])
            child_hi_rows[node] = np.stack([hi0, hi1])
        else:
            build(all_ids, 0)

    return HostBVH(
        child=np.asarray(child_rows, dtype=np.int32),
        child_lo=np.stack(child_lo_rows).astype(np.float32),
        child_hi=np.stack(child_hi_rows).astype(np.float32),
        leaf_first=np.asarray(leaf_first, dtype=np.int32),
        leaf_count=np.asarray(leaf_count, dtype=np.int32),
        tri_order=np.concatenate(tri_order_parts).astype(np.int32),
    )
