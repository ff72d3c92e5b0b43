"""HLBVH: an SAH top tree over Morton clusters, LBVH treelets below it.

Counterpart of ntrace_tpu/bvh/hlbvh.py:38 `build_hlbvh_flat`, the HLBVH
builder (Pantaleoni and Luebke 2010, Garanzha et al. 2011) that Vinkler's
NTrace added beside LBVH:
  1. the radix-trie sweep of bvh/lbvh.py:lbvh_device runs in forest mode
     on the device (cluster_shift = 30 - hlbvh_top_bits): rows whose top
     Morton bits differ root separate treelets, and the sweep reports each
     cluster's root in the final child encoding;
  2. the cluster boxes, segment min/max over the Morton-sorted triangle
     boxes, feed the host binned-SAH builder with one cluster a leaf
     (host/bvh/sbvh.py:build_sah_over_boxes);
  3. the splice: the top nodes come first (the root stays node 0), the
     treelet nodes follow with their internal links shifted, and each top
     leaf becomes its cluster's root. The Woop rows and triangle ids come
     from the device build unchanged.
Three cases take the plain LBVH build (bvh/lbvh.py:build_lbvh_flat), as in
the reference: fewer than 2 triangles; fewer than 2 clusters or no
internal node; a top leaf that holds more than one box (the splice reads
one cluster a leaf).
"""

from __future__ import annotations

import numpy as np

from ntrace_tpu_torch.bvh.lbvh import (build_lbvh_flat, device_inputs,
                                       lbvh_device)
from ntrace_tpu_torch.host import BuildConfig, FlatBVH, Scene
from ntrace_tpu_torch.host.bvh.sbvh import build_sah_over_boxes


def cluster_shift(cfg: BuildConfig) -> int:
    """The forest sweep's cluster_shift: the Morton bits below the top
    hlbvh_top_bits (at least 3)."""
    return max(30 - cfg.hlbvh_top_bits, 3)


def forest_sweep(scene: Scene, cfg: BuildConfig, device) -> dict:
    """The device half of the build: lbvh_device in forest mode on
    `device`; its dict stays on the device."""
    return lbvh_device(*device_inputs(scene, device),
                       max_leaf=cfg.max_leaf_size,
                       cluster_shift=cluster_shift(cfg))


def splice_forest(scene: Scene, cfg: BuildConfig, out: dict
                  ) -> FlatBVH | None:
    """The host half: cluster boxes, the SAH top tree and the splice of the
    forest `out` (forest_sweep's dict). None where the reference falls back
    to the plain LBVH: fewer than 2 clusters, no internal node, or a top
    leaf with more than one box."""
    n_clusters = int(out["n_clusters"])
    node_count = int(out["node_count"])
    if n_clusters < 2 or node_count == 0:
        return None
    order = out["order"].cpu().numpy()
    cluster_ids = out["cluster_ids"].cpu().numpy()
    croots = out["cluster_roots"][:n_clusters].cpu().numpy()

    # Cluster boxes: segment min/max over the Morton-sorted triangle boxes.
    tv = scene.tri_verts()
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], cluster_ids])))
    clo = np.minimum.reduceat(tv.min(axis=1)[order], starts, axis=0)
    chi = np.maximum.reduceat(tv.max(axis=1)[order], starts, axis=0)

    top = build_sah_over_boxes(clo, chi, cfg)
    if (top.leaf_count != 1).any():
        return None
    T = top.num_inner

    # Treelet nodes: internal child links shift by the T top nodes.
    bot = out["nodes"][:node_count].cpu().numpy().copy()
    for lane in (12, 13):
        c = bot[:, lane:lane + 1].view(np.int32)
        c[c >= 0] += T

    # Top nodes in the flat layout; each leaf becomes its cluster's root.
    top_nodes = np.zeros((T, 16), dtype=np.float32)
    tl, th = top.child_lo, top.child_hi   # (T, 2, 3)
    for lane, (child, axis) in enumerate(
            [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (1, 2)]):
        top_nodes[:, 2 * lane] = tl[:, child, axis]
        top_nodes[:, 2 * lane + 1] = th[:, child, axis]
    enc = np.empty((T, 2), dtype=np.int32)
    for c in range(2):
        ref = top.child[:, c]
        is_leaf = ref < 0
        leaf_ids = np.where(is_leaf, ~ref, 0)
        croot = croots[top.tri_order[top.leaf_first[leaf_ids]]]
        enc[:, c] = np.where(is_leaf,
                             np.where(croot >= 0, croot + T, croot), ref)
    top_nodes[:, 12] = enc[:, 0].view(np.float32)
    top_nodes[:, 13] = enc[:, 1].view(np.float32)

    w_used = scene.num_tris + int(out["leaf_count"])
    return FlatBVH(nodes=np.concatenate([top_nodes, bot]),
                   woop=out["woop"][:w_used].cpu().numpy(),
                   tri_index=out["tri_index"][:w_used].cpu().numpy(),
                   num_tris=scene.num_tris, sah_cost=0.0)


def build_hlbvh_flat(scene: Scene, cfg: BuildConfig = BuildConfig(), *,
                     device="cuda") -> FlatBVH:
    """The HLBVH build: the forest sweep on `device`, the top tree and the
    splice on the host; returns a host FlatBVH (root at node 0)."""
    if scene.num_tris >= 2:
        flat = splice_forest(scene, cfg, forest_sweep(scene, cfg, device))
        if flat is not None:
            return flat
    return build_lbvh_flat(scene, cfg, device=device)
