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
     (`top_tree`);
  3. the splice: the top nodes come first (the root stays node 0), the
     treelet nodes follow with their internal links shifted, and each top
     leaf becomes its cluster's root. The Woop rows and triangle ids come
     from the device build unchanged.
Three cases take the plain LBVH build (bvh/lbvh.py:build_lbvh_flat), as in
the reference: fewer than 2 triangles; fewer than 2 clusters or no
internal node; a top leaf that holds more than one box (the splice reads
one cluster a leaf).

`build_packed_read` is the same build straight to the packet kernel's
tables on the device, as the renderer's direct route rebuilds it every
frame (render/renderer.py:Renderer._rebuild): the forest in one pass
(lbvh_device_fast in forest mode, its treelets those of the sweep), the
cluster boxes as range minima on the device (ops/boxes.py:child_boxes;
bit-equal to the host half's reduceat, except that a lane holding both
zeros takes -0.0 in lo and +0.0 in hi, where reduceat keeps the sign its
loop meets), one host read of what the top tree needs, the top tree on
the host, one upload of the top nodes and the splice on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ntrace_tpu_torch.bvh.lbvh import (Graphed, _build, build_lbvh_flat,
                                       device_inputs, lbvh_device)
from ntrace_tpu_torch.host import BuildConfig, FlatBVH, PackedBVH, Scene
from ntrace_tpu_torch.host.bvh.host_bvh import HostBVH
from ntrace_tpu_torch.host.bvh.sbvh import build_sah_over_boxes
from ntrace_tpu_torch.host.native.sbvh_lib import (native_sbvh_available,
                                                   native_sbvh_build)
from ntrace_tpu_torch.tables import table_top
from ntrace_tpu_torch.utils import timing


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


def top_tree(lo: np.ndarray, hi: np.ndarray, cfg: BuildConfig) -> HostBVH:
    """The SAH top tree over the cluster boxes lo, hi (k, 3), k >= 2, one
    box a leaf (binned SAH, min_leaf_size = max_leaf_size = 1), root at row
    0: the native builder (host/native/sbvh_lib.py) where its library
    loads, else host/bvh/sbvh.py:build_sah_over_boxes; the two give the
    same tree, bit for bit."""
    if native_sbvh_available():
        top_cfg = dataclasses.replace(cfg, builder="binned_sah",
                                      min_leaf_size=1, max_leaf_size=1)
        child, clo, chi, first, count, order, _, _, root = native_sbvh_build(
            lo, hi, top_cfg)
        if root == 0:
            return HostBVH(child=child, child_lo=clo, child_hi=chi,
                           leaf_first=first, leaf_count=count,
                           tri_order=order)
    return build_sah_over_boxes(lo, hi, cfg)


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

    top = top_tree(clo, chi, cfg)
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


def _forest_carry(box: torch.Tensor, tpr: int):
    """carry(out) of the forest build's one read (lbvh.py:_build): the
    scene box (6), the largest leaf code of the treelet records, the
    largest triangle id, n_clusters, and each cluster's root, its rows and
    its box, as float32 words."""
    def carry(out):
        enc = out["pnodes"][:, 12:14]
        words = [out[k].to(torch.int32).reshape(-1).view(torch.float32)
                 for k in ("n_clusters", "cluster_roots", "cluster_rows")]
        return torch.cat([
            box, torch.where(enc < 0, -enc, 0.0).amax().reshape(1),
            table_top(out["pnodes"], out["ptris"], 1, tpr)[1:],
            *words, out["cluster_boxes"].reshape(-1)])
    return carry


def top_records(top: HostBVH, roots: np.ndarray, rows: np.ndarray
                ) -> np.ndarray:
    """(T, 16) float32: the top tree's node records in the packet kernel's
    layout (host/bvh/packed.py), each leaf replaced by its cluster's root
    (roots: a treelet node, shifted past the T top nodes, or a leaf code
    with its `rows`), the traversal order code of pack_bvh where both
    children are nodes."""
    T = top.num_inner
    lo, hi = top.child_lo, top.child_hi          # (T, 2, 3)
    enc = np.empty((T, 2), np.int64)
    cnt = np.zeros((T, 2), np.float32)
    for c in range(2):
        ref = top.child[:, c].astype(np.int64)
        leaf = ref < 0
        k = top.tri_order[top.leaf_first[np.where(leaf, ~ref, 0)]]
        r = roots[k].astype(np.int64)
        enc[:, c] = np.where(leaf, np.where(r >= 0, r + T, r), ref)
        cnt[:, c] = np.where(leaf & (r < 0), rows[k], 0)
    sep = (lo[:, 0] + hi[:, 0]) - (lo[:, 1] + hi[:, 1])
    axis = np.abs(sep).argmax(axis=1)
    low = sep[np.arange(T), axis] <= 0
    inner = (enc >= 0).all(axis=1)
    cnt[:, 0] = np.where(inner, axis * 2 + low, cnt[:, 0])
    rec = np.empty((T, 16), np.float32)
    rec[:, 0:6] = np.stack([lo[:, 0], hi[:, 0]], axis=2).reshape(T, 6)
    rec[:, 6:12] = np.stack([lo[:, 1], hi[:, 1]], axis=2).reshape(T, 6)
    rec[:, 12:14] = enc
    rec[:, 14:16] = cnt
    return rec


def build_packed_read(args: tuple, cfg: BuildConfig, box: torch.Tensor,
                      timer: timing.StageTimer, stage: str = "build", *,
                      tris_per_row: int = 12, graph: Graphed = None):
    """The HLBVH build from `inputs_from` (bvh/lbvh.py) to the packet
    kernel's tables (one node a row) on the tensors' device, as the stage
    `stage` of `timer` runs it: the forest (span ntrace.<stage>.forest),
    the one host read (ntrace.<stage>.read) of node_count, the compact_cap
    check, the cluster count, roots, rows and boxes and the scene box
    `box` (6,) f32; the top tree on the host (ntrace.<stage>.top, timed as
    the nested stage <stage>_top), the one upload of its nodes and the
    splice (ntrace.<stage>.splice). The forest's first try goes through
    `graph` where given (bvh/lbvh.py:Graphed, its inputs `args`; `box`
    must stay). Returns dict(packed (PackedBVH, None
    where the reference falls back to the plain LBVH: fewer than 2
    clusters, no treelet node, or a top leaf with more than one box), box
    (6,) f32 as read, top (the tables' check pair), retries, clusters,
    top_nodes)."""
    tpr = tris_per_row
    n = args[0].shape[0]
    out, nc, got, retries = _build(
        args, _forest_carry(box, tpr), stage, ("forest", "read"), graph,
        max_leaf=cfg.max_leaf_size, emit="packed", tpr=tpr, npr=1,
        cluster_shift=cluster_shift(cfg))
    ccap = out["cluster_roots"].shape[0]   # the read's room for clusters
    ints = got[8:8 + 1 + 2 * ccap].view(np.int32)
    ncl = int(ints[0])
    res = dict(packed=None, box=got[0:6].copy(), top=None, retries=retries,
               clusters=ncl, top_nodes=0)
    if ncl < 2 or nc == 0:
        return res
    roots = ints[1:1 + ncl]
    rows = ints[1 + ccap:1 + ccap + ncl]
    boxes = got[9 + 2 * ccap:].reshape(ccap, 6)[:ncl]
    with timer.stage(f"{stage}_top", label=f"ntrace.{stage}.top"):
        top = top_tree(boxes[:, :3], boxes[:, 3:], cfg)
    if (top.leaf_count != 1).any():
        return res
    T = top.num_inner
    with timing.span(f"ntrace.{stage}.splice"):
        top_rec = timing.upload(top_records(top, roots, rows),
                                args[0].device)
        tre = out["pnodes"][:nc, :16]
        links = tre[:, 12:14]
        total = T + nc
        nodes8 = torch.zeros((max(8, -(-total // 8) * 8), 128),
                             dtype=torch.float32, device=tre.device)
        nodes8[:T, :16] = top_rec
        nodes8[T:total, :12] = tre[:, :12]
        nodes8[T:total, 12:14] = torch.where(links >= 0, links + T, links)
        nodes8[T:total, 14:16] = tre[:, 14:16]
    leaf_codes = -roots[roots < 0]
    res.update(packed=PackedBVH(nodes8=nodes8, tris12=out["ptris"],
                                num_nodes=total, num_tris=n,
                                nodes_per_row=1, tris_per_row=tpr),
               top=[max(float(total - 1), float(got[6]),
                        float(leaf_codes.max(initial=0))), float(got[7])],
               top_nodes=T)
    return res
