"""Offline quality builder: binned SAH + spatial splits (SBVH class).

Capability parity: the reference's SplitBVHBuilder (expected
rt/bvh/SplitBVHBuilder.{cpp,hpp}; Stich, Friedrich & Dietrich 2009 "Spatial
Splits in Bounding Volume Hierarchies"): SAH object partitioning plus
spatial splits that may duplicate triangle references, gated by
alpha * root_area overlap (alpha ~ 1e-5), producing the highest-quality
trees for spatially complex scenes (San Miguel config, BASELINE.json #5).

Documented deviations from the expected reference algorithm (exact
upstream code unverifiable -- SURVEY.md SS0):
  - object splits use 32-bin binning per axis instead of full per-axis
    reference sorting (quality within ~1% at a fraction of the cost on
    the 1-core build host);
  - spatial-split bin bounds and post-split child bounds clip the
    reference AABB to the slab/halfspace instead of re-clipping the
    triangle polygon (slightly looser fragments);
  - reference unsplitting IS implemented (greedy per-straddler choice vs
    the all-split baseline, Stich 2009 SS4.4; cfg.sbvh_unsplit).
The deviations are host-side quality heuristics; the emitted HostBVH flattens
to the standard layout and is validated against brute force like every
other builder.
"""

from __future__ import annotations

import numpy as np

from ntrace_tpu_torch.host.bvh.host_bvh import HostBVH
from ntrace_tpu_torch.host.core import BuildConfig, Scene


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    if d.ndim == 1:
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def _bin_minmax(binid, lo, hi, nb):
    """Per-bin AABB bounds via argsort + reduceat.

    np.minimum.at/maximum.at measured ~650 ns/element on this host -- it
    was 35% of the whole 10M-tri build; the sort+segmented-reduce form is
    ~20x faster for the same result."""
    order = np.argsort(binid, kind="stable")
    bs = binid[order]
    edges = np.searchsorted(bs, np.arange(nb + 1))
    blo = np.full((nb, 3), np.inf, np.float32)
    bhi = np.full((nb, 3), -np.inf, np.float32)
    ne = edges[:-1] < edges[1:]
    starts = edges[:-1][ne]
    if starts.size:
        # Segments between consecutive NONEMPTY starts contain exactly one
        # bin's elements (empty bins contribute none), so reduceat over the
        # nonempty starts is the per-bin reduction.
        blo[ne] = np.minimum.reduceat(lo[order], starts, axis=0)
        bhi[ne] = np.maximum.reduceat(hi[order], starts, axis=0)
    return blo, bhi


class _Builder:
    def __init__(self, scene: Scene | None, cfg: BuildConfig,
                 boxes: tuple[np.ndarray, np.ndarray] | None = None):
        self.cfg = cfg
        if boxes is not None:
            self.ref_lo, self.ref_hi = (
                np.asarray(boxes[0], np.float32), np.asarray(boxes[1], np.float32)
            )
            n = self.ref_lo.shape[0]
            self.ref_tri = np.arange(n, dtype=np.int32)
        else:
            tv = scene.tri_verts().astype(np.float32)
            n = scene.num_tris
            # Reference list (grows under spatial splits).
            self.ref_tri = np.arange(n, dtype=np.int32)
            self.ref_lo = tv.min(axis=1)
            self.ref_hi = tv.max(axis=1)
        root_lo = self.ref_lo.min(axis=0)
        root_hi = self.ref_hi.max(axis=0)
        self.min_overlap = cfg.sbvh_alpha * _area(root_lo, root_hi)
        self.spatial = cfg.builder == "sbvh"
        # Refs grow under spatial splits; amortized (geometric) growth --
        # per-split np.concatenate of the 10M-ref arrays was O(N^2) and
        # made SBVH intractable at San Miguel scale.
        self.n_refs = len(self.ref_tri)

        self.unsplit_count = 0
        self.child_rows: list[list[int]] = []
        self.child_lo: list[np.ndarray] = []
        self.child_hi: list[np.ndarray] = []
        self.leaf_first: list[int] = []
        self.leaf_count: list[int] = []
        self.leaf_lo: list[np.ndarray] = []
        self.leaf_hi: list[np.ndarray] = []
        self.order_parts: list[np.ndarray] = []
        self.order_pos = 0

    # -- split search -----------------------------------------------------

    def _object_split(self, lo, hi, cent, cfg):
        """Best binned SAH object split over all 3 axes.

        Returns (sah, axis, mask_left) or (inf, -1, None)."""
        nb = cfg.num_object_bins
        best = (np.inf, -1, None)
        clo = cent.min(axis=0)
        chi = cent.max(axis=0)
        for axis in range(3):
            if chi[axis] <= clo[axis]:
                continue
            scale = nb / (chi[axis] - clo[axis])
            b = np.minimum(((cent[:, axis] - clo[axis]) * scale).astype(np.int32), nb - 1)
            cnt = np.bincount(b, minlength=nb)
            blo, bhi = _bin_minmax(b, lo, hi, nb)
            # Prefix/suffix sweeps.
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)
            rcnt = np.cumsum(cnt[::-1])[::-1]
            sah = (
                lcnt[:-1] * _area(llo[:-1], lhi[:-1])
                + rcnt[1:] * _area(rlo[1:], rhi[1:])
            )
            sah = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, sah)
            k = int(np.argmin(sah))
            if sah[k] < best[0]:
                best = (float(sah[k]), axis, b <= k)
        return best

    def _object_split_sweep(self, lo, hi, cent, cfg):
        """Full-sweep SAH object split (SURVEY SS3.2: the reference's
        SplitBVHBuilder sorts refs per axis and evaluates EVERY split
        position). Exact counterpart of _object_split's contract:
        (sah, axis, mask_left) or (inf, -1, None)."""
        n = len(lo)
        best = (np.inf, -1, None)
        for axis in range(3):
            order = np.argsort(cent[:, axis], kind="stable")
            slo, shi = lo[order], hi[order]
            lmin = np.minimum.accumulate(slo, axis=0)
            lmax = np.maximum.accumulate(shi, axis=0)
            rmin = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(shi[::-1], axis=0)[::-1]
            cnt = np.arange(1, n)
            sah = (cnt * _area(lmin[:-1], lmax[:-1])
                   + (n - cnt) * _area(rmin[1:], rmax[1:]))
            k = int(np.argmin(sah))
            if sah[k] < best[0]:
                mask = np.zeros(n, bool)
                mask[order[:k + 1]] = True
                best = (float(sah[k]), axis, mask)
        return best

    def _spatial_split(self, node_lo, node_hi, lo, hi, cfg):
        """Best binned spatial split (Stich). Returns
        (sah, axis, plane) or (inf, -1, 0)."""
        nb = cfg.num_spatial_bins
        best = (np.inf, -1, 0.0)
        for axis in range(3):
            ext = node_hi[axis] - node_lo[axis]
            if ext <= 0:
                continue
            scale = nb / ext
            b0 = np.clip(((lo[:, axis] - node_lo[axis]) * scale).astype(np.int32), 0, nb - 1)
            b1 = np.clip(((hi[:, axis] - node_lo[axis]) * scale).astype(np.int32), 0, nb - 1)
            entry = np.bincount(b0, minlength=nb)
            exit_ = np.bincount(b1, minlength=nb)
            # Bin bounds from refs clipped to the slab.
            span = b1 - b0 + 1
            pairs_total = int(span.sum())
            if pairs_total > 16 * len(lo):
                # Pathologically spanning refs: slab-extent approximation.
                blo = np.tile(node_lo, (nb, 1)).astype(np.float32)
                bhi = np.tile(node_hi, (nb, 1)).astype(np.float32)
                edges = node_lo[axis] + np.arange(nb + 1, dtype=np.float32) / scale
                blo[:, axis] = edges[:-1]
                bhi[:, axis] = edges[1:]
            else:
                rep = np.repeat(np.arange(len(lo)), span)
                cum = np.concatenate([[0], np.cumsum(span)[:-1]])
                within = np.arange(pairs_total) - np.repeat(cum, span)
                binid = np.repeat(b0, span) + within
                edges = node_lo[axis] + np.arange(nb + 1, dtype=np.float32) / scale
                clo = lo[rep].copy()
                chi2 = hi[rep].copy()
                clo[:, axis] = np.maximum(clo[:, axis], edges[binid])
                chi2[:, axis] = np.minimum(chi2[:, axis], edges[binid + 1])
                blo, bhi = _bin_minmax(binid, clo, chi2, nb)
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(entry)
            rcnt = np.cumsum(exit_[::-1])[::-1]
            sah = (
                lcnt[:-1] * _area(llo[:-1], lhi[:-1])
                + rcnt[1:] * _area(rlo[1:], rhi[1:])
            )
            sah = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, sah)
            k = int(np.argmin(sah))
            if sah[k] < best[0]:
                edges = node_lo[axis] + np.arange(nb + 1, dtype=np.float32) / scale
                best = (float(sah[k]), axis, float(edges[k + 1]))
        return best

    # -- recursion ---------------------------------------------------------

    def build(self, idx: np.ndarray, depth: int) -> int:
        cfg = self.cfg
        lo = self.ref_lo[idx]
        hi = self.ref_hi[idx]
        node_lo = lo.min(axis=0)
        node_hi = hi.max(axis=0)
        area = max(_area(node_lo, node_hi), 1e-30)
        count = len(idx)

        if count <= cfg.min_leaf_size or depth >= cfg.max_depth:
            return self._leaf(idx)

        cent = (lo + hi) * 0.5
        if cfg.object_sweep:
            osah, oaxis, omask = self._object_split_sweep(lo, hi, cent, cfg)
        else:
            osah, oaxis, omask = self._object_split(lo, hi, cent, cfg)

        ssah, saxis, splane = np.inf, -1, 0.0
        if self.spatial and oaxis >= 0 and omask is not None:
            # Overlap of the object split's children gates spatial splits.
            l_lo, l_hi = lo[omask].min(0), hi[omask].max(0)
            r_lo, r_hi = lo[~omask].min(0), hi[~omask].max(0)
            ov_lo = np.maximum(l_lo, r_lo)
            ov_hi = np.minimum(l_hi, r_hi)
            if (ov_hi > ov_lo).all() and _area(ov_lo, ov_hi) > self.min_overlap:
                ssah, saxis, splane = self._spatial_split(node_lo, node_hi, lo, hi, cfg)

        leaf_sah = count * cfg.sah_tri_cost * area
        best_split = min(osah, ssah)
        split_sah = cfg.sah_node_cost * area + cfg.sah_tri_cost * best_split
        if count <= cfg.max_leaf_size and leaf_sah <= split_sah:
            return self._leaf(idx)
        if not np.isfinite(best_split):
            return self._leaf(idx) if count <= max(cfg.max_leaf_size, 64) \
                else self._median_fallback(idx, depth, cent)

        if ssah < osah:
            left_idx, right_idx = self._apply_spatial(idx, saxis, splane)
            if len(left_idx) == 0 or len(right_idx) == 0:
                left_idx, right_idx = idx[omask], idx[~omask]
        else:
            left_idx, right_idx = idx[omask], idx[~omask]

        node = len(self.child_rows)
        self.child_rows.append([0, 0])
        self.child_lo.append(np.zeros((2, 3), np.float32))
        self.child_hi.append(np.zeros((2, 3), np.float32))
        c0 = self.build(left_idx, depth + 1)
        c1 = self.build(right_idx, depth + 1)
        self.child_rows[node] = [c0, c1]
        lo0, hi0 = self._child_bounds(c0)
        lo1, hi1 = self._child_bounds(c1)
        self.child_lo[node] = np.stack([lo0, lo1]).astype(np.float32)
        self.child_hi[node] = np.stack([hi0, hi1]).astype(np.float32)
        return node

    def _apply_spatial(self, idx, axis, plane):
        """Partition refs at `plane`; straddlers are DUPLICATED with their
        boxes clipped to each side (the defining SBVH move), except where
        reference UNSPLITTING (Stich 2009 SS4.4) is cheaper: per straddler,
        compare the SAH of splitting it against moving the WHOLE box into
        one child (growing that child's bounds but shrinking the other's
        count), greedily against the all-split baseline."""
        lo = self.ref_lo[idx]
        hi = self.ref_hi[idx]
        left_only = hi[:, axis] <= plane
        right_only = lo[:, axis] >= plane
        straddle = ~(left_only | right_only)

        left_idx = idx[left_only]
        right_idx = idx[right_only]
        sidx = idx[straddle]
        if len(sidx) and self.cfg.sbvh_unsplit:
            slo = self.ref_lo[sidx]
            shi = self.ref_hi[sidx]
            # Baseline: every straddler split; child bounds include the
            # clipped fragments.
            lfrag_hi = shi.copy()
            lfrag_hi[:, axis] = np.minimum(lfrag_hi[:, axis], plane)
            rfrag_lo = slo.copy()
            rfrag_lo[:, axis] = np.maximum(rfrag_lo[:, axis], plane)
            bl_lo = np.minimum(lo[left_only].min(0, initial=np.inf),
                               slo.min(0))
            bl_hi = np.maximum(hi[left_only].max(0, initial=-np.inf),
                               lfrag_hi.max(0))
            br_lo = np.minimum(lo[right_only].min(0, initial=np.inf),
                               rfrag_lo.min(0))
            br_hi = np.maximum(hi[right_only].max(0, initial=-np.inf),
                               shi.max(0))
            nl = left_only.sum() + len(sidx)
            nr = right_only.sum() + len(sidx)
            sa_l = _area(bl_lo, bl_hi)
            sa_r = _area(br_lo, br_hi)
            c_split = sa_l * nl + sa_r * nr
            # Whole-box unions per straddler.
            sa_l_grow = _area(np.minimum(bl_lo, slo), np.maximum(bl_hi, shi))
            sa_r_grow = _area(np.minimum(br_lo, slo), np.maximum(br_hi, shi))
            c_left = sa_l_grow * nl + sa_r * (nr - 1)
            c_right = sa_l * (nl - 1) + sa_r_grow * nr
            go_left = (c_left < c_split) & (c_left <= c_right)
            go_right = (c_right < c_split) & (c_right < c_left)
            keep = ~(go_left | go_right)
            left_idx = np.concatenate([left_idx, sidx[go_left]])
            right_idx = np.concatenate([right_idx, sidx[go_right]])
            sidx = sidx[keep]
            self.unsplit_count += int((~keep).sum())
        if len(sidx):
            # Left fragments: clip existing refs in place.
            lfrag_lo = self.ref_lo[sidx]
            lfrag_hi = self.ref_hi[sidx].copy()
            lfrag_hi[:, axis] = np.minimum(lfrag_hi[:, axis], plane)
            # Right fragments: appended as new refs.
            rfrag_lo = self.ref_lo[sidx].copy()
            rfrag_hi = self.ref_hi[sidx]
            rfrag_lo[:, axis] = np.maximum(rfrag_lo[:, axis], plane)
            new_base = self._append_refs(self.ref_tri[sidx], rfrag_lo, rfrag_hi)
            self.ref_hi[sidx] = lfrag_hi
            new_idx = np.arange(new_base, new_base + len(sidx), dtype=np.int64)
            left_idx = np.concatenate([left_idx, sidx])
            right_idx = np.concatenate([right_idx, new_idx])
        return left_idx, right_idx

    def _append_refs(self, tri, lo, hi) -> int:
        """Append new refs; returns their base index. Capacity doubles so
        total copying stays O(N log N) across the whole build."""
        k = len(tri)
        base = self.n_refs
        cap = len(self.ref_tri)
        if base + k > cap:
            new_cap = max(base + k, cap + (cap >> 1) + 64)
            grow = lambda a, fill: np.concatenate(
                [a, np.full((new_cap - cap,) + a.shape[1:], fill, a.dtype)])
            self.ref_tri = grow(self.ref_tri, -1)
            self.ref_lo = grow(self.ref_lo, 0)
            self.ref_hi = grow(self.ref_hi, 0)
        self.ref_tri[base:base + k] = tri
        self.ref_lo[base:base + k] = lo
        self.ref_hi[base:base + k] = hi
        self.n_refs = base + k
        return base

    def _median_fallback(self, idx, depth, cent):
        axis = int(np.argmax(cent.max(0) - cent.min(0)))
        k = len(idx) // 2
        part = np.argpartition(cent[:, axis], k) if k > 0 else np.arange(len(idx))
        node = len(self.child_rows)
        self.child_rows.append([0, 0])
        self.child_lo.append(np.zeros((2, 3), np.float32))
        self.child_hi.append(np.zeros((2, 3), np.float32))
        li, ri = idx[part[:k]], idx[part[k:]]
        c0 = self.build(li, depth + 1)
        c1 = self.build(ri, depth + 1)
        self.child_rows[node] = [c0, c1]
        lo0, hi0 = self._child_bounds(c0)
        lo1, hi1 = self._child_bounds(c1)
        self.child_lo[node] = np.stack([lo0, lo1]).astype(np.float32)
        self.child_hi[node] = np.stack([hi0, hi1]).astype(np.float32)
        return node

    def _leaf(self, idx) -> int:
        tris = np.sort(np.unique(self.ref_tri[idx])).astype(np.int32)
        self.leaf_first.append(self.order_pos)
        self.leaf_count.append(len(tris))
        # Fragment-box union AT CREATION TIME -- later in-place clips of
        # these ref rows (deeper spatial splits elsewhere) must not shrink
        # this leaf's recorded coverage.
        self.leaf_lo.append(self.ref_lo[idx].min(axis=0).copy())
        self.leaf_hi.append(self.ref_hi[idx].max(axis=0).copy())
        self.order_parts.append(tris)
        self.order_pos += len(tris)
        return ~(len(self.leaf_first) - 1)

    def _child_bounds(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        """Bottom-up bounds of a child ref (node or leaf). Spatial splits
        clip ref boxes in place, so recomputing from ref indices after
        recursion would understate subtree coverage; bounds must propagate
        from recorded child/leaf boxes instead."""
        if c < 0:
            return self.leaf_lo[~c], self.leaf_hi[~c]
        return (self.child_lo[c].min(axis=0), self.child_hi[c].max(axis=0))


# Native-builder selection: the C++ SplitBVHBuilder counterpart
# (native/sbvh.cpp) runs the same algorithm ~20-40x faster and is the
# default above this size; below it, the Python builder's startup
# overhead is irrelevant and it remains the semantic reference.
_NATIVE_MIN_TRIS = 50_000


def sbvh_impl_tag(num_tris: int, cfg: BuildConfig) -> str:
    """'native' or 'py' -- which implementation build_sbvh will select.

    The two implementations emit equally valid but not bit-identical trees;
    the choice is fixed by size and by whether the native library loads."""
    if cfg.builder not in ("sbvh", "binned_sah") or num_tris < _NATIVE_MIN_TRIS:
        return "py"
    from ntrace_tpu_torch.host.native.sbvh_lib import native_sbvh_available

    return "native" if native_sbvh_available() else "py"


def _build_sbvh_native(scene: Scene, cfg: BuildConfig) -> HostBVH | None:
    """Native-path build; None means fall back to the Python builder."""
    from ntrace_tpu_torch.host.native.sbvh_lib import native_sbvh_build

    tv = scene.tri_verts().astype(np.float32)
    ref_lo = tv.min(axis=1)
    ref_hi = tv.max(axis=1)
    (child, clo, chi, leaf_first, leaf_count, order,
     _n_refs, _unsplit, root) = native_sbvh_build(ref_lo, ref_hi, cfg)
    if root < 0:  # whole scene became one leaf: force a trivial split
        return None
    return HostBVH(
        child=child, child_lo=clo, child_hi=chi,
        leaf_first=leaf_first, leaf_count=leaf_count, tri_order=order,
    )


def build_sbvh(scene: Scene, cfg: BuildConfig = BuildConfig(builder="sbvh")) -> HostBVH:
    """SBVH (spatial splits) or plain binned-SAH tree (builder='binned_sah')."""
    import sys

    sys.setrecursionlimit(100000)
    if scene.num_tris < 2:
        from ntrace_tpu_torch.host.bvh.median import build_median_bvh

        return build_median_bvh(scene, cfg)
    if sbvh_impl_tag(scene.num_tris, cfg) == "native":
        out = _build_sbvh_native(scene, cfg)
        if out is not None:
            return out
        from ntrace_tpu_torch.host.bvh.median import build_median_bvh

        return build_median_bvh(scene, cfg)
    b = _Builder(scene, cfg)
    root = b.build(np.arange(scene.num_tris, dtype=np.int64), 0)
    if root < 0:  # whole scene became one leaf: force a trivial split
        from ntrace_tpu_torch.host.bvh.median import build_median_bvh

        return build_median_bvh(scene, cfg)
    return HostBVH(
        child=np.asarray(b.child_rows, dtype=np.int32),
        child_lo=np.stack(b.child_lo).astype(np.float32),
        child_hi=np.stack(b.child_hi).astype(np.float32),
        leaf_first=np.asarray(b.leaf_first, dtype=np.int32),
        leaf_count=np.asarray(b.leaf_count, dtype=np.int32),
        tri_order=np.concatenate(b.order_parts).astype(np.int32),
    )


def build_sah_over_boxes(lo: np.ndarray, hi: np.ndarray,
                         cfg: BuildConfig) -> HostBVH:
    """Binned-SAH tree over arbitrary boxes, ONE box per leaf.

    Used as the HLBVH top tree: boxes are Morton-cluster AABBs and leaf
    "triangle" ids are cluster ids (~ the reference HLBVH's SAH top-tree
    over coarse clusters, SURVEY.md SS4.4).
    """
    import dataclasses

    top_cfg = dataclasses.replace(cfg, builder="binned_sah",
                                  min_leaf_size=1, max_leaf_size=1)
    b = _Builder(None, top_cfg, boxes=(lo, hi))
    root = b.build(np.arange(lo.shape[0], dtype=np.int64), 0)
    assert root >= 0, "top tree must have an internal root (>=2 boxes)"
    return HostBVH(
        child=np.asarray(b.child_rows, dtype=np.int32),
        child_lo=np.stack(b.child_lo).astype(np.float32),
        child_hi=np.stack(b.child_hi).astype(np.float32),
        leaf_first=np.asarray(b.leaf_first, dtype=np.int32),
        leaf_count=np.asarray(b.leaf_count, dtype=np.int32),
        tri_order=np.concatenate(b.order_parts).astype(np.int32),
    )
