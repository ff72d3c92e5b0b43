"""LBVH: the Morton-code BVH built on the device, in torch.

Counterpart of ntrace_tpu/bvh/lbvh.py: `_mset` (43), `_device_woopify`
(58-85), `lbvh_device` (87-340, the 30-level radix-trie sweep with its
forest mode, which HLBVH builds on: bvh/hlbvh.py), `lbvh_device_fast`
(345-859, emit="packed" and "flat"), `build_lbvh_packed` (862-904) and
`build_lbvh_flat` (907-963). The tree of `lbvh_device_fast` is the
reference's to the bit (its forest mode, cluster_shift > 0, is the port's
own: HLBVH's treelets in one pass, held to `lbvh_device`'s forest):
  - Morton codes of the triangle centroids, sorted with the triangle index
    as the tie break (`morton_sort`);
  - the binary radix tree over the boundaries of the sorted codes, through
    all nearest smaller values by value class (`split_levels`, `ansv`):
    two (31, n) class scans, a forward cummax and a reverse cummin, which
    go through `ops/pscan.py:row_scan_i32`, so the CUDA kernel
    csrc/row_scan.cu on a CUDA tensor and its plain version on the CPU;
  - pruning of subtrees with at most max_leaf triangles (and of duplicate-
    code splits), the kept boundaries around each row (`kept_neighbours`:
    a (1, n) forward cummax and reverse cummin through the same row scan,
    4 launches a build in all), the leaf runs, compaction to the kept
    nodes, the child boxes (`ops/boxes.py:child_boxes`: range minima over
    the sorted boxes, the CUDA kernel csrc/child_boxes.cu on a CUDA tensor
    and its plain version on the CPU, one launch a build), the child-to-
    parent link scatter, and either the packet kernel's tables
    (emit="packed": node records and dense triangle slots, root at row 0,
    links as float values) or the FlatBVH arrays (emit="flat": Woop rows
    with leaf-end sentinels).

Where torch differs from lax, the port keeps the reference's result:
  - `clz` is ops/morton.py:clz32; the logical right shifts mask the
    arithmetic ones;
  - the multi-operand sorts with num_keys=2 have unique keys through the
    index: the Morton sort is one torch.sort of (code << 32) | index; the
    kept-first compaction sort is the stable partition it computes (each
    kept row to its rank among the kept, each other row after them);
  - the num_keys=1 sort before the link scatter only orders updates whose
    targets are unique, so the port scatters them unsorted;
  - mode="drop" scatters write their dropped updates to one spare slot
    past the end, which is then cut off;
  - the child boxes are range minima like the reference's sparse-table
    reads, taken as integer minima of ordered keys (ops/boxes.py): a
    minimum is exact, and where a lane holds both zeros the key order
    gives lax.min's -0.0 (lo) and +0.0 (hi);
  - the 31-way select chains are one gather on the class index.
`lbvh_device` keeps the reference's sweep level by level: a Python loop
over the 30 levels for the fori_loop, its reverse position-key cummins
through `row_scan_i32` on (1, n) views (2 launches a level, 61 a build,
62 in forest mode), its child boxes through `child_boxes` (one launch),
its unique-target scatters as index writes and its mode="drop" scatters
through `_set_drop`; all of its outputs but the Woop rows are bit-equal to
the reference's.
In both flat emissions the Woop rows are f32 cross products written out as
separate multiplies and subtractions; XLA on the CPU contracts them into
fused multiply-adds, so the rows agree with the JAX build within a few ulp
(tests/test_torch_lbvh.py states the bound), and every other output is
bit-equal.

Not ported: the `_ablate` probes (ROADMAP queue 1, item 15), the
NTRACE_LBVH_PLACE "scatter" and "pair4" placements (recorded negatives on
the TPU; only "gather" is ported) and the NTRACE_ANSV switch (a CUDA
tensor always takes the kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ntrace_tpu_torch.host import (BuildConfig, FlatBVH, PackedBVH, Scene,
                                   build_median_bvh, flatten_bvh, pack_bvh)
from ntrace_tpu_torch.ops.boxes import child_boxes
from ntrace_tpu_torch.ops.morton import clz32, morton_codes_3d
from ntrace_tpu_torch.ops.pscan import row_scan_i32
from ntrace_tpu_torch.utils import timing

MAX_TRIS = 1 << 24      # tri ids and links ride float32 values
CLASSES = 31            # split levels 0..30
_LEAF_END = float(np.array([-0x80000000], np.int32).view(np.float32)[0])


def _i32(n, dev):
    return torch.arange(n, dtype=torch.int32, device=dev)


def _cumsum(b: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(b.to(torch.int32), 0, dtype=torch.int32)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 (lax.shift_right_logical)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """arr[idx] = val along dim 0, updates with idx outside [0, len) dropped
    (lax scatter mode="drop"); live targets are distinct."""
    m = arr.shape[0]
    idx = torch.where((idx >= 0) & (idx < m), idx, m).long()
    ext = torch.cat([arr, arr[:1]])
    ext[idx] = val
    return ext[:m]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross of (n, 3) rows, each product and difference its own op."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.sum(a * b, axis=1) over 3 lanes, summed left to right."""
    p = a * b
    return (p[:, 0] + p[:, 1]) + p[:, 2]


def geometric_normals(tv: torch.Tensor) -> torch.Tensor:
    """(n, 3) f32 unnormalised cross(v1 - v0, v2 - v0) of (n, 3, 3)
    triangles, each product and difference its own op: bit-equal to
    Scene.geometric_normals (numpy's cross)."""
    return _cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])


def device_woopify(tv: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) f32 triangles -> (n, 12) f32 Woop rows (closed-form
    adjugate); degenerate triangles get the never-hit poison row."""
    p0, p1, p2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    nrm = _cross(e1, e2)
    det = _dot3(nrm, nrm)
    ok = det != 0.0
    inv_det = torch.where(
        ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
        torch.zeros_like(det))[:, None]
    r0 = _cross(e2, nrm) * inv_det
    r1 = _cross(nrm, e1) * inv_det
    r2 = nrm * inv_det
    t0 = -_dot3(r0, p0)
    t1 = -_dot3(r1, p0)
    t2 = -_dot3(r2, p0)
    w = torch.cat([r2, (-t2)[:, None], r0, t0[:, None], r1, t1[:, None]],
                  dim=1)
    poison = torch.zeros((12,), dtype=torch.float32, device=tv.device)
    poison[7] = -1.0
    poison[11] = -1.0
    w = torch.where(ok[:, None], w, poison[None, :])
    # m0.x must never alias the -0.0 leaf sentinel.
    w[:, 0] = w[:, 0] + 0.0
    return w


def morton_sort(tri_lo, tri_hi, tri_verts, scene_lo, scene_hi):
    """Morton codes of the centroids, sorted by (code, index).
    Returns (codes, order, slo, shi, tv_s), all in sorted order."""
    n = tri_lo.shape[0]
    cent = (tri_lo + tri_hi) * 0.5
    codes = morton_codes_3d(cent, scene_lo, scene_hi)
    key = (codes.to(torch.int64) << 32) | _i32(n, tri_lo.device).long()
    key = torch.sort(key).values
    order = (key & 0xFFFFFFFF).to(torch.int32)
    o = order.long()
    return ((key >> 32).to(torch.int32), order, tri_lo[o], tri_hi[o],
            tri_verts[o])


def split_levels(codes: torch.Tensor) -> torch.Tensor:
    """D: the split level of each boundary of the sorted codes, the common-
    prefix length of rows (i-1, i) in [0, 30], and -1 at row 0."""
    x = codes[1:] ^ codes[:-1]
    d = torch.where(x == 0, 30, clz32(x) - 2).to(torch.int32)
    return torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                 device=codes.device), d])


def ansv_inputs(D: torch.Tensor):
    """The two (31, n) int32 inputs of the class scans: row c holds
    (pos << 5) | (D + 1) where D <= c (else -1) for the forward cummax, and
    where D < c (else (n << 5) | 31) for the reverse cummin."""
    n = D.shape[0]
    cs = torch.arange(CLASSES, dtype=torch.int32, device=D.device)[:, None]
    packed = (_i32(n, D.device) << 5) | (D + 1)
    big = (n << 5) | 31
    xmax = torch.where(D[None, :] <= cs, packed[None, :], -1)
    xmin = torch.where(D[None, :] < cs, packed[None, :], big)
    return xmax.to(torch.int32), xmin.to(torch.int32)


def ansv_scans(D: torch.Tensor, scan=row_scan_i32):
    """The pair of class scans, through `scan` (row_scan_i32 or its plain
    version): (forward cummax, reverse cummin), each (31, n) int32."""
    xmax, xmin = ansv_inputs(D)
    P = scan(xmax, op="max")
    del xmax
    return P, scan(xmin, op="min", reverse=True)


def ansv(D: torch.Tensor, scan=row_scan_i32):
    """Nearest smaller values by value class, packed (pos << 5) | (D + 1):
    nsl(i) nearest j < i with D[j] <= D[i] (-1 at row 0), nsr(i) nearest
    j > i with D[j] < D[i] ((n << 5) | 31 when there is none)."""
    n = D.shape[0]
    P, Q = ansv_scans(D, scan)
    cls = D.clamp(min=0).long()[None, :]
    big = (n << 5) | 31
    dev = D.device
    nsl = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                     P[:, :-1].gather(0, cls[:, 1:])[0]])
    nsr = torch.cat([Q[:, 1:].gather(0, cls[:, :-1])[0],
                     torch.full((1,), big, dtype=torch.int32, device=dev)])
    return nsl, nsr


def _mset(arr: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor):
    """arr[idx] = val where mask, the other updates dropped (the
    reference's _mset); live targets are distinct."""
    return _set_drop(arr, torch.where(mask, idx, arr.shape[0]), val)


def _next_min(key: torch.Tensor) -> torch.Tensor:
    """Reverse inclusive cummin of an int32 row (lax.cummin reverse=True),
    through the row-scan kernel on a (1, n) view."""
    return row_scan_i32(key.reshape(1, -1), op="min", reverse=True)[0]


def kept_neighbours(kept: torch.Tensor, scan=None):
    """The kept boundaries around each row of a (n,) bool mask: pks[i] the
    last kept row before i (-1 when there is none) and nks[i] the next kept
    row after i (n when there is none), int32. A forward cummax and a
    reverse cummin on (1, n) rows, through `scan` (row_scan_i32 when None,
    or its plain version)."""
    scan = scan or row_scan_i32
    n = kept.shape[0]
    iota = _i32(n, kept.device)
    pk = scan(torch.where(kept, iota, -1).reshape(1, -1), op="max")[0]
    nk = scan(torch.where(kept, iota, n).reshape(1, -1), op="min",
              reverse=True)[0]
    edge = dict(dtype=torch.int32, device=kept.device)
    return (torch.cat([torch.full((1,), -1, **edge), pk[:-1]]),
            torch.cat([nk[1:], torch.full((1,), n, **edge)]))


def _next_boundary(boundary: torch.Tensor, iota: torch.Tensor):
    """The next segment start after each row (n when there is none)."""
    n = boundary.shape[0]
    bkey = torch.where(boundary, iota, n)
    return _next_min(torch.cat([bkey[1:], bkey.new_full((1,), n)]))


def _split_boxes(boxes: torch.Tensor) -> tuple:
    """(lo0, hi0, lo1, hi1), each (m, 3), of child_boxes' (m, 12) rows."""
    return boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6:9], boxes[:, 9:12]


def lbvh_device(tri_lo, tri_hi, tri_verts, scene_lo, scene_hi,
                max_leaf: int = 4, cluster_shift: int = 0) -> dict:
    """A flattened LBVH, or with cluster_shift > 0 an LBVH forest for
    HLBVH, on the tensors' device: the reference's 30-level radix-trie sweep.

    tri_lo/tri_hi: (n, 3) f32 triangle boxes; tri_verts: (n, 3, 3) f32;
    scene_lo/scene_hi: (3,) f32. Each level splits every open segment
    whose current Morton bit changes inside it; a segment stops at
    max_leaf triangles or when the bits run out. cluster_shift=k > 0:
    rows whose (code >> k) differ start separate root segments (the HLBVH
    treelets); cluster_roots reports each cluster's subtree root in the
    final child encoding (>= 0 a node, < 0 ~woop offset of a leaf).
    Returns the reference's dict: nodes (n-1, 16) f32, woop (2n, 12) f32,
    tri_index (2n,) int32, node_count, leaf_count, cluster_roots (n,),
    cluster_ids (n,), order (n,) and n_clusters (0-d int32 tensors for the
    counts). Rows past the counts are zeros or sentinels, unreferenced.
    The reverse cummins go through ops/pscan.py:row_scan_i32.
    The flat route's HLBVH builds call it in forest mode (bvh/hlbvh.py:
    forest_sweep); it is the oracle of lbvh_device_fast's forest mode,
    which the device route builds with. cluster_shift=0, a plain LBVH
    beside lbvh_device_fast, is kept for the parity tests against the
    reference.
    """
    n = tri_lo.shape[0]
    dev = tri_lo.device
    i32 = dict(dtype=torch.int32, device=dev)
    codes, order, slo, shi, tv_s = morton_sort(tri_lo, tri_hi, tri_verts,
                                               scene_lo, scene_hi)
    iota = _i32(n, dev)
    ncap = max(n - 1, 1)
    yes = torch.ones((n,), dtype=torch.bool, device=dev)

    if cluster_shift > 0:
        top = codes >> cluster_shift
        boundary = top != torch.cat([top[:1] - 1, top[:-1]])
        ordinal = _cumsum(boundary) - 1
        parent_slot = torch.where(boundary, -(ordinal + 2), -1)
    else:
        boundary = iota == 0
        ordinal = torch.zeros((n,), **i32)
        parent_slot = torch.full((n,), -1, **i32)
    terminal = torch.zeros((n,), dtype=torch.bool, device=dev)
    children = torch.zeros((2 * ncap,), **i32)     # (ncap, 2) flattened
    cluster_roots = torch.zeros((n,), **i32)
    rng_s = torch.zeros((ncap,), **i32)
    rng_p = torch.zeros((ncap,), **i32)
    rng_e = torch.zeros((ncap,), **i32)
    leaf_first = torch.zeros((n,), **i32)
    leaf_count = torch.zeros((n,), **i32)
    node_next = torch.zeros((), **i32)
    leaf_next = torch.zeros((), **i32)

    if cluster_shift > 0:
        # Clusters at or below the leaf limit are leaves from the start.
        cnt0 = _next_boundary(boundary, iota) - iota
        pre = boundary & (cnt0 <= max_leaf)
        psum = _cumsum(pre)
        pidx = psum - 1
        leaf_first = _mset(leaf_first, pidx, iota, pre)
        leaf_count = _mset(leaf_count, pidx, cnt0, pre)
        terminal = _mset(terminal, iota, yes, pre)
        cluster_roots = _mset(cluster_roots, ordinal, ~pidx, pre)
        leaf_next = psum[-1]

    for level in range(30):
        bits = (codes >> (29 - level)) & 1
        change = (bits != torch.cat([bits[:1], bits[:-1]])) & ~boundary
        change[0] = False
        e = _next_boundary(boundary, iota)
        p = _next_min(torch.where(change, iota, n))
        split = boundary & ~terminal & (p < e)

        # One internal node per splitting segment.
        alloc = _cumsum(split)
        node_idx = node_next + alloc - 1

        # Link to the parent, or mark a cluster root (ps <= -2: the root
        # segment of cluster -ps - 2).
        ps = parent_slot
        children = _mset(children, ps, node_idx, split & (ps >= 0))
        cluster_roots = _mset(cluster_roots, -ps - 2, node_idx,
                              split & (ps <= -2))
        rng_s = _mset(rng_s, node_idx, iota, split)
        rng_p = _mset(rng_p, node_idx, p, split)
        rng_e = _mset(rng_e, node_idx, e, split)

        left_n = p - iota
        right_n = e - p
        lleaf = split & (left_n <= max_leaf)
        rleaf = split & (right_n <= max_leaf)
        lsum = _cumsum(lleaf)
        lidx = leaf_next + lsum - 1
        rsum = _cumsum(rleaf)
        ridx = leaf_next + lsum[-1] + rsum - 1
        leaf_first = _mset(leaf_first, lidx, iota, lleaf)
        leaf_count = _mset(leaf_count, lidx, left_n, lleaf)
        leaf_first = _mset(leaf_first, ridx, p, rleaf)
        leaf_count = _mset(leaf_count, ridx, right_n, rleaf)
        children = _mset(children, node_idx * 2, ~lidx, lleaf)
        children = _mset(children, node_idx * 2 + 1, ~ridx, rleaf)

        # Children that are not leaves become segments of the next level.
        parent_slot = _mset(parent_slot, iota, node_idx * 2, split & ~lleaf)
        parent_slot = _mset(parent_slot, p, node_idx * 2 + 1, split & ~rleaf)
        terminal = _mset(terminal, iota, yes, lleaf)
        terminal = _mset(terminal, p, yes, rleaf)
        boundary = _mset(boundary, p, yes, split)
        node_next = node_next + alloc[-1]
        leaf_next = leaf_next + lsum[-1] + rsum[-1]

    # Segments left open (duplicate codes, bits exhausted) become leaves.
    nb = _next_boundary(boundary, iota)
    open_seg = boundary & ~terminal
    resid_p = open_seg & (parent_slot >= 0)
    resid_m = open_seg & (parent_slot <= -2)
    rsum = _cumsum(resid_p | resid_m)
    ridx = leaf_next + rsum - 1
    leaf_first = _mset(leaf_first, ridx, iota, resid_p | resid_m)
    leaf_count = _mset(leaf_count, ridx, nb - iota, resid_p | resid_m)
    children = _mset(children, parent_slot, ~ridx, resid_p)
    cluster_roots = _mset(cluster_roots, -parent_slot - 2, ~ridx, resid_m)
    leaf_next = leaf_next + rsum[-1]

    # Child boxes: range minima over the sorted boxes (ops/boxes.py).
    lo0, hi0, lo1, hi1 = _split_boxes(
        child_boxes(slo, shi, rng_s, rng_p, rng_e, node_next))

    # Woop offsets of the leaves and the final child encoding.
    is_leaf_slot = iota < leaf_next
    leaf_start_row = _mset(torch.zeros((n,), dtype=torch.bool, device=dev),
                           leaf_first, yes, is_leaf_slot)
    runs_incl = _cumsum(leaf_start_row)
    woop_off_leaf = leaf_first + runs_incl[leaf_first.long()] - 1
    children = children.reshape(ncap, 2)
    is_leaf_child = children < 0
    leaf_ids = torch.where(is_leaf_child, ~children, 0).long()
    enc = torch.where(is_leaf_child, ~woop_off_leaf[leaf_ids], children)

    cols = [lo0[:, 0], hi0[:, 0], lo0[:, 1], hi0[:, 1],
            lo1[:, 0], hi1[:, 0], lo1[:, 1], hi1[:, 1],
            lo0[:, 2], hi0[:, 2], lo1[:, 2], hi1[:, 2],
            enc[:, 0].contiguous().view(torch.float32),
            enc[:, 1].contiguous().view(torch.float32)]
    zero = torch.zeros((ncap,), dtype=torch.float32, device=dev)
    nodes = torch.stack(cols + [zero, zero], dim=1)
    nodes = torch.where((_i32(ncap, dev) < node_next)[:, None], nodes, 0.0)

    # Woop rows in sorted order, a leaf-end sentinel after each leaf run.
    wcap = 2 * n
    dst = iota + runs_incl - 1
    woop = _set_drop(torch.zeros((wcap, 12), dtype=torch.float32,
                                 device=dev), dst, device_woopify(tv_s))
    sent = _mset(torch.zeros((wcap,), dtype=torch.bool, device=dev),
                 woop_off_leaf + leaf_count, yes, is_leaf_slot)
    woop[:, 0] = torch.where(sent, _LEAF_END, woop[:, 0])
    tri_index = _set_drop(torch.full((wcap,), -1, **i32), dst, order)

    cr_leaf = cluster_roots < 0
    cr_final = torch.where(
        cr_leaf,
        ~woop_off_leaf[torch.where(cr_leaf, ~cluster_roots, 0).long()],
        cluster_roots)
    return dict(nodes=nodes, woop=woop, tri_index=tri_index,
                node_count=node_next, leaf_count=leaf_next,
                cluster_roots=cr_final, cluster_ids=ordinal, order=order,
                n_clusters=ordinal[-1] + 1)


def lbvh_device_fast(tri_lo, tri_hi, tri_verts, scene_lo, scene_hi,
                     max_leaf: int = 4, compact_cap: int | None = None,
                     emit: str = "flat", tpr: int = 12, npr: int = 1,
                     cluster_shift: int = 0):
    """Single-pass LBVH emission on the tensors' device.

    tri_lo/tri_hi: (n, 3) f32 triangle boxes; tri_verts: (n, 3, 3) f32;
    scene_lo/scene_hi: (3,) f32. Node records come out compact: `nodes`
    (flat) or the records in `pnodes` (packed) have the cap's rows, the
    first node_count valid. A spine-shaped tree can overflow the cap
    (node_count > cap); the wrappers then rebuild with compact_cap=n.
    emit="packed": dict(pnodes, ptris, kept, root=0, node_count, cap,
    leaf_count, order); emit="flat": dict(nodes (cap, 16), woop (2n, 12),
    tri_index (2n,), kept, root (compact id), node_count, cap, leaf_count,
    order). Counts are 0-d int32 tensors on the device; cap is an int.

    cluster_shift=k > 0, the forest of HLBVH (bvh/hlbvh.py): the treelets
    of lbvh_device(cluster_shift=k) in one pass. A cluster is a run of rows
    with one code >> k; its treelet is the radix tree's subtree over it
    (the nodes whose split level is at least 30 - k), pruned as above, and
    a cluster start always starts a leaf run, so no leaf spans two
    clusters (clusters of at most max_leaf rows stay separate leaves). No
    record is the root and no treelet root is linked (`root` is None);
    the dict adds n_clusters (0-d), cluster_roots (ccap,) int32 each
    cluster's root in the emission's child encoding (a compact id, or the
    leaf code of a cluster that is one leaf), cluster_rows (ccap,) int32
    the triangle rows of such a leaf (packed; 0 for a node root) and
    cluster_boxes (ccap, 6) f32 [lo, hi] over the cluster's rows
    (child_boxes), ccap = min(n, 2 ** (30 - k)); entries from n_clusters
    on are unreferenced.
    """
    n = tri_lo.shape[0]
    if n >= MAX_TRIS:
        raise ValueError("lbvh_device_fast: tri ids ride a float32 value "
                         "lane, exact only below 2**24 tris")
    if emit not in ("packed", "flat"):
        raise ValueError(f"emit must be 'packed' or 'flat', got {emit!r}")
    dev = tri_lo.device
    f32 = dict(dtype=torch.float32, device=dev)
    iota = _i32(n, dev)
    codes, order, slo, shi, tv_s = morton_sort(tri_lo, tri_hi, tri_verts,
                                               scene_lo, scene_hi)
    D = split_levels(codes)
    nsl, nsr = ansv(D)
    a = _srl(nsl, 5)            # range start row (0 if none)
    dl = (nsl & 31) - 1
    b = _srl(nsr, 5)            # range end row (n if none)
    dr = (nsr & 31) - 1

    # Parent: the deeper of the two nearest-smaller neighbours.
    prio_l = ((dl + 1) << 25) | a
    prio_r = ((dr + 1) << 25) | b
    no_r = b >= n
    root_f = (a <= 0) & no_r
    par_left = no_r | (prio_l > prio_r)
    parent = torch.where(par_left, a, b)
    side = par_left.to(torch.int32)
    size = b - a
    # Duplicate-code (D == 30) splits are never kept: one fat leaf.
    kept = (iota >= 1) & (size > max_leaf) & (D < 30)
    forest = cluster_shift > 0
    if forest:
        # Splits above the clusters' bits belong to the top tree.
        top_bits = 30 - cluster_shift
        kept = kept & (D >= top_bits)
        cstart = D < top_bits         # row 0 (D == -1) starts a cluster
        # A treelet root hangs from a split of the top (or from nothing).
        croot = kept & (torch.where(par_left, dl, dr) < top_bits)
        leaf_start = kept | cstart
    else:
        leaf_start = kept | (iota == 0)
    runs_incl = _cumsum(leaf_start)
    lcount = runs_incl[-1]
    dst = iota + runs_incl - 1          # woop row of sorted tri r

    pks, nks = kept_neighbours(kept)
    lleaf = pks <= a      # no kept boundary strictly inside (a, i)
    rleaf = nks >= b      # no kept boundary strictly inside (i, b)

    # Compaction to the kept nodes, kept rows first in row order.
    if compact_cap is None:
        ncap = min(n, int(n * 3.2 / (max_leaf + 4)) + 256)
    else:
        ncap = min(max(compact_cap, 8), n)
    ncap = min(-(-ncap // 8) * 8, n)
    kposi = _cumsum(kept) - 1            # compact slot per kept row
    node_count = torch.clamp(kposi[-1] + 1, min=0)
    slot = torch.where(kept, kposi, node_count + iota - kposi - 1)
    perm = torch.empty_like(iota).scatter_(0, slot.long(), iota)
    cidx = perm[:ncap]
    ci = cidx.long()
    a_c, b_c, dst_i = a[ci], b[ci], dst[ci]
    lleaf_c, rleaf_c = lleaf[ci], rleaf[ci]
    parent_c, side_c, root_c = parent[ci], side[ci], root_f[ci]
    ic = _i32(ncap, dev)
    cvalid = ic < node_count
    lo0, hi0, lo1, hi1 = _split_boxes(
        child_boxes(slo, shi, a_c, cidx, b_c, node_count))
    dst_a = dst[a_c.clamp(0, n - 1).long()]   # left-child run offsets

    if emit == "packed":
        # Leaf child -> -(first tri row + 1) of the dense sorted slots.
        enc0 = torch.where(lleaf_c, -torch.div(a_c, tpr,
                                               rounding_mode="floor") - 1, 0)
        enc1 = torch.where(rleaf_c, -torch.div(cidx, tpr,
                                               rounding_mode="floor") - 1, 0)
    else:
        enc0 = torch.where(lleaf_c, ~dst_a, 0)
        enc1 = torch.where(rleaf_c, ~dst_i, 0)
    enc = torch.stack([enc0, enc1], dim=1).to(torch.int32)
    # The link scatter: each valid non-root kept node writes its compact id
    # into its parent's child slot (targets are distinct).
    pcomp = kposi[parent_c.clamp(0, n - 1).long()]
    unlinked = croot[ci] if forest else root_c
    flat_t = torch.where(cvalid & ~unlinked, pcomp * 2 + side_c, 2 * ncap)
    enc = _set_drop(enc.reshape(-1), flat_t, ic).reshape(ncap, 2)
    rootc = None if forest else torch.argmax(
        (cvalid & root_c).to(torch.int32)).to(torch.int32)
    clusters = {} if not forest else _clusters(
        cstart, cvalid & unlinked, cidx, slo, shi, dst, emit, tpr,
        min(n, 1 << top_bits))

    if emit == "packed":
        return dict(_emit_packed(
            n, ncap, tpr, npr, cidx, a_c, b_c, lleaf_c, rleaf_c, cvalid,
            enc, rootc, lo0, hi0, lo1, hi1, tv_s, order, kept, node_count,
            lcount), **clusters)

    zero = torch.zeros((ncap,), **f32)
    cols = [lo0[:, 0], hi0[:, 0], lo0[:, 1], hi0[:, 1],
            lo1[:, 0], hi1[:, 0], lo1[:, 1], hi1[:, 1],
            lo0[:, 2], hi0[:, 2], lo1[:, 2], hi1[:, 2]]
    enc_m = torch.where(cvalid[:, None], enc, 0).contiguous()
    nodes = torch.stack(
        [torch.where(cvalid, c, zero) for c in cols]
        + [enc_m[:, 0].contiguous().view(torch.float32),
           enc_m[:, 1].contiguous().view(torch.float32), zero, zero], dim=1)

    # Woop rows + tri ids by the "gather" placement: one scatter builds the
    # output -> input row map (0: a leaf-end sentinel row), one row gather
    # places the payload.
    w = device_woopify(tv_s)
    wcap = 2 * n
    init_row = torch.zeros((13,), **f32)
    init_row[0] = _LEAF_END
    init_row[12] = -1.0
    payload13 = torch.cat([w, order.to(torch.float32)[:, None]], dim=1)
    src1 = _set_drop(torch.zeros((wcap,), dtype=torch.int32, device=dev),
                     dst, iota + 1)
    gathered = payload13[(src1 - 1).clamp(min=0).long()]
    wout = torch.where((src1 > 0)[:, None], gathered, init_row[None, :])
    return dict(nodes=nodes, woop=wout[:, :12].contiguous(),
                tri_index=wout[:, 12].to(torch.int32), kept=kept,
                root=rootc, node_count=node_count, cap=ncap,
                leaf_count=lcount, order=order, **clusters)


def _clusters(cstart, root_nodes, cidx, slo, shi, dst, emit, tpr, ccap):
    """The forest's clusters (lbvh_device_fast, cluster_shift > 0): their
    count, each one's root in the emission's encoding, the rows of a root
    that is a leaf (packed) and each one's box. cstart (n,) marks the
    cluster starts; root_nodes (cap,) the compact nodes that root a
    treelet, cidx (cap,) their rows."""
    n = cstart.shape[0]
    dev = cstart.device
    cid = _cumsum(cstart) - 1
    n_clusters = cid[-1] + 1
    # Each cluster's rows [cs, ce); past n_clusters both are n.
    cs = _set_drop(torch.full((ccap,), n, dtype=torch.int32, device=dev),
                   torch.where(cstart, cid, ccap), _i32(n, dev))
    ce = torch.cat([cs[1:], cs.new_full((1,), n)])
    first = cs.clamp(max=n - 1)
    if emit == "packed":
        leaf = -torch.div(first, tpr, rounding_mode="floor") - 1
        rows = (torch.div(ce - 1, tpr, rounding_mode="floor")
                - torch.div(first, tpr, rounding_mode="floor") + 1)
    else:
        leaf = ~dst[first.long()]
        rows = torch.zeros_like(cs)
    # A cluster with a kept root node: its compact id (distinct targets).
    roots = _set_drop(leaf, torch.where(root_nodes, cid[cidx.long()], ccap),
                      _i32(cidx.shape[0], dev))
    boxes = child_boxes(slo, shi, cs, ce, ce, n_clusters)[:, :6]
    return dict(n_clusters=n_clusters, cluster_roots=roots,
                cluster_rows=torch.where(roots < 0, rows, 0),
                cluster_boxes=boxes)


def _emit_packed(n, ncap, tpr, npr, cidx, a_c, b_c, lleaf_c, rleaf_c,
                 cvalid, enc, rootc, lo0, hi0, lo1, hi1, tv_s, order, kept,
                 node_count, lcount):
    """The packet kernel's tables (bvh/packed.py layout): node records with
    the root at row 0 and links as float values, and the dense sorted
    triangle slots [v0, e1, e2, id]."""
    dev = cidx.device
    f32 = dict(dtype=torch.float32, device=dev)

    def floor_div(x):
        return torch.div(x, tpr, rounding_mode="floor")

    size0 = cidx - a_c
    size1 = b_c - cidx
    row0 = floor_div(a_c)
    row1 = floor_div(cidx)
    rows0 = floor_div(a_c + size0.clamp(min=1) - 1) - row0 + 1
    rows1 = floor_div(cidx + size1.clamp(min=1) - 1) - row1 + 1
    # Root to slot 0 in the links (swap 0 <-> root); rows swapped below.
    # A forest (rootc None) keeps its compact ids.
    ei = enc if rootc is None else torch.where(
        enc >= 0, torch.where(enc == rootc, 0,
                              torch.where(enc == 0, rootc, enc)), enc)
    encf = ei.to(torch.float32)
    # Traversal order code (axis * 2 + child 0 on the low side), from the
    # child centres, as pack_bvh.
    sep = (lo0 + hi0) - (lo1 + hi1)
    sa = sep.abs()
    axis = torch.where(sa[:, 1] > sa[:, 0], 1, 0)
    axis = torch.where(sa[:, 2] > torch.maximum(sa[:, 0], sa[:, 1]), 2, axis)
    sepa = torch.where(axis == 0, sep[:, 0],
                       torch.where(axis == 1, sep[:, 1], sep[:, 2]))
    code = (axis * 2 + (sepa <= 0).to(axis.dtype)).to(torch.float32)
    both_int = ~lleaf_c & ~rleaf_c
    zero = torch.zeros((ncap,), **f32)
    cnt0 = torch.where(both_int, code,
                       torch.where(lleaf_c, rows0.to(torch.float32), zero))
    cnt1 = torch.where(rleaf_c, rows1.to(torch.float32), zero)
    lanes = [lo0[:, 0], hi0[:, 0], lo0[:, 1], hi0[:, 1],
             lo0[:, 2], hi0[:, 2], lo1[:, 0], hi1[:, 0],
             lo1[:, 1], hi1[:, 1], lo1[:, 2], hi1[:, 2],
             encf[:, 0], encf[:, 1], cnt0, cnt1]
    rec = torch.stack([torch.where(cvalid, c, zero) for c in lanes], dim=1)
    if rootc is not None:
        swap = torch.stack([torch.zeros_like(rootc),
                            rootc.clamp(min=0)]).long()
        rec[swap] = rec[swap.flip(0)]
    nc8 = -(-ncap // 8) * 8
    if nc8 != ncap:
        rec = torch.cat([rec, torch.zeros((nc8 - ncap, 16), **f32)])
    if npr == 8:
        pnodes = rec.reshape(-1, 128)
    else:
        pnodes = torch.cat([rec, torch.zeros((nc8, 112), **f32)], dim=1)
    # Dense tri slots in sorted order; >= 3 spare rows past the end. Pad
    # slots have e1 = e2 = 0 (det == 0) and id -1: they never hit.
    v0 = tv_s[:, 0, :]
    payload10 = torch.cat([v0, tv_s[:, 1, :] - v0, tv_s[:, 2, :] - v0,
                           order.to(torch.float32)[:, None]], dim=1)
    tr = -(-n // tpr)
    tr_pad = max(8, -(-(tr + 3) // 8) * 8)
    # The id lane -1; made by cat, not an element write from the host, so
    # that a CUDA graph can record the build (Graphed).
    padrow = torch.cat([torch.zeros((9,), **f32),
                        torch.full((1,), -1.0, **f32)])
    pt = torch.cat([payload10, padrow.expand(tr_pad * tpr - n, 10)])
    pt = pt.reshape(tr_pad, tpr * 10)
    ptris = torch.cat([pt, torch.zeros((tr_pad, 128 - tpr * 10), **f32)],
                      dim=1)
    return dict(pnodes=pnodes.contiguous(), ptris=ptris.contiguous(),
                kept=kept,
                root=None if rootc is None else torch.zeros_like(rootc),
                node_count=node_count, cap=ncap, leaf_count=lcount,
                order=order)


def inputs_from(positions: torch.Tensor, indices: torch.Tensor) -> tuple:
    """The build's inputs gathered on the tensors' device from vertex
    positions (V, 3) f32 and triangle indices (n, 3) int32: (tri_lo (n, 3),
    tri_hi (n, 3), tri_verts (n, 3, 3), scene_lo (3,), scene_hi (3,)), the
    scene box over every vertex as Scene.bbox takes it."""
    tv = positions.index_select(0, indices.reshape(-1)).reshape(-1, 3, 3)
    return (tv.amin(dim=1), tv.amax(dim=1), tv, positions.amin(dim=0),
            positions.amax(dim=0))


def device_inputs(scene: Scene, device) -> tuple:
    """`inputs_from` the scene's positions and indices, each uploaded once
    to `device`."""
    return inputs_from(*(torch.from_numpy(a).to(device)
                         for a in (scene.positions, scene.indices)))


class Graphed:
    """A call on CUDA tensors recorded once as a CUDA graph and replayed at
    every later call, so that the host issues one launch in place of the
    call's hundreds of eager ones. The first call records fn(*xs); from
    then on the graph reads its own input tensors (copies of the first
    xs with own_inputs, else the first xs themselves, as when they are
    another graph's outputs), a later call copies its xs into them where
    they are other tensors, and fn's outputs, the same tensors at every
    call, hold what the latest replay wrote. The kernel launch counters
    (`counters`: functions with a `launches` attribute) gain at each
    replay what the recording launched. The recording runs fn twice on a
    side stream first (the warm-up a CUDA graph needs) and leaves the
    counters as it found them; fn must not read the device from the host.
    On the CPU fn(*xs) runs as it is, every call."""

    def __init__(self, counters: tuple = (), own_inputs: bool = False):
        self.counters = counters
        self.own_inputs = own_inputs
        self.graph = None

    def __call__(self, fn, *xs):
        if xs[0].device.type != "cuda":
            return fn(*xs)
        if self.graph is None:
            self._record(fn, xs)
        else:
            for buf, x in zip(self.xs, xs):
                if buf.data_ptr() != x.data_ptr():
                    buf.copy_(x)
        self.graph.replay()
        for c, k in zip(self.counters, self.launched):
            c.launches += k
        return self.out

    def _record(self, fn, xs):
        dev = xs[0].device
        self.xs = tuple(x.clone() for x in xs) if self.own_inputs else xs
        before = [c.launches for c in self.counters]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*self.xs)
        torch.cuda.current_stream(dev).wait_stream(side)
        start = [c.launches for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.xs)
        self.launched = [c.launches - k for c, k in zip(self.counters, start)]
        for c, k in zip(self.counters, before):
            c.launches = k


def _try(args: tuple, carry, cap, kw: dict):
    """One try of the packed or flat build: (lbvh_device_fast's dict, the
    int32 words of its read: node_count, then carry(out) where given)."""
    out = lbvh_device_fast(*args, compact_cap=cap, **kw)
    words = [out["node_count"].reshape(1)]
    if carry is not None:
        words.append(carry(out).reshape(-1).view(torch.int32))
    return out, torch.cat(words)


def _build(args: tuple, carry=None, stage: str = "build",
           spans: tuple = ("lbvh", "node_count"), graph: Graphed = None,
           **kw):
    """lbvh_device_fast with the reference's compact_cap retry: a spine-
    shaped radix tree that overflows the cap is rebuilt with the always-
    sufficient cap n. The one host read of each try is node_count, with the
    float32 values that carry(out) gives, when given, in the same copy
    (timing.read). The first try goes through `graph` where given (a
    Graphed whose inputs are `args`; carry then reads only tensors that
    stay). Spans: ntrace.<stage>.<spans[0]> around each try's build,
    ntrace.<stage>.<spans[1]> around its read. Returns (out, node_count,
    carried f32 array, retries 0 or 1)."""
    def attempt(cap):
        with timing.span(f"ntrace.{stage}.{spans[0]}"):
            if graph is not None and cap is None:
                out, words = graph(lambda *a: _try(a, carry, None, kw),
                                   *args)
            else:
                out, words = _try(args, carry, cap, kw)
        with timing.span(f"ntrace.{stage}.{spans[1]}"):
            got = timing.read(words)
        return out, int(got[0]), got[1:].view(np.float32)

    out, nc, carried = attempt(None)
    retries = int(nc > out["cap"])
    if retries:
        out, nc, carried = attempt(args[0].shape[0])
    return out, nc, carried, retries


def build_packed_read(args: tuple, max_leaf: int, carry=None, *,
                      stage: str = "build", tris_per_row: int = 12,
                      nodes_per_row: int = 1, graph: Graphed = None) -> tuple:
    """The packed device build from `inputs_from`, with the compact_cap
    retry, and what its one host read carried (`_build`, its first try
    through `graph` where given): (PackedBVH, or None when the tree has no
    internal node, carried f32 array, retries). carry(pnodes, ptris)
    gives float32 values on the device."""
    out, nc, carried, retries = _build(
        args, None if carry is None else
        (lambda o: carry(o["pnodes"], o["ptris"])), stage, graph=graph,
        max_leaf=max_leaf, emit="packed", tpr=tris_per_row,
        npr=nodes_per_row)
    packed = None if nc == 0 else PackedBVH(
        nodes8=out["pnodes"], tris12=out["ptris"], num_nodes=nc,
        num_tris=args[0].shape[0], nodes_per_row=nodes_per_row,
        tris_per_row=tris_per_row)
    return packed, carried, retries


def build_packed_from(args: tuple, max_leaf: int, *, tris_per_row: int = 12,
                      nodes_per_row: int = 1) -> PackedBVH | None:
    """The packed device build from `inputs_from` (build_packed_read);
    its one host read is node_count. None when the tree has no internal
    node (n <= max_leaf)."""
    return build_packed_read(args, max_leaf, tris_per_row=tris_per_row,
                             nodes_per_row=nodes_per_row)[0]


def _check_size(scene: Scene):
    if scene.num_tris >= MAX_TRIS:
        raise ValueError(f"LBVH: {scene.num_tris} triangles; tri ids ride a "
                         "float32 value lane, exact only below 2**24")


def _median_flat(scene: Scene, cfg: BuildConfig) -> FlatBVH:
    return flatten_bvh(build_median_bvh(scene, cfg), scene)


def build_lbvh_packed(scene: Scene, cfg: BuildConfig = BuildConfig(), *,
                      tris_per_row: int = 12, nodes_per_row: int = 1,
                      device="cuda") -> PackedBVH:
    """The device build straight to the packet kernel's tables on `device`.

    Returns a PackedBVH whose nodes8 / tris12 are tensors on `device`,
    root at row 0. The one host read is node_count (for the cap check).
    Fewer than 2 triangles, or no internal node (n <= max_leaf), take the
    reference's median-builder route, packed on the host and moved to the
    device. The per-frame rebuild of BASELINE config #4 takes the same
    device build from moved vertices (render/renderer.py:
    Renderer.update_positions).
    """
    _check_size(scene)
    n = scene.num_tris

    def host_route():
        p = pack_bvh(build_lbvh_flat(scene, cfg, device=device),
                     scene.tri_verts(), tris_per_row=tris_per_row,
                     nodes_per_row=nodes_per_row)
        p.nodes8 = torch.from_numpy(np.ascontiguousarray(p.nodes8)).to(device)
        p.tris12 = torch.from_numpy(np.ascontiguousarray(p.tris12)).to(device)
        return p

    if n < 2:
        return host_route()
    packed = build_packed_from(device_inputs(scene, device),
                               cfg.max_leaf_size, tris_per_row=tris_per_row,
                               nodes_per_row=nodes_per_row)
    return host_route() if packed is None else packed


def build_lbvh_flat(scene: Scene, cfg: BuildConfig = BuildConfig(), *,
                    device="cuda") -> FlatBVH:
    """The device build on `device`, brought back as a host FlatBVH (root at
    node 0). Fewer than 2 triangles, or no internal node, take the
    reference's median-builder route."""
    _check_size(scene)
    n = scene.num_tris
    if n < 2:
        return _median_flat(scene, cfg)
    out, nc, _, _ = _build(device_inputs(scene, device),
                           max_leaf=cfg.max_leaf_size)
    if nc == 0:   # n <= max_leaf: no internal node
        return _median_flat(scene, cfg)
    nodes = out["nodes"][:nc].cpu().numpy()
    woop = out["woop"].cpu().numpy()
    tri_index = out["tri_index"].cpu().numpy()
    root = int(out["root"])
    lc = int(out["leaf_count"])
    # Device links are dense compact ids already; move the root to 0.
    perm = np.concatenate(
        [[root], np.delete(np.arange(nc, dtype=np.int64), root)])
    remap = np.empty(nc, np.int32)
    remap[perm] = np.arange(nc, dtype=np.int32)
    nd = np.ascontiguousarray(nodes[perm])
    for lane in (12, 13):
        e = np.ascontiguousarray(nd[:, lane]).view(np.int32)
        internal = e >= 0
        e[internal] = remap[e[internal]]
        nd[:, lane] = e.view(np.float32)
    w_used = n + lc
    return FlatBVH(nodes=nd, woop=woop[:w_used],
                   tri_index=tri_index[:w_used], num_tris=n, sah_cost=0.0)
