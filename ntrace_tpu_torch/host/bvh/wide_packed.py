"""8-ary lane-packed BVH for the interval packet kernel (trace/packet_wide).

One (1, 128) row per 8-ary node; child slot k occupies lanes 16k..16k+15:
    [ 0] lo.x  [ 1] hi.x  [ 2] lo.y  [ 3] hi.y  [ 4] lo.z  [ 5] hi.z
    [ 6] item  [ 7..15] unused
  item : float-encoded work item, consumed directly by the kernel --
         >= 0 : 8-ary child node index (row in nodes_w)
         <  0 : leaf rows; v = -item - 1, first tri row = v >> 5,
                v & 31 further rows follow. Exact in float32 because the
                engine requires VMEM-resident tables: tri rows < 2**19,
                so |item| < 2**24.
  Empty slots carry all-+3e38 bounds: their slab entry sits at ~3e38 which
  the kernel's packet-tmax clamp (< 1e38) always rejects.

Child slots are OCTANT-ADDRESSED (Ylitie et al.'s CWBVH ordering idea,
re-derived for packets): a child whose centroid is above/below the node
centroid on axis a gets bit a of its preferred slot; the traversal visits
slot s in increasing (s XOR packet_octant), which approximates near-first
order with pure scalar bit math -- no per-step distance reduce. Slot
collisions fall to the nearest free slot.

Triangle rows are bvh/packed.py's dense lane-packing (shared pack_tris).

Reference contract: the 64-byte 2-ary CudaBVH node (expected
src/rt/cuda/CudaBVH.cpp; SURVEY.md SS3.3) widened to the TPU row economics
measured in PERF_NOTES.md ("round-2 kernel-structure findings").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntrace_tpu_torch.host.bvh.flatten import FlatBVH
from ntrace_tpu_torch.host.bvh.packed import _decode_leaf_runs, pack_tris

ARITY = 8
EMPTY_SLAB = np.float32(3.0e38)


@dataclass
class WidePackedBVH:
    nodes_w: np.ndarray   # (NW, 128) float32, NW % 8 == 0
    tris12: np.ndarray    # (TR, 128) float32 (bvh/packed.py layout)
    num_nodes: int
    num_tris: int
    tris_per_row: int

    def nbytes(self) -> int:
        return self.nodes_w.nbytes + self.tris12.nbytes


def pack_wide_bvh(flat: FlatBVH, tri_verts: np.ndarray, *,
                  tris_per_row: int = 4) -> WidePackedBVH:
    starts, counts, children = _decode_leaf_runs(flat)
    tris12, first_slot, leaf_rows, total = pack_tris(
        flat, tri_verts, starts, counts, tris_per_row)
    tpr = tris_per_row
    first_row = first_slot // tpr

    def leaf_item(enc) -> float:
        l = int(np.searchsorted(starts, ~enc))
        return float(-(int(first_row[l]) * 32
                       + min(int(leaf_rows[l]) - 1, 31)) - 1)

    n = flat.nodes
    blo = np.stack([n[:, [0, 2, 8]], n[:, [4, 6, 10]]], axis=1)  # (N,2,3)
    bhi = np.stack([n[:, [1, 3, 9]], n[:, [5, 7, 11]]], axis=1)
    ch = children  # (N,2) int32; >=0 internal, <0 leaf (~woopRow)

    # ---- collapse binary -> 8-ary: greedily expand largest-area inner ----
    def gather_slots(b: int):
        slots = [(int(ch[b, k]), blo[b, k], bhi[b, k]) for k in range(2)]
        while len(slots) < ARITY:
            best, best_area = -1, -1.0
            for i, (enc, lo, hi) in enumerate(slots):
                if enc >= 0:
                    d = np.maximum(hi - lo, 0)
                    area = float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
                    if area > best_area:
                        best, best_area = i, area
            if best < 0:
                break
            enc, _, _ = slots.pop(best)
            slots.extend(
                (int(ch[enc, k]), blo[enc, k], bhi[enc, k]) for k in range(2))
        return slots

    order: list = [None]
    alloc = {0: 0}
    stack = [0]
    while stack:
        b = stack.pop()
        w = alloc[b]
        slots = gather_slots(b)
        order[w] = slots
        for enc, lo, hi in slots:
            if enc >= 0:
                alloc[enc] = len(order)
                order.append(None)
                stack.append(enc)

    nw = len(order)
    NW_pad = max(8, -(-nw // 8) * 8)
    nodes_w = np.zeros((NW_pad, 128), np.float32)
    for j in range(6):
        nodes_w[:, j::16] = EMPTY_SLAB  # default empty: all bounds +3e38
    # Empty items are a degenerate 1-row leaf (row 0): should a loose
    # interval test ever admit an empty slot (mixed-octant packets make
    # the conservative bound infinite), the kernel just re-tests row 0's
    # real triangles -- superset-safe -- instead of re-entering the root.
    nodes_w[:, 6::16] = -1.0

    for w, slots in enumerate(order):
        centers = np.stack([(lo + hi) * 0.5 for _, lo, hi in slots])
        mid = centers.mean(axis=0)
        taken = [False] * ARITY
        place = []
        for i, (enc, lo, hi) in enumerate(slots):
            code = int((centers[i, 0] > mid[0])
                       | ((centers[i, 1] > mid[1]) << 1)
                       | ((centers[i, 2] > mid[2]) << 2))
            place.append((code, i))
        for code, i in place:
            s = code
            for d in range(ARITY):  # nearest free slot ring
                cand = (code + d) % ARITY
                if not taken[cand]:
                    s = cand
                    break
            taken[s] = True
            enc, lo, hi = slots[i]
            b = 16 * s
            nodes_w[w, b + 0] = lo[0]
            nodes_w[w, b + 1] = hi[0]
            nodes_w[w, b + 2] = lo[1]
            nodes_w[w, b + 3] = hi[1]
            nodes_w[w, b + 4] = lo[2]
            nodes_w[w, b + 5] = hi[2]
            nodes_w[w, b + 6] = (float(alloc[enc]) if enc >= 0
                                 else leaf_item(enc))

    return WidePackedBVH(nodes_w=nodes_w, tris12=tris12, num_nodes=nw,
                         num_tris=total, tris_per_row=tpr)
