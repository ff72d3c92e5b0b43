"""Slab and Moller-Trumbore tests in torch: the op-order reference.

Counterpart of ntrace_tpu/trace/packet_common.py (slab_child :52-73,
mt_row_best :76-121), written once in torch for the twin of the CUDA
traversal kernel. Every expression keeps the reference's operation order;
`csrc/packet_trace.cu` repeats the same order in CUDA C++, so twin and
kernel agree bit for bit.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.host import TRI_LANES

INF = 3.0e38
INT_MAX = 0x7FFFFFFF


def slab_child(rec: torch.Tensor, base: int, ox, oy, oz, ix, iy, iz,
               tmin, tmax):
    """Slab-test the child whose 6 bounds start at lane `base` of the (N, 16)
    node records. NaN-suppressing min/max (torch.fmin/fmax), entry clamped
    to tmin, exit to tmax (the running hit distance).
    Returns (hit, entry t), each (N,)."""
    tlo_x = (rec[:, base + 0] - ox) * ix
    thi_x = (rec[:, base + 1] - ox) * ix
    tlo_y = (rec[:, base + 2] - oy) * iy
    thi_y = (rec[:, base + 3] - oy) * iy
    tlo_z = (rec[:, base + 4] - oz) * iz
    thi_z = (rec[:, base + 5] - oz) * iz
    begin = torch.fmax(
        torch.fmax(torch.fmin(tlo_x, thi_x), torch.fmin(tlo_y, thi_y)),
        torch.fmax(torch.fmin(tlo_z, thi_z), tmin))
    end = torch.fmin(
        torch.fmin(torch.fmax(tlo_x, thi_x), torch.fmax(tlo_y, thi_y)),
        torch.fmin(torch.fmax(tlo_z, thi_z), tmax))
    return begin <= end, begin


def mt_row_best(trow: torch.Tensor, ox, oy, oz, dx, dy, dz, tn, tpr: int):
    """Moller-Trumbore of each ray against the `tpr` slots of its own row.

    trow: (N, 128) rows, one per ray; ray components (N,).
    Returns (t, id, u, v) of each ray's lexicographic (t, id) minimum over
    its row's valid slots; a row with no valid slot gives (INF, INT_MAX),
    which a caller must never accept.
    """
    n = trow.shape[0]
    s = trow[:, : tpr * TRI_LANES].reshape(n, tpr, TRI_LANES)
    v0x, v0y, v0z = s[:, :, 0], s[:, :, 1], s[:, :, 2]
    e1x, e1y, e1z = s[:, :, 3], s[:, :, 4], s[:, :, 5]
    e2x, e2y, e2z = s[:, :, 6], s[:, :, 7], s[:, :, 8]
    tid = s[:, :, 9].to(torch.int32)          # truncation, as astype(int32)
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    one = torch.ones_like(det)
    inv = one / torch.where(det == 0, one, det)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = ((det != 0) & (tid >= 0) & (u >= 0) & (v >= 0)
             & (u + v <= 1) & (t > tn[:, None]))
    tt = torch.where(valid, t, torch.full_like(t, INF))
    ii = torch.where(valid, tid, torch.full_like(tid, INT_MAX))
    best_t = tt.min(dim=1).values
    cand = tt == best_t[:, None]
    best_id = torch.where(cand, ii, torch.full_like(ii, INT_MAX)).min(
        dim=1).values
    # first slot holding the (t, id) minimum (equal (t, id) pairs are the
    # same triangle, so their u, v agree too)
    pick = (cand & (ii == best_id[:, None])).to(torch.uint8).argmax(
        dim=1, keepdim=True)
    return (best_t, best_id, u.gather(1, pick)[:, 0],
            v.gather(1, pick)[:, 0])
