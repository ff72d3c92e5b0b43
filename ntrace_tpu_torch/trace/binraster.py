"""The v1 screen-space primary engine, and what both screen-space engines
share: project, clip, bin (`_counts`, `bin_mcodes`, `count_pairs_fast`),
the kernel operands and `ScreenEngine`, the armed engine.

Counterpart of ntrace_tpu/trace/binraster.py: the constants (54-57),
`bin_order` (64), `pick_pmax` (75), `_project` (89-99), `_counts`
(102-179), the v0 prep `count_pairs` and `binraster_prep` (183-270),
`_bin_mcodes` (277), `count_pairs_fast` (292), `binraster_prep_fast`
(309-465), `trace_binraster_rows` (611), `pick_gmax` (660) and
`trace_binraster_primary` (669); `V1Engine` is the reference renderer's
v1 arming (renderer.py:931-964, 1111-1134). Canonical primary rays (every origin at
the camera, one tmin, one tmax) are traced by 32 x 32 pixel bins:

1. The prep bins every triangle (`_counts`), emits one (bin, triangle)
   pair per covered bin, sorts the pairs by (bin << 21 | truncated z) and
   packs them into 128-float rows of 12 triangles (lanes 10j..10j+9:
   v0 e1 e2 tid; lane 120: the row's conservative zmin). "fast" gives
   each triangle k_slots static slots, triangles over k_slots bins k2_slots
   slots through a small compaction, and those over k2_slots bins a
   z-sorted global row prefix that every bin walks first; "v0" expands
   the pairs by a cumulative sum. `row0`/`row1` give each bin's rows.
2. `trace_binraster_rows` tests each bin's 1,024 rays against the global
   prefix and its row range with Moller-Trumbore and keeps the
   lexicographic (t, id) minimum: the CUDA kernel csrc/binraster_trace.cu
   on a CUDA device, the plain torch version `trace_binraster_rows_ref` on
   the CPU. Early-z (ez_chunk > 0) skips only rows that cannot change a
   result, so both give the same bits.

Bins only cull, so the result is the closest hit with the lowest triangle
id on a tie, exactly as the BVH engines and the dense engine give it. A
prep whose static sizes were too small reports `ok` False, and
`trace_binraster_primary` poisons every hit with -2.

The arithmetic is the reference's, op for op, so that both packages bin
every triangle alike: the camera-space dot products are written out as
`(q0*f0 + q1*f1) + q2*f2`, and `lax.rsqrt` is `torch.rsqrt`. Float bin
coordinates are clamped to the grid before they are cast to int32, which
is what XLA's saturating cast followed by `clip` gives, without relying
on an out-of-range cast. `jax.lax.sort` is stable by default, so
`torch.sort(stable=True)` moves the payloads into the same order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.host import TRI_LANES, morton2d
from ntrace_tpu_torch.ops.morton import part1by1
from ntrace_tpu_torch.ray.pixeltable import pixel_table

TPB = 12                 # triangles per 128-lane row (12 * 10 lanes)
ZLANE = 120              # row lane holding the row's conservative zmin
INF = np.float32(3.0e38)
Z_MARGIN = np.float32(3e-5)   # relative slack: projection vs MT rounding
SENT = 0x7FFFFFFF        # sort key of an empty slot
TILE = 32                # bin edge in pixels: 1,024 rays, 8 rows of 128
RAY_ROWS = TILE * TILE // 128
MAX_STAGE = 32           # rows the kernel stages at once (unroll, ez_chunk)
# Pair-test elements per chunk of the plain versions (visits x rays x tris).
REF_CHUNK = 1 << 23


def bin_order(tx_bins: int, ty_bins: int) -> np.ndarray:
    """(ty * TX + tx) -> bin slot: the Morton pixel table's block order."""
    _, inv = pixel_table(tx_bins, ty_bins)
    return inv.astype(np.int32)


def pick_pmax(total: int) -> int:
    """Static pair capacity: geometric buckets, multiples of 96."""
    cap = 96 * 1024
    while cap < total * 1.15 + 96:
        cap = cap * 3 // 2
        cap -= cap % 96
    return cap


def pick_gmax(n_over: int, floor: int = 1536) -> int:
    """Static overflow bucket (a multiple of TPB)."""
    cap = floor
    while cap < n_over * 1.3 + 24:
        cap = cap * 3 // 2
        cap -= cap % 12
    return cap


def _dot3(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) . (3,) over the last axis, summed left to right."""
    return (q[..., 0] * f[0] + q[..., 1] * f[1]) + q[..., 2] * f[2]


def _project(verts: torch.Tensor, cam: dict):
    """Camera-space x, y, z of every vertex, each (n, 3)."""
    q = verts - cam["pos"]
    return _dot3(q, cam["right"]), _dot3(q, cam["up"]), _dot3(q, cam["fwd"])


def _bin_index(p: torch.Tensor, tile: int, nbins: int) -> torch.Tensor:
    ts = torch.tensor(tile, dtype=torch.float32, device=p.device)
    return torch.floor(p / ts).clamp(0, nbins - 1).to(torch.int32)


def _counts(verts: torch.Tensor, cam: dict, *, width: int, height: int,
            tile: int):
    """Per-triangle bin rectangle, pair count and conservative zmin.

    verts: (n, 3, 3) float32. Returns (tx0, tx1, ty0, ty1, cnt) int32 and
    zmin float32, each (n,). Near-plane crossers are clipped exactly at 99%
    of the nearest plane a primary hit can reach, and culled triangles get
    cnt 0 (see the reference's docstring for the exactness argument).
    """
    f32 = dict(dtype=torch.float32, device=verts.device)
    txn, tyn = width // tile, height // tile
    xc, yc, zc = _project(verts, cam)
    tanx, tany = cam["tan_x"], cam["tan_y"]
    zclip = torch.maximum(
        cam["znear"] * torch.rsqrt(1.0 + tanx * tanx + tany * tany)
        * torch.tensor(0.99, **f32), torch.tensor(1e-30, **f32))
    half_w = torch.tensor(0.5 * width, **f32)
    half_h = torch.tensor(0.5 * height, **f32)
    big = torch.tensor(3e38, **f32)
    vin = zc >= zclip                                   # (n, 3)
    wsafe = torch.where(vin, zc, torch.ones_like(zc))
    pxv = (xc / wsafe / tanx + 1.0) * half_w
    pyv = (1.0 - yc / wsafe / tany) * half_h
    minx = torch.where(vin, pxv, big).amin(dim=1)
    maxx = torch.where(vin, pxv, -big).amax(dim=1)
    miny = torch.where(vin, pyv, big).amin(dim=1)
    maxy = torch.where(vin, pyv, -big).amax(dim=1)
    anyc = torch.zeros_like(vin[:, 0])
    for i, j in ((0, 1), (1, 2), (2, 0)):
        cross = vin[:, i] != vin[:, j]
        zi, zj = zc[:, i], zc[:, j]
        # Near-parallel crossers: clamp s to the segment and also cover
        # both endpoints projected at the clip plane (reference 137-161).
        s = ((zclip - zi) / torch.where(cross, zj - zi, torch.ones_like(zi))
             ).clamp(0.0, 1.0)
        xi = xc[:, i] + s * (xc[:, j] - xc[:, i])
        yi = yc[:, i] + s * (yc[:, j] - yc[:, i])
        pxe = (xi / zclip / tanx + 1.0) * half_w
        pye = (1.0 - yi / zclip / tany) * half_h
        minx = torch.minimum(minx, torch.where(cross, pxe, big))
        maxx = torch.maximum(maxx, torch.where(cross, pxe, -big))
        miny = torch.minimum(miny, torch.where(cross, pye, big))
        maxy = torch.maximum(maxy, torch.where(cross, pye, -big))
        npar = cross & ((zj - zi).abs() < torch.tensor(1e-4, **f32) * zclip)
        for xe, ye in ((xc[:, i], yc[:, i]), (xc[:, j], yc[:, j])):
            pxn = (xe / zclip / tanx + 1.0) * half_w
            pyn = (1.0 - ye / zclip / tany) * half_h
            minx = torch.minimum(minx, torch.where(npar, pxn, big))
            maxx = torch.maximum(maxx, torch.where(npar, pxn, -big))
            miny = torch.minimum(miny, torch.where(npar, pyn, big))
            maxy = torch.maximum(maxy, torch.where(npar, pyn, -big))
        anyc = anyc | cross
    pad = torch.where(anyc, torch.tensor(2.0, **f32),
                      torch.tensor(1e-2, **f32))
    minx, maxx = minx - pad, maxx + pad
    miny, maxy = miny - pad, maxy + pad
    contrib = vin.any(dim=1)
    offscreen = (maxx < 0) | (minx > width) | (maxy < 0) | (miny > height)
    cull = ~contrib | offscreen
    tx0, tx1 = _bin_index(minx, tile, txn), _bin_index(maxx, tile, txn)
    ty0, ty1 = _bin_index(miny, tile, tyn), _bin_index(maxy, tile, tyn)
    cnt = torch.where(cull, 0, (tx1 - tx0 + 1) * (ty1 - ty0 + 1))
    zmin_v = torch.where(vin, zc, big).amin(dim=1)
    zmin = torch.where(anyc, torch.minimum(zmin_v, zclip), zmin_v)
    zmin = torch.where(cull, torch.zeros_like(zmin), zmin)
    return tx0, tx1, ty0, ty1, cnt.to(torch.int32), zmin


# -- the v0 prep: stream expansion ------------------------------------------


def count_pairs(verts, cam, *, width, height, tile):
    """Total (bin, triangle) pair count, 0-d int."""
    *_, cnt, _ = _counts(verts, cam, width=width, height=height, tile=tile)
    return cnt.sum()


def _z_key(zmin: torch.Tensor) -> torch.Tensor:
    """The 21 z bits of the fused sort key: zmin * (1 - Z_MARGIN), clamped
    at 0, its float bits truncated (>> 11), which rounds down."""
    zsafe = torch.clamp_min(zmin * float(np.float32(1.0) - Z_MARGIN), 0.0)
    return (zsafe.view(torch.int32) >> 11) & 0x1FFFFF


def _z_dec(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The conservative zmin a key's 21 z bits decode to; INF where not
    valid."""
    z = ((key & 0x1FFFFF) << 11).view(torch.float32)
    return torch.where(valid, z, torch.tensor(INF, device=key.device))


def _vert_channels(verts: torch.Tensor) -> torch.Tensor:
    """(n, 9) float32 [v0 e1 e2] with e1 = v1 - v0, e2 = v2 - v0."""
    v0 = verts[:, 0]
    return torch.cat([v0, verts[:, 1] - v0, verts[:, 2] - v0], dim=1)


def _tri_lanes(verts: torch.Tensor, tid: torch.Tensor, valid: torch.Tensor):
    """(n, 10) row lanes [v0 e1 e2 tid] of triangles `verts` (n, 3, 3); tid
    -1 where not valid."""
    return torch.cat([_vert_channels(verts), torch.where(
        valid, tid, -1).to(torch.float32)[:, None]], dim=1)


def _pack_rows(lanes: torch.Tensor, zdec: torch.Tensor) -> torch.Tensor:
    """(p, 10) lanes and (p,) decoded zmin, p a multiple of TPB, into
    (p // 12, 128) rows: slot j of row r at lanes 10j..10j+9, the row's
    least zmin at lane 120."""
    nr = lanes.shape[0] // TPB
    rows = torch.zeros((nr, 128), dtype=torch.float32, device=lanes.device)
    rows[:, :TPB * TRI_LANES] = lanes.reshape(nr, TPB * TRI_LANES)
    rows[:, ZLANE] = zdec.reshape(nr, TPB).amin(dim=1)
    return rows


def binraster_prep(verts, cam, block_bin, *, width, height, tile, p_max):
    """The v0 prep: z-sorted per-bin triangle rows by stream expansion.

    Returns (rows (p_max // 12, 128) f32, row0, row1 (nb,) i32, total 0-d
    i32). The rows are exact while total <= p_max; the caller checks.
    """
    dev = verts.device
    i32 = dict(dtype=torch.int32, device=dev)
    n = verts.shape[0]
    txn = width // tile
    nb = txn * (height // tile)
    tx0, tx1, ty0, ty1, cnt, zmin = _counts(
        verts, cam, width=width, height=height, tile=tile)
    ends = torch.cumsum(cnt, 0, dtype=torch.int32)
    starts = ends - cnt
    total = ends[-1]
    # Pair j belongs to the first triangle whose cumulative end exceeds j.
    marks = torch.zeros((p_max + 1,), **i32)
    marks.index_add_(0, ends.clamp(max=p_max).long(),
                     torch.ones_like(ends))
    tri_of = torch.cumsum(marks[:p_max], 0).clamp(max=n - 1).long()
    j = torch.arange(p_max, **i32)
    valid = j < total
    local = j - starts[tri_of]
    wbin = tx1[tri_of] - tx0[tri_of] + 1
    wbin = torch.where(wbin == 0, 1, wbin)   # padding pairs: masked below
    bx = tx0[tri_of] + torch.remainder(local, wbin)
    by = ty0[tri_of] + torch.div(local, wbin, rounding_mode="floor")
    bin_slot = block_bin[(by * txn + bx).clamp(0, nb - 1).long()]
    key = torch.where(valid, (bin_slot << 21) | _z_key(zmin[tri_of]), SENT)
    key, perm = torch.sort(key, stable=True)
    stri = tri_of[perm]
    sbin = key >> 21
    bins = torch.arange(nb, **i32)
    pair0 = torch.searchsorted(sbin, bins).to(torch.int32)
    pair1 = torch.searchsorted(sbin, bins, right=True).to(torch.int32)
    row0 = torch.div(pair0, TPB, rounding_mode="floor")
    row1 = torch.div(pair1 + TPB - 1, TPB, rounding_mode="floor")
    svalid = key != SENT
    rows = _pack_rows(_tri_lanes(verts[stri], stri, svalid),
                      _z_dec(key, svalid))
    return rows, row0, row1, total


# -- the fast prep: fixed slots and a global tier --------------------------


def bin_mcodes(txn: int, tyn: int, max_bits: int) -> np.ndarray:
    """Sorted 2D Morton codes of all bins (bin slot b has code [b]), each
    under max_bits, the bin bits of a 31-bit fused sort key."""
    bx, by = np.meshgrid(np.arange(txn), np.arange(tyn))
    mc = np.sort(morton2d(np, bx.ravel(), by.ravel()))
    if mc[-1] >= 1 << max_bits:
        raise ValueError("bin grid too large for the 31-bit fused sort "
                         "key's bin bits")
    return mc.astype(np.int32)


def _bin_mcodes(txn: int, tyn: int) -> np.ndarray:
    """The fast prep's bin codes: 10 bits (its key is bin << 21 | z)."""
    return bin_mcodes(txn, tyn, 10)


def count_pairs_fast(verts, cam, *, width, height, tile, k_slots,
                     k2_slots=64):
    """(sorted-tier pairs incl. the k2 mid tier, mid-tier triangles,
    walked-global triangles), each 0-d."""
    *_, cnt, _ = _counts(verts, cam, width=width, height=height, tile=tile)
    over = cnt > k_slots
    over2 = cnt > k2_slots
    return (torch.where(over2, 0, cnt).sum(), (over & ~over2).sum(),
            over2.sum())


def _slot_keys(k_slots, t0x, t0y, w, zb, cnt, valid):
    """Sort keys of each triangle's k_slots static slots, slot-major:
    slot k is cell k of the bin rectangle (row-major), keyed by the bin's
    Morton code << 21 | z; SENT where not valid or k >= cnt."""
    w = torch.where(w == 0, 1, w)   # a culled triangle's rectangle
    cols = []
    for k in range(k_slots):
        bx = t0x + k % w
        by = t0y + torch.div(torch.full_like(w, k), w, rounding_mode="floor")
        mc = (part1by1(by) << 1) | part1by1(bx)
        key = ((mc << 21) | zb.to(torch.int64)) & 0xFFFFFFFF
        cols.append(torch.where(valid & (k < cnt), key.to(torch.int32),
                                SENT))
    return torch.stack(cols).reshape(-1)


def _pad_rows(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """a with rows appended (value `fill`) up to n rows."""
    if a.shape[0] >= n:
        return a
    pad = torch.full((n - a.shape[0],) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def binraster_prep_fast(verts, cam, mcodes, *, width, height, tile,
                        k_slots, g_max, p_max, payload=True, k2_slots=64,
                        g2_max=192):
    """The gather-free prep: two fixed-slot tiers and a walked global tier.

    Every triangle covering at most k_slots bins owns k_slots static pair
    slots; those covering (k_slots, k2_slots] are compacted to g_max
    slots by a small z-sort and own k2_slots slots each; both tiers merge
    into one (bin, z)-keyed sort that carries the row lanes as payload
    (payload=True) or the triangle index (payload=False, the lanes then
    gathered). Triangles covering more than k2_slots bins go to a z-sorted
    prefix of g2_max triangles every bin walks first.

    Returns (rows, row0, row1, g_r1 (1,) i32, ok 0-d bool): `rows` holds
    g2_max // 12 global rows, then p_max // 12 sorted-tier rows; row0/row1
    are absolute row ranges per bin. ok is False when a static size
    overflowed (sorted pairs > p_max, overflow triangles > g_max, or
    global triangles > g2_max): the result is then incomplete.
    """
    dev = verts.device
    i32 = dict(dtype=torch.int32, device=dev)
    n = verts.shape[0]
    tx0, tx1, ty0, ty1, cnt, zmin = _counts(
        verts, cam, width=width, height=height, tile=tile)
    wbin = tx1 - tx0 + 1
    over = cnt > k_slots
    over2 = cnt > k2_slots
    n_over, n_over2 = over.sum(), over2.sum()
    zbits = _z_key(zmin)

    keys = _slot_keys(k_slots, tx0, ty0, wbin, zbits, cnt, ~over)
    # Overflow compaction: every cnt > k_slots triangle, z-ascending, the
    # first g_max of them (both the mid tier and the global tier).
    okey = _pad_rows(torch.where(over, zbits, SENT), g_max, SENT)
    oidx = _pad_rows(torch.arange(n, **i32), g_max, 0)
    sok, order = torch.sort(okey, stable=True)
    gk, gi = sok[:g_max], oidx[order][:g_max].long()
    gvalid = gk != SENT
    cntg = cnt[gi]
    midv = gvalid & (cntg <= k2_slots)
    gv = verts[gi]
    keys = _pad_rows(torch.cat([keys, _slot_keys(
        k2_slots, tx0[gi], ty0[gi], wbin[gi], gk & 0x1FFFFF, cntg, midv)]),
        p_max, SENT)

    def tiers(col_all, col_g):     # the payload of every slot, slot-major
        return _pad_rows(torch.cat([col_all.repeat(k_slots),
                                  col_g.repeat(k2_slots)]), p_max, 0)

    skey, perm = torch.sort(keys, stable=True)
    skey, perm = skey[:p_max], perm[:p_max]
    svalid = skey != SENT
    if payload:
        lanes_all = _tri_lanes(verts, torch.arange(n, **i32),
                               torch.ones(n, dtype=torch.bool, device=dev))
        lanes_g = _tri_lanes(gv, gi.to(torch.int32), torch.ones_like(gvalid))
        lanes = torch.stack([tiers(lanes_all[:, c], lanes_g[:, c])[perm]
                             for c in range(TRI_LANES)], dim=1)
        lanes[:, 9] = torch.where(svalid, lanes[:, 9], -1.0)
    else:
        stri = tiers(torch.arange(n, **i32), gi.to(torch.int32))[perm]
        lanes = _tri_lanes(verts[stri.long()], stri, svalid)
    nr = p_max // TPB
    rows_b = _pack_rows(lanes, _z_dec(skey, svalid))
    sgroup = (skey >> 21).contiguous()
    row0 = torch.div(torch.searchsorted(sgroup, mcodes), TPB,
                     rounding_mode="floor").to(torch.int32)
    row1 = torch.clamp_max(torch.div(
        torch.searchsorted(sgroup, mcodes, right=True) + TPB - 1, TPB,
        rounding_mode="floor"), nr).to(torch.int32)

    # The walked global tier: cnt > k2_slots triangles only, z-ascending.
    okey2 = torch.where(gvalid & ~midv, gk, SENT)
    sok2, gslot = torch.sort(okey2, stable=True)
    g2k = sok2[:g2_max]
    g2valid = g2k != SENT
    g2i = gi[gslot[:g2_max]]
    grows = _pack_rows(_tri_lanes(verts[g2i], g2i.to(torch.int32), g2valid),
                       _z_dec(g2k, g2valid))
    gnr = g2_max // TPB
    g_r1 = torch.div(torch.clamp_max(n_over2, g2_max) + TPB - 1, TPB,
                     rounding_mode="floor").reshape(1).to(torch.int32)
    sorted_total = torch.where(over2, 0, cnt).sum()
    ok = (sorted_total <= p_max) & (n_over <= g_max) & (n_over2 <= g2_max)
    return torch.cat([grows, rows_b]), row0 + gnr, row1 + gnr, g_r1, ok


# -- the trace: kernel and plain version ------------------------------------


def dense_rays(dirn, pos, tmin, tmax, n_bins: int, ray_rows: int):
    """Kernel ray operands of both screen-space engines: dirs
    (3 * n_bins * ray_rows, 128) f32, the components stacked (all x, then
    y, then z, in slot order), and scalars (8,) f32 [ox, oy, oz, tmin,
    tmax, 0, 0, 0]. tmin, tmax: 0-d."""
    dirs = dirn.t().reshape(3 * n_bins * ray_rows, 128)
    zero = torch.zeros((), dtype=torch.float32, device=dirn.device)
    scalars = torch.cat([pos.to(torch.float32),
                         torch.stack([tmin, tmax, zero, zero, zero])])
    return dirs, scalars


def fold_visits(tris: torch.Tensor, vbin: torch.Tensor, vtile: torch.Tensor,
                dirs: torch.Tensor, scalars: torch.Tensor, n_bins: int,
                rays_per_bin: int):
    """The plain version of every screen-space kernel: for each visit
    (vbin[i], vtile[i]), Moller-Trumbore of the bin's rays against the
    triangles of tris[vtile[i]] ((n_tiles, S, >= 10) lanes [v0 e1 e2 tid]),
    in the kernels' op order, in chunks of visits x rays x S; each ray
    keeps the lexicographic (t, id) minimum over the candidates with
    t < tmax (the kernels' accumulator starts at (tmax, -1)). Since every
    accepted t > tmin >= 0, the key (t bits << 32) | id orders like
    (t, id), and `scatter_reduce("amin")` is exact. Misses: tri -1,
    t = tmax, u = v = 0. Returns (tri, t, u, v), each
    (n_bins * rays_per_bin,)."""
    dev = tris.device
    ox, oy, oz, tn, tx = (scalars[i] for i in range(5))
    if float(tn) < 0:
        raise ValueError("the plain screen-space trace needs tmin >= 0 (its "
                         "sort key orders t by its bits)")
    r = n_bins * rays_per_bin
    d = dirs.reshape(3, n_bins, rays_per_bin)
    lane = torch.arange(rays_per_bin, device=dev)
    no_hit = torch.iinfo(torch.int64).max
    best = torch.full((r,), no_hit, dtype=torch.int64, device=dev)
    hu = torch.zeros((r,), dtype=torch.float32, device=dev)
    hv = torch.zeros((r,), dtype=torch.float32, device=dev)
    vbin, vtile = vbin.long(), vtile.long()
    step = max(REF_CHUNK // (rays_per_bin * tris.shape[1]), 1)
    for s in range(0, vbin.numel(), step):
        vb, tt = vbin[s:s + step], tris[vtile[s:s + step]][:, None]
        v0x, v0y, v0z = tt[..., 0], tt[..., 1], tt[..., 2]     # (C, 1, S)
        e1x, e1y, e1z = tt[..., 3], tt[..., 4], tt[..., 5]
        e2x, e2y, e2z = tt[..., 6], tt[..., 7], tt[..., 8]
        tid = tt[..., 9].to(torch.int32)
        dx, dy, dz = (d[c, vb][:, :, None] for c in range(3))  # (C, rpb, 1)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        c0 = e2x * qx + e2y * qy + e2z * qz
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        one = torch.ones_like(det)
        inv = one / torch.where(det == 0, one, det)
        u = (tvx * px + tvy * py + tvz * pz) * inv
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = c0 * inv
        ok = ((det != 0) & (tid >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > tn) & (t < tx))
        key = torch.where(
            ok, (t.view(torch.int32).to(torch.int64) << 32)
            | tid.to(torch.int64), no_hit)
        kmin, arg = key.min(dim=2)                              # (C, rpb)
        ray = vb[:, None] * rays_per_bin + lane[None, :]
        best.scatter_reduce_(0, ray.reshape(-1), kmin.reshape(-1), "amin")
        win = (kmin == best[ray]) & (kmin != no_hit)
        sel = arg[:, :, None]
        hu[ray[win]] = torch.gather(u, 2, sel)[..., 0][win]
        hv[ray[win]] = torch.gather(v, 2, sel)[..., 0][win]
    hit = best != no_hit
    tri = torch.where(hit, (best & 0xFFFFFFFF).to(torch.int32), -1)
    t_bits = (best >> 32).to(torch.int32).view(torch.float32)
    return tri, torch.where(hit, t_bits, tx), hu, hv


def bin_visits(row0, row1, g: int, n_bins: int):
    """Every (bin, row) visit of a bin walk: the global prefix rows [0, g),
    then the bin's rows [row0, row1). Returns (bin, row) int64 (V,)."""
    span = (row1 - row0).clamp_min(0).to(torch.int64)
    per_bin = span + g
    vbin = torch.repeat_interleave(
        torch.arange(n_bins, device=row0.device), per_bin)
    start = torch.cumsum(per_bin, 0) - per_bin
    j = torch.arange(vbin.numel(), device=row0.device) - start[vbin]
    vrow = torch.where(j < g, j, row0.to(torch.int64)[vbin] + j - g)
    return vbin, vrow


def check_operands(rows, dirs, scalars, n_bins, ray_rows, ints,
                   row_mult: int = 1):
    """Types, shapes and devices of a screen-space kernel's operands: rows
    (n, 128) f32 with n a positive multiple of row_mult, dirs and scalars
    as `dense_rays` makes them, and `ints`, (name, tensor, shape) of int32
    operands (shape None: any 1-D length)."""
    nrd = n_bins * ray_rows
    want = [("rows", rows, torch.float32, None),
            ("dirs", dirs, torch.float32, (3 * nrd, 128)),
            ("scalars", scalars, torch.float32, (8,))]
    want += [(name, a, torch.int32, shape) for name, a, shape in ints]
    for name, a, dtype, shape in want:
        if a.dtype != dtype:
            raise TypeError(f"{name}: dtype {a.dtype}, want {dtype}")
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, want {shape}")
        if dtype == torch.int32 and a.dim() != 1:
            raise ValueError(f"{name}: want a 1-D tensor")
        if a.device != rows.device:
            raise ValueError(f"{name} on {a.device}, rows on {rows.device}")
    if (rows.dim() != 2 or rows.shape[1] != 128 or rows.shape[0] % row_mult
            or rows.shape[0] == 0):
        raise ValueError(f"rows: shape {tuple(rows.shape)}, want (n, 128) "
                         f"with n a positive multiple of {row_mult}")
    if n_bins < 1 or ray_rows < 1:
        raise ValueError("n_bins and ray_rows must be >= 1")


def range_operands(row0, row1, g_r1, n_bins):
    """The int32 operands of a bin walk, for `check_operands`."""
    ints = [("row0", row0, (n_bins,)), ("row1", row1, (n_bins,))]
    return ints + ([] if g_r1 is None else [("g_r1", g_r1, (1,))])


def launch(entry: str, ints, tensors, n_rays: int, dev):
    """Allocate (tri, t, u, v) for n_rays and launch the C entry point
    `entry` on the current stream: its pointer arguments are `tensors`
    (None passes a null pointer), then the ints, then the four outputs and
    the stream. Raises on a launch error."""
    from ntrace_tpu_torch.kernels.build import launch as call

    outs = (torch.empty((n_rays,), dtype=torch.int32, device=dev),
            *(torch.empty((n_rays,), dtype=torch.float32, device=dev)
              for _ in range(3)))
    ptrs = [None if a is None else a.data_ptr() for a in tensors]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        call(entry, *ptrs, *ints, *(o.data_ptr() for o in outs), stream)
    return outs


def _check_rows(rows, row0, row1, dirs, scalars, g_r1, n_bins, unroll,
                ez_chunk):
    check_operands(rows, dirs, scalars, n_bins, RAY_ROWS,
                   range_operands(row0, row1, g_r1, n_bins))
    if not 1 <= unroll <= MAX_STAGE or not 0 <= ez_chunk <= MAX_STAGE:
        raise ValueError(f"unroll {unroll} must be in [1, {MAX_STAGE}] and "
                         f"ez_chunk {ez_chunk} in [0, {MAX_STAGE}]")


def trace_binraster_rows(rows, row0, row1, dirs, scalars, g_r1=None, *,
                         n_bins: int, unroll: int = 4, ez_chunk: int = 8):
    """Trace the prepped rows: every bin's 1,024 rays (dirs and scalars as
    `dense_rays` makes them at ray_rows 8) against the global prefix rows
    [0, g_r1) (when g_r1 is given) and the bin's rows [row0, row1).
    Returns (tri, t, u, v), each (n_bins * 1024,), in slot order; tri -1,
    t = tmax, u = v = 0 on a miss. The kernel stages `unroll` rows at a
    time; ez_chunk > 0 stages ez_chunk rows and stops a bin when the next
    row's zmin exceeds every ray's hit t. Neither changes a result."""
    _check_rows(rows, row0, row1, dirs, scalars, g_r1, n_bins, unroll,
                ez_chunk)
    if not uses_kernel(rows):
        return trace_binraster_rows_ref(rows, row0, row1, dirs, scalars,
                                        g_r1, n_bins=n_bins, unroll=unroll,
                                        ez_chunk=ez_chunk)
    ops = [a.contiguous() for a in (rows, row0, row1)]
    if ops[0].data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (rows load as "
                         "float4)")
    g = None if g_r1 is None else g_r1.contiguous()
    outs = launch("ntrace_binraster_rows",
                  (n_bins, rows.shape[0], unroll, ez_chunk),
                  (*ops, g, dirs.contiguous(), scalars.contiguous()),
                  n_bins * TILE * TILE, rows.device)
    trace_binraster_rows.launches += 1
    return outs


trace_binraster_rows.launches = 0   # kernel launches since the last reset


def trace_binraster_rows_ref(rows, row0, row1, dirs, scalars, g_r1=None, *,
                             n_bins: int, unroll: int = 4, ez_chunk: int = 8):
    """Plain torch version of the kernel, on any device: every (bin, row)
    visit through `fold_visits`. Early-z skips only rows that cannot
    change a result and staging changes no order that matters, so this
    version walks every row whatever `unroll` and `ez_chunk` say."""
    _check_rows(rows, row0, row1, dirs, scalars, g_r1, n_bins, unroll,
                ez_chunk)
    g = 0 if g_r1 is None else int(g_r1[0])
    vbin, vrow = bin_visits(row0, row1, g, n_bins)
    tris = rows[:, :TPB * TRI_LANES].reshape(-1, TPB, TRI_LANES)
    return fold_visits(tris, vbin, vrow.clamp(max=rows.shape[0] - 1), dirs,
                       scalars, n_bins, TILE * TILE)


# The renderer's v1 settings: the reference renderer's code defaults for
# what it reads from tuned.json (br_k, br_k2, br_unroll, br_ez).
V1_K_SLOTS = 8               # slots per triangle in the first tier
V1_K2_SLOTS = 64             # slots per triangle in the mid tier
V1_UNROLL = 4                # rows staged at once without early-z
V1_EZ_CHUNK = 8              # early-z after every 8 rows
# Scenes above this many triangles never arm a screen-space engine (the
# reference's NTRACE_BINRASTER_MAX_TRIS default): their sorts and tables
# scale with them.
MAX_TRIS = 3_000_000


class ScreenEngine:
    """A screen-space engine over one scene's triangles `verts` (n, 3, 3)
    f32 on the device: `arm` sizes it for a camera and frame, `trace`
    traces that canonical primary frame, `freeze` keeps one camera's
    structure. Subclasses set `name`, `tile`, `ray_rows` and give
    `bin_codes`, `count` (the static sizes, None to decline), `prep` and
    `kernel`."""
    name = tile = ray_rows = None

    def __init__(self, verts: torch.Tensor):
        self.verts = verts
        self.sizes = self.mcodes = self.cam_pos = self._frozen = None

    @property
    def armed(self) -> bool:
        return self.sizes is not None

    def arm(self, cam: dict, width: int, height: int, **given) -> bool:
        """Size the engine from one count pass (`given` fixes sizes).
        False, unarmed, for a frame that does not tile, a bin grid the
        fused sort key cannot hold, or sizes `count` declines."""
        self.sizes = self._frozen = None
        if width % self.tile or height % self.tile:
            return False
        txn, tyn = width // self.tile, height // self.tile
        try:
            mcodes = self.bin_codes(txn, tyn)
        except ValueError:
            return False
        sizes = self.count(cam, width, height, txn * tyn, **given)
        if sizes is None:
            return False
        self.sizes = dict(width=width, height=height, nb=txn * tyn, **sizes)
        self.mcodes = torch.from_numpy(mcodes).to(self.verts.device)
        self.cam_pos = cam["pos"].clone()
        return True

    def canonical(self, orig, tmin, tmax, cam) -> bool:
        """Uniform tmin == znear, uniform tmax, every origin at the armed
        camera position."""
        return bool(((tmin == cam["znear"]) & (tmax == tmax[0])
                     & (orig == self.cam_pos).all(dim=-1)).all())

    def freeze(self, cam: dict) -> float:
        """Build the structure once and keep it for traces with this very
        camera. Returns the build's wall seconds."""
        t0 = time.perf_counter()
        out = self.prep(cam)
        if self.verts.device.type == "cuda":
            torch.cuda.synchronize(self.verts.device)
        self._frozen = out, {k: v.clone() for k, v in cam.items()}
        return time.perf_counter() - t0

    def structure(self, cam: dict):
        """(rows, row0, row1, g_r1, ok): the frozen structure when it was
        built for exactly `cam` (a camera rotated in place keeps the ray
        contract but would trace stale bins), else a new prep."""
        if self._frozen is not None:
            out, fc = self._frozen
            if fc.keys() == cam.keys() and all(torch.equal(cam[k], fc[k])
                                               for k in fc):
                return out
        return self.prep(cam)

    def trace(self, dirn, tmin, tmax, cam: dict):
        """(tri, t, u, v) of the armed frame, dirn (W*H, 3) in Morton slot
        order, tmin and tmax 0-d; tri -2 on every ray when a static size
        was too small (loud, never silently wrong)."""
        rows, r0, r1, g1, ok = self.structure(cam)
        dirs, scalars = dense_rays(dirn, cam["pos"], tmin, tmax,
                                   self.sizes["nb"], self.ray_rows)
        tri, t, u, v = self.kernel(rows, r0, r1, g1, dirs, scalars)
        return torch.where(ok, tri, -2), t, u, v


class V1Engine(ScreenEngine):
    """The v1 engine: 32-pixel bins, the fast prep, the v1 kernel."""
    name, tile, ray_rows = "binraster", TILE, RAY_ROWS

    def __init__(self, verts, *, k_slots=V1_K_SLOTS, k2_slots=V1_K2_SLOTS,
                 unroll=V1_UNROLL, ez_chunk=V1_EZ_CHUNK, payload=True):
        super().__init__(verts)
        self.k_slots, self.k2_slots = k_slots, k2_slots
        self.unroll, self.ez_chunk, self.payload = unroll, ez_chunk, payload

    def bin_codes(self, txn, tyn):
        return _bin_mcodes(txn, tyn)

    def count(self, cam, width, height, nb, p_max=None, g_max=None):
        total, n_mid, n_g = (int(x) for x in count_pairs_fast(
            self.verts, cam, width=width, height=height, tile=TILE,
            k_slots=self.k_slots, k2_slots=self.k2_slots))
        return {"p_max": pick_pmax(total) if p_max is None else p_max,
                "g_max": pick_gmax(n_mid + n_g) if g_max is None else g_max,
                "g2_max": pick_gmax(n_g, floor=192)}

    def prep(self, cam):
        s = self.sizes
        return binraster_prep_fast(
            self.verts, cam, self.mcodes, width=s["width"],
            height=s["height"], tile=TILE, k_slots=self.k_slots,
            g_max=s["g_max"], p_max=s["p_max"], payload=self.payload,
            k2_slots=self.k2_slots, g2_max=s["g2_max"])

    def kernel(self, rows, r0, r1, g1, dirs, scalars):
        return trace_binraster_rows(
            rows, r0, r1, dirs, scalars, g1, n_bins=self.sizes["nb"],
            unroll=self.unroll, ez_chunk=self.ez_chunk)


def trace_binraster_primary(verts, cam, dirn, *, width, height, tile=TILE,
                            unroll=4, ez_chunk=8, p_max=None, prep="fast",
                            k_slots=8, g_max=None, payload=True, k2_slots=64):
    """Primary-ray closest hit over the full camera grid (the v1 engine).

    verts: (n, 3, 3) f32 on the device; cam: camera_arrays dict; dirn:
    (W*H, 3) unit dirs in Morton slot order, from the camera position with
    tmin = znear and tmax = zfar. W and H are multiples of 32. prep: "fast"
    (fixed slots, a V1Engine armed and traced) or "v0" (stream expansion),
    the same image. Returns (tri, t, u, v) in slot order; "fast" poisons
    every hit with -2 when a static size was too small, "v0" rebuilds at a
    bigger p_max.
    """
    if width % tile or height % tile or tile & (tile - 1):
        raise ValueError("W/H must be multiples of the power-of-two tile")
    if tile != TILE:
        raise ValueError("the kernel traces 32 x 32 pixel bins: tile must "
                         "be 32")
    if prep not in ("fast", "v0"):
        raise ValueError(f"prep must be fast or v0, not {prep!r}")
    if prep == "fast":
        eng = V1Engine(verts, k_slots=k_slots, k2_slots=k2_slots,
                       unroll=unroll, ez_chunk=ez_chunk, payload=payload)
        if not eng.arm(cam, width, height, p_max=p_max, g_max=g_max):
            raise ValueError("bin grid too large for the 31-bit fused sort "
                             "key")
        return eng.trace(dirn, cam["znear"], cam["zfar"], cam)
    txn, tyn = width // tile, height // tile
    nb = txn * tyn
    dev = verts.device
    dirs, scalars = dense_rays(dirn, cam["pos"], cam["znear"], cam["zfar"],
                               nb, RAY_ROWS)
    kw = dict(width=width, height=height, tile=tile)
    if p_max is None:
        p_max = pick_pmax(int(count_pairs(verts, cam, **kw)))
    block_bin = torch.from_numpy(bin_order(txn, tyn)).to(dev)
    rows, row0, row1, total = binraster_prep(verts, cam, block_bin,
                                             p_max=p_max, **kw)
    if int(total) > p_max:
        return trace_binraster_primary(
            verts, cam, dirn, width=width, height=height, tile=tile,
            unroll=unroll, ez_chunk=ez_chunk, prep="v0",
            p_max=pick_pmax(int(total)))
    return trace_binraster_rows(rows, row0, row1, dirs, scalars, n_bins=nb,
                                unroll=unroll, ez_chunk=ez_chunk)
