"""The dense screen-space primary engine: torch prep v5 and two CUDA kernels.

Counterpart of ntrace_tpu/trace/binraster_dense.py. Canonical primary rays
(every origin at the camera, one tmin, one tmax) are traced by screen bins
of tile x tile pixels instead of by BVH traversal:

1. The count passes (`count_pairs_dense`, `count_hist_dense`) bin every
   triangle (`trace/binraster.py:_counts`) and size the static buffers.
2. `binraster_prep_dense5` emits one (bin, triangle) pair per covered bin,
   sorts the pairs by (bin Morton code << 12 | truncated z) and packs them
   into (8, 128) float tiles of 88 triangles, lanes 11g..11g+10 of each
   sublane holding [v0 e1 e2 tid zmin] of group g. Triangles that cover
   more than `k_cap` bins go to a z-sorted global tier that every bin
   walks first. `row0`/`row1` give each bin's tile range.
3. A kernel tests each bin's rays against the global tier and its tile
   range with Moller-Trumbore and keeps the lexicographic (t, id) minimum:
   `trace_dense_rows` (csrc/dense_trace.cu, dense_walk, with optional
   early-z), `trace_dense_rows_dma` (dense_dma: the same walk, tiles
   double-buffered through cp.async), or `trace_dense_visits`
   (csrc/dense_visits.cu: one block per (tile, bin) visit of the list
   `build_visit_list` makes, each ray's minimum kept by a 64-bit atomic
   minimum on its (t, id) key). All three are bit-identical.

Bins only cull, so the result is the closest hit with the lowest triangle
id on a tie, exactly as the BVH engines give it. A prep whose static sizes
turn out too small reports `ok` False, and `DenseEngine.trace` then
poisons every hit with -2: loud, never silently wrong.

A CUDA tensor launches the kernel; a CPU tensor runs the plain torch
version (`trace_dense_rows_ref`, `trace_dense_visits_ref`). Only prep v5
is ported: v2, v3 and v4 were superseded on the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.ops.morton import part1by1
from ntrace_tpu_torch.trace.binraster import (INF, Z_MARGIN, ScreenEngine,
                                              _counts, _pad_rows, _tri_lanes,
                                              _vert_channels, bin_mcodes,
                                              bin_visits, check_operands,
                                              count_pairs_fast, fold_visits,
                                              launch, range_operands)

GPT = 8          # tris per group (sublanes)
GROUPS = 11      # groups per (8, 128) tile
TPT = GPT * GROUPS   # 88 tris per tile
CPL = 11         # lanes per group: v0(3) e1(3) e2(3) tid zmin
SENT = 0x7FFFFFFF    # sort key of an empty slot
Z_BITS = 12          # low key bits holding truncated z; bins get the rest
KERNELS = ("walk", "dma", "visits")


def pick_cap(total: int, quantum: int, slack: float = 1.05,
             pad: int = 1024) -> int:
    """Near-exact static capacity: ceil(total * slack + pad) to quantum."""
    cap = int(total * slack) + pad
    cap += (-cap) % quantum
    return max(cap, quantum)


def pick_nks(cnt_hist, quantum: int = 2048, slack: float = 1.05,
             pad: int = 64):
    """Slice lengths for prep v5 from the count pass.

    cnt_hist[k] = #{triangles with cnt > k}, k < k_cap (descending). Each
    length is quantised up with slack and pad; trailing zero slices are
    dropped.
    """
    n_ks = []
    for nk in np.asarray(cnt_hist).tolist():
        if nk == 0:
            break
        q = int(nk * slack) + pad
        q += (-q) % quantum
        n_ks.append(q)
    return tuple(n_ks)


# (sorted-tier pairs incl. mid tier, mid-tier tris, global tris): the v1
# engine's three counts, at the dense tile and k_slots = k2_slots = k_cap.
count_pairs_dense = count_pairs_fast


def count_hist_dense(verts, cam, *, width, height, tile, k_cap=64):
    """(total pairs, N_k histogram (k_cap,), global-tier count), where
    N_k = #{included tris with cnt > k}."""
    *_, cnt, _ = _counts(verts, cam, width=width, height=height, tile=tile)
    over2 = cnt > k_cap
    cntc = torch.where(over2 | (cnt <= 0), 0, cnt)
    ks = torch.arange(k_cap, dtype=torch.int32, device=cnt.device)
    hist = (cntc[:, None] > ks[None, :]).sum(dim=0)
    return cntc.sum(), hist, over2.sum()


def _pack_dense(lanes: torch.Tensor, zdec: torch.Tensor, p_cap: int):
    """(p_cap, 10) lanes + (p_cap,) zmin -> (p_cap // 88 * 8, 128) tiles.

    Pair p lands in tile p // 88, sublane (p % 88) // 11, group p % 11: a
    plain reshape of the (p, 11) columns.
    """
    nt = p_cap // TPT
    cols = torch.cat([lanes, zdec[:, None]], dim=1)
    out = torch.zeros((nt * GPT, 128), dtype=torch.float32,
                      device=lanes.device)
    out[:, :GROUPS * CPL] = cols.reshape(nt * GPT, GROUPS * CPL)
    return out


def binraster_prep_dense5(verts, cam, mcodes, *, width, height, tile,
                          p_max, n_ks, k_cap=64, g2_max=0, z_bits=12):
    """Prep v5: zero-gather pair emission by prefix slices of a
    cnt-descending triangle sort, then one pair-level key sort.

    verts (n, 3, 3) f32; cam: camera_arrays dict; mcodes (nb,) i32 from
    `bin_mcodes`; n_ks from `pick_nks`; p_max >= sum(n_ks), a multiple of
    88. Returns (rows (g2_max//88*8 + p_max//88*8, 128) f32, row0, row1
    (nb,) i32 tile ranges, g_r1 (1,) i32 global-tier tiles or None when
    g2_max is 0, ok 0-d bool).
    """
    binraster_prep_dense5.calls += 1
    dev = verts.device
    i32 = dict(dtype=torch.int32, device=dev)
    n = verts.shape[0]
    zshift = 32 - z_bits
    zmask = (1 << z_bits) - 1
    tx0, tx1, ty0, ty1, cnt, zmin = _counts(
        verts, cam, width=width, height=height, tile=tile)
    wbin = tx1 - tx0 + 1
    zsafe = torch.clamp_min(zmin * float(np.float32(1.0) - Z_MARGIN), 0.0)
    zb = (zsafe.view(torch.int32) >> zshift) & zmask
    over2 = cnt > k_cap
    incl = ~over2 & (cnt > 0)
    cntc = torch.where(incl, cnt, 0)
    total = cntc.sum()

    # 1. cnt-descending triangle sort (stable, as lax.sort), with all 13
    #    per-triangle channels moved by the permutation.
    skey = torch.where(incl, -cnt, SENT)
    chans = torch.cat([
        _vert_channels(verts).view(torch.int32),
        torch.arange(n, **i32)[:, None],                    # tid
        (tx0 | (ty0 << 10) | (wbin << 20))[:, None],        # packed rect
        zb[:, None], cntc[:, None]], dim=1)
    tri_tbl = chans[torch.sort(skey, stable=True).indices]  # (n, 13)

    # 2. Prefix-slice emission: slice k is the first n_ks[k] rows, which
    #    hold every triangle covering more than k bins.
    if n_ks:
        tri_tbl = _pad_rows(tri_tbl, max(n_ks), 0)          # cnt 0: masked
        pairs = torch.cat([tri_tbl[:nk] for nk in n_ks])
        kcol = torch.cat([torch.full((nk,), k, **i32)
                          for k, nk in enumerate(n_ks)])
    else:   # nothing visible: every slot pads to SENT below
        pairs = torch.zeros((0, 13), **i32)
        kcol = torch.zeros((0,), **i32)
    caps_ok = pairs.shape[0] <= p_max   # a truncation would drop pairs
    pairs = _pad_rows(pairs, p_max, 0)[:p_max]
    kcol = _pad_rows(kcol, p_max, 0)[:p_max]

    valid = kcol < pairs[:, 12]
    ch1 = pairs[:, 10]
    tx0p, ty0p = ch1 & 1023, (ch1 >> 10) & 1023
    wp = torch.clamp_min((ch1 >> 20) & 2047, 1)
    bx = tx0p + kcol % wp
    by = ty0p + torch.div(kcol, wp, rounding_mode="floor")
    mc = (part1by1(by) << 1) | part1by1(bx)
    key = torch.where(valid, ((mc << z_bits) | pairs[:, 11]).to(torch.int32),
                      SENT)

    # 3. Pair-level key sort (stable) carrying the payload.
    skey2, perm = torch.sort(key, stable=True)
    pay = pairs[perm]
    svalid = skey2 != SENT
    lanes = torch.cat([
        pay[:, :9].view(torch.float32),
        torch.where(svalid, pay[:, 9], -1).to(torch.float32)[:, None]],
        dim=1)
    zdec = ((skey2 & zmask) << zshift).view(torch.float32)
    zdec = torch.where(svalid, zdec, torch.tensor(INF, device=dev))
    rows_b = _pack_dense(lanes, zdec, p_max)

    # Tile ranges per bin: first tile whose max reaches the bin, first
    # tile whose min passes it. Straddle tiles hold neighbours' pairs or
    # tid -1 pad: extra exact tests, never a different closest hit.
    gt = (skey2 >> z_bits).reshape(p_max // TPT, TPT)
    row0 = torch.searchsorted(gt[:, TPT - 1].contiguous(), mcodes)
    row1 = torch.searchsorted(gt[:, 0].contiguous(), mcodes, right=True)
    row0, row1 = row0.to(torch.int32), row1.to(torch.int32)

    # ok: every pair emitted (slice k covered all cnt > k triangles) and
    # every static size held.
    ks = torch.arange(len(n_ks), **i32)
    nk_true = (cntc[:, None] > ks[None, :]).sum(dim=0)
    nk_static = torch.tensor(list(n_ks), dtype=torch.int64, device=dev)
    n_over2 = over2.sum()
    ok = ((total <= p_max) & (nk_true <= nk_static).all()
          & (cntc.max() <= len(n_ks)) & caps_ok & (n_over2 <= g2_max))
    if g2_max == 0:
        return rows_b, row0, row1, None, ok

    # Walked global tier, z-ascending.
    okey2 = torch.where(over2, zb, SENT)
    sok2, g2i = torch.sort(okey2, stable=True)
    g2k = _pad_rows(sok2, g2_max, SENT)[:g2_max]
    g2i = _pad_rows(g2i, g2_max, 0)[:g2_max]
    g2valid = g2k != SENT
    glanes = _tri_lanes(verts[g2i], g2i, g2valid)
    gzdec = (g2k << zshift).view(torch.float32)
    gzdec = torch.where(g2valid, gzdec, torch.tensor(INF, device=dev))
    grows = _pack_dense(glanes, gzdec, g2_max)
    g_r1 = torch.div(torch.clamp_max(n_over2, g2_max) + TPT - 1, TPT,
                     rounding_mode="floor").reshape(1).to(torch.int32)
    gnt = g2_max // TPT
    rows = torch.cat([grows, rows_b])
    return rows, row0 + gnt, row1 + gnt, g_r1, ok


binraster_prep_dense5.calls = 0   # preps run since the last reset


def _check(rows, row0, row1, dirs, scalars, g_r1, n_bins, ray_rows):
    check_operands(rows, dirs, scalars, n_bins, ray_rows,
                   range_operands(row0, row1, g_r1, n_bins), row_mult=GPT)


def _run(entry: str, rows, row0, row1, dirs, scalars, g_r1, n_bins,
         ray_rows, extra):
    """Launch one C entry point of dense_trace.cu on the current stream.
    Returns (tri, t, u, v)."""
    ops = [a.contiguous() for a in (rows, row0, row1, dirs, scalars)]
    if ops[0].data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (tiles load as "
                         "float4)")
    g = None if g_r1 is None else g_r1.contiguous()
    return launch(entry, (n_bins, ray_rows, rows.shape[0] // GPT, *extra),
                  (*ops[:3], g, *ops[3:]), n_bins * ray_rows * 128,
                  rows.device)


def trace_dense_rows(rows, row0, row1, dirs, scalars, g_r1=None, *,
                     n_bins: int, ray_rows: int, ez_chunk: int = 4):
    """Trace prepped dense tiles (the walk kernel). dirs and scalars as
    `dense_rays` makes them. Returns (tri, t, u, v), each
    (n_bins * ray_rows * 128,), in slot order; tri -1, t = tmax,
    u = v = 0 on a miss. ez_chunk > 0 turns on early-z: after every
    ez_chunk tiles a bin stops when the next tile's zmin exceeds every
    ray's hit t. That skips only tiles that cannot change a result."""
    _check(rows, row0, row1, dirs, scalars, g_r1, n_bins, ray_rows)
    if ez_chunk < 0:
        raise ValueError(f"ez_chunk {ez_chunk} < 0")
    if not uses_kernel(rows):
        return trace_dense_rows_ref(rows, row0, row1, dirs, scalars, g_r1,
                                    n_bins=n_bins, ray_rows=ray_rows,
                                    ez_chunk=ez_chunk)
    outs = _run("ntrace_dense_walk", rows, row0, row1, dirs, scalars, g_r1,
                n_bins, ray_rows, (ez_chunk,))
    trace_dense_rows.launches += 1
    return outs


trace_dense_rows.launches = 0   # kernel launches since the last reset


def trace_dense_rows_dma(rows, row0, row1, dirs, scalars, g_r1=None, *,
                         n_bins: int, ray_rows: int):
    """`trace_dense_rows` without early-z, with the tiles double-buffered
    through cp.async (the dma kernel). Bit-identical results."""
    _check(rows, row0, row1, dirs, scalars, g_r1, n_bins, ray_rows)
    if not uses_kernel(rows):
        return trace_dense_rows_ref(rows, row0, row1, dirs, scalars, g_r1,
                                    n_bins=n_bins, ray_rows=ray_rows)
    outs = _run("ntrace_dense_dma", rows, row0, row1, dirs, scalars, g_r1,
                n_bins, ray_rows, ())
    trace_dense_rows_dma.launches += 1
    return outs


trace_dense_rows_dma.launches = 0   # kernel launches since the last reset


def _tiles(rows: torch.Tensor) -> torch.Tensor:
    """(n_tiles, 88, 11) triangle lanes of the (n_tiles * 8, 128) tiles."""
    nt = rows.shape[0] // GPT
    return rows.reshape(nt, GPT, 128)[:, :, :GROUPS * CPL].reshape(
        nt, TPT, CPL)


def trace_dense_rows_ref(rows, row0, row1, dirs, scalars, g_r1=None, *,
                         n_bins: int, ray_rows: int, ez_chunk: int = 0):
    """Plain torch version of the walk and dma kernels, on any device.

    It enumerates every (bin, tile) visit and folds them with
    `binraster.fold_visits` (Moller-Trumbore in the kernels' op order, an
    exact (t, id) minimum per ray). Early-z skips only tiles that cannot
    change a result, so this version walks every tile whatever `ez_chunk`
    says: a kernel with early-z on must still equal it bit for bit.
    """
    _check(rows, row0, row1, dirs, scalars, g_r1, n_bins, ray_rows)
    if ez_chunk < 0:
        raise ValueError(f"ez_chunk {ez_chunk} < 0")
    g = 0 if g_r1 is None else int(g_r1[0])
    vbin, vtile = bin_visits(row0, row1, g, n_bins)
    return fold_visits(_tiles(rows), vbin, vtile, dirs, scalars, n_bins,
                       ray_rows * 128)


# -- the visit-list kernel -------------------------------------------------
#
# One (tile, bin) visit per list entry, bin-contiguous: each bin's global
# tiles first, then its own range, at least one visit per bin. A filler
# visit (an empty bin's floor visit, the padding up to v_cap) re-tests a
# real tile: every tested pair runs the exact Moller-Trumbore predicate,
# and a triangle whose projection misses a bin cannot meet its rays, so
# extra tests change no closest hit. There is no early-z.


def visit_cap(p_max: int, nb: int, g2_max: int = 0) -> int:
    """Static bound on the visit count (a multiple of 8): every tile holds
    pairs of at most (bins it straddles) bins, one straddle and the floor
    visit per bin, plus each bin's global prefix."""
    nt = p_max // TPT
    v = nt + 2 * nb + nb * (g2_max // TPT)
    return v + (-v) % 8


def build_visit_list(row0, row1, g_r1, *, v_cap: int, nb: int):
    """Expand per-bin tile ranges into (vis_tile, vis_bin) int32 arrays of
    static length v_cap, bin-contiguous; padding visits repeat the last
    real visit's tile under bin nb - 1. No host read: the sizes are
    static."""
    dev = row0.device
    i64 = dict(dtype=torch.int64, device=dev)
    g = (torch.zeros((), **i64) if g_r1 is None
         else g_r1[0].to(torch.int64))
    r0, r1 = row0.to(torch.int64), row1.to(torch.int64)
    nv = torch.clamp_min(r1 - r0, 1) + g
    voffs = torch.cumsum(nv, 0) - nv
    total = nv.sum()
    # Each bin's first visit marks its slot; a running max spreads it.
    first = torch.zeros((v_cap + 1,), **i64)
    first.scatter_reduce_(0, voffs.clamp(max=v_cap),
                          torch.arange(nb, **i64), "amax")
    bin_of_v = torch.cummax(first[:v_cap], 0).values
    v = torch.arange(v_cap, **i64)
    slot = v - voffs[bin_of_v]
    r0b, r1b = r0[bin_of_v], r1[bin_of_v]
    tile = torch.where(slot < g, slot, torch.minimum(
        r0b + slot - g, torch.maximum(r1b - 1, r0b)))
    valid = v < total
    last = tile[(total - 1).clamp(0, v_cap - 1)]
    tile = torch.where(valid, tile, last)
    binv = torch.where(valid, bin_of_v, nb - 1)
    return tile.to(torch.int32), binv.to(torch.int32)


def _check_visits(rows, vis_tile, vis_bin, dirs, scalars, n_bins, ray_rows):
    check_operands(rows, dirs, scalars, n_bins, ray_rows,
                   [("vis_tile", vis_tile, None), ("vis_bin", vis_bin,
                                                   tuple(vis_tile.shape))],
                   row_mult=GPT)


def trace_dense_visits(rows, vis_tile, vis_bin, dirs, scalars, *,
                       n_bins: int, ray_rows: int):
    """Trace prepped dense tiles through the visit-list kernel: each visit
    tests its bin's rays against tile vis_tile[i] (clamped to the table)
    for bin vis_bin[i]. dirs and scalars as `dense_rays` makes them;
    tmin >= 0. Returns (tri, t, u, v), each (n_bins * ray_rows * 128,), in
    slot order, bit-equal to `trace_dense_rows` on the visits
    `build_visit_list` makes."""
    _check_visits(rows, vis_tile, vis_bin, dirs, scalars, n_bins, ray_rows)
    if not uses_kernel(rows):
        return trace_dense_visits_ref(rows, vis_tile, vis_bin, dirs,
                                      scalars, n_bins=n_bins,
                                      ray_rows=ray_rows)
    if float(scalars[3]) < 0:
        raise ValueError("trace_dense_visits needs tmin >= 0: its 64-bit "
                         "(t, id) key orders t by its bits")
    ops = [a.contiguous() for a in (rows, vis_tile, vis_bin, dirs,
                                    scalars)]
    if ops[0].data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (tiles load as "
                         "float4)")
    r = n_bins * ray_rows * 128
    keys = torch.empty((r,), dtype=torch.int64, device=rows.device)
    outs = launch("ntrace_dense_visits",
                  (vis_tile.shape[0], n_bins, ray_rows,
                   rows.shape[0] // GPT), (*ops, keys), r, rows.device)
    trace_dense_visits.launches += 1
    return outs


trace_dense_visits.launches = 0   # kernel launches since the last reset


def trace_dense_visits_ref(rows, vis_tile, vis_bin, dirs, scalars, *,
                           n_bins: int, ray_rows: int):
    """Plain torch version of the visit-list kernel: it walks the list
    itself, each visit's tile index clamped to the table, through
    `binraster.fold_visits`."""
    _check_visits(rows, vis_tile, vis_bin, dirs, scalars, n_bins, ray_rows)
    nt = rows.shape[0] // GPT
    return fold_visits(_tiles(rows), vis_bin, vis_tile.clamp(0, nt - 1),
                       dirs, scalars, n_bins, ray_rows * 128)


# The renderer's dense settings: the reference renderer's code defaults for
# what it reads from tuned.json (br2_tile, br2_kcap, br2_ez,
# br2_max_pairs). The prep is always v5.
DENSE_TILE = 16              # bin edge in pixels
DENSE_K_CAP = 64             # a triangle over more bins: the global tier
DENSE_EZ_CHUNK = 0           # early-z off
DENSE_MAX_PAIRS = 2_000_000  # pair budget; above it the BVH path serves


class DenseEngine(ScreenEngine):
    """The dense engine: tile x tile pixel bins, prep v5 and the kernel
    `kernel` ("walk", "dma" or "visits"; bit-identical), as the reference
    renderer arms it (renderer.py:966-1027). `max_pairs` (None: no budget)
    bounds the exact count and the armed p_max: the reference gates only
    on the count (ADVICE r5, renderer.py:1009), but p_max, over the
    quantised slices, is what every prep op and the tile table scale
    with."""
    name = "binraster_dense"

    def __init__(self, verts, *, kernel="walk", tile=DENSE_TILE,
                 k_cap=DENSE_K_CAP, ez_chunk=DENSE_EZ_CHUNK,
                 max_pairs=DENSE_MAX_PAIRS):
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, not "
                             f"{kernel!r}")
        super().__init__(verts)
        self.tile, self.ray_rows = tile, tile * tile // 128
        self.kernel_name, self.k_cap = kernel, k_cap
        self.ez_chunk, self.max_pairs = ez_chunk, max_pairs

    def bin_codes(self, txn, tyn):
        return bin_mcodes(txn, tyn, 31 - Z_BITS)

    def count(self, cam, width, height, nb, p_max=None):
        kw = dict(width=width, height=height, tile=self.tile)
        total, n_mid, n_g = (int(x) for x in count_pairs_dense(
            self.verts, cam, k_slots=self.k_cap, k2_slots=self.k_cap, **kw))
        cap = self.max_pairs
        if cap is not None and total + n_mid > cap:
            return None
        _, hist, _ = count_hist_dense(self.verts, cam, k_cap=self.k_cap,
                                      **kw)
        n_ks = pick_nks(hist.cpu().numpy())
        p_max = pick_cap(sum(n_ks), 16 * TPT) if p_max is None else p_max
        if cap is not None and p_max > cap:
            return None
        g2_max = pick_cap(n_g, TPT, pad=TPT) if n_g else 0
        return {"p_max": p_max, "n_ks": n_ks, "g2_max": g2_max,
                "v_cap": visit_cap(p_max, nb, g2_max)}

    def prep(self, cam):
        s = self.sizes
        return binraster_prep_dense5(
            self.verts, cam, self.mcodes, width=s["width"],
            height=s["height"], tile=self.tile, k_cap=self.k_cap,
            p_max=s["p_max"], n_ks=s["n_ks"], g2_max=s["g2_max"],
            z_bits=Z_BITS)

    def kernel(self, rows, r0, r1, g1, dirs, scalars):
        kw = dict(n_bins=self.sizes["nb"], ray_rows=self.ray_rows)
        if self.kernel_name == "visits":
            vt, bv = build_visit_list(r0, r1, g1, v_cap=self.sizes["v_cap"],
                                      nb=kw["n_bins"])
            return trace_dense_visits(rows, vt, bv, dirs, scalars, **kw)
        if self.kernel_name == "dma":
            return trace_dense_rows_dma(rows, r0, r1, dirs, scalars, g1,
                                        **kw)
        return trace_dense_rows(rows, r0, r1, dirs, scalars, g1,
                                ez_chunk=self.ez_chunk, **kw)


def trace_dense_primary(verts, cam, dirn, *, width, height, tile=16,
                        ez_chunk=4, p_max=None, k_cap=64, sort_mode="v5",
                        kernel="walk"):
    """Primary-ray closest hit over the full camera grid: a DenseEngine
    with no pair budget, armed and traced.

    verts: (n, 3, 3) f32 on the device; cam: camera_arrays dict; dirn:
    (W*H, 3) unit dirs in Morton slot order, from the camera position with
    tmin = znear and tmax = zfar. W and H are multiples of the
    power-of-two tile. Returns (tri, t, u, v) in slot order; tri -2 on
    every ray when a static size was too small.
    """
    if sort_mode != "v5":
        raise NotImplementedError(
            f"sort_mode {sort_mode!r}: only prep v5 is ported (v2-v4 were "
            "measured and superseded, PERF_NOTES.md:593-644)")
    if width % tile or height % tile or tile & (tile - 1):
        raise ValueError("W/H must be multiples of the power-of-two tile")
    if (tile * tile) % 128:
        raise ValueError("tile*tile must be a multiple of 128")
    eng = DenseEngine(verts, kernel=kernel, tile=tile, k_cap=k_cap,
                      ez_chunk=ez_chunk, max_pairs=None)
    if not eng.arm(cam, width, height, p_max=p_max):
        raise ValueError("bin grid exceeds the fused sort key's bin bits")
    return eng.trace(dirn, cam["znear"], cam["zfar"], cam)
