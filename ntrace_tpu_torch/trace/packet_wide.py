"""8-wide frustum packet traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_wide.py:trace_packet_wide (394-452,
kernel 80-385), registry name `tesla_persistent_packet`. Tables are
`tables.WideTables` (host.pack_wide_bvh: one 128-lane row per 8-ary node,
child slot k at lanes 16k..16k+6, octant-addressed). Rays: orig/dirn
(R, 3) f32, tmin/tmax (R,) f32 -> tri i32, t, u, v f32. tmax is clamped to
TMAX_CAP = 1e36 at entry (packet_wide.py:407), so a hit beyond 1e36 is a
miss, and a miss reports t = min(tmax, 1e36), tri -1, u = v = 0.

A packet is 32 consecutive rays of the batch (a CUDA warp) and shares one
traversal (csrc/packet_wide.cu says how):
  - reductions over the packet's present rays (lanes past R take no part;
    dead rays do, as in the reference) in the warp's shuffle-tree order:
    origin and direction extents, direction sums, the least tmin, and the
    largest running hit t (`ptmax`, refreshed once per node/leaf phase
    alternation);
  - the octant is the sign of each direction sum (packet_common.py:
    134-142); children are visited in slot XOR octant order: the first hit
    internal child is descended, the other hit internal children are pushed
    far first, hit leaves are queued as runs first_row * 32 + rows - 1
    (STACK_DEPTH 128, QCAP 48, the node loop paused at QCAP - 8);
  - the node step's verdict (`node_hits`): every present ray slab-tests
    each child against its own running hit t (-INF for a dead ray in
    any-hit mode), and a child passes when one ray's test does
    (`ray_votes`); that alone is exact=True. exact=False, the reference
    renderer's choice, also needs the conservative packet test
    (packet_wide.py:96-175, 199-233): four corner-frustum planes around the
    dominant axis, biased by the origin box, and the t-interval along that
    axis against [max(entry, least tmin), min(exit, ptmax)]. Both take the
    slab test's relative slack (packet_common.SLAB_EPS): on the planes,
    2^-20 of the sum of the magnitudes of each plane sum's terms. A packet
    with no sign-consistent axis (degenerate) passes every child the
    interval admits, and an empty slot decodes to a leaf of row 0
    (superset-safe). Where a plane's quotients are not finite (a direction
    extent near zero on the dominant axis), the reference's planes turn NaN
    and cull every child; here such a plane passes every child. So
    exact=False visits a child only where the frustum and a ray admit it,
    a subset of exact=True's verdict at the same state (alone, the
    frustum culls nothing on a degenerate packet, which most AO and
    diffuse packets are);
  - a leaf step runs exact per-ray Moller-Trumbore on the queued row and
    folds it by (t, id); in any-hit mode the packet stops once every live
    ray has a hit.
Closest hits equal trace_packet's on every ray: culling is conservative and
the fold is order-free. Any-hit `tri`, and the work, depend on the packet.

The twin models the kernel's packets exactly: the same reductions in the
same tree order, so the octant, the frustum and the any-hit `tri` are
bit-equal to the kernel's. It steps every packet through the kernel's node
loop one node at a time; a leaf loop it evaluates at once: it tests the
queued rows in the kernel's order (top run first, each run's rows in
order) and stops where the kernel's any-hit vote stops, and the fold it
applies is a lexicographic (t, id) minimum, whose result does not depend on
the order. Rays on a CUDA device go through the kernel, rays on the CPU
through `trace_packet_wide_ref`. Nothing falls back.

What bounds the kernel on an H100: on incoherent rays, the leaf tests of
rays that share a packet but not a leaf (a packet pays for the union of its
rays' leaves); on coherent ones, the dependent node-row fetches. Left for
later: forming coherent packets for secondary rays (the renderer's sort
decides them) and spreading a leaf's (ray, triangle) pairs over the lanes
whose rays want it.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.ops.aabb import safe_inv_dir
from ntrace_tpu_torch.tables import WideTables
from ntrace_tpu_torch.trace.packet_common import (INF, INT_MAX, MAX_STEPS,
                                                  RUN_ROWS, SLAB_EPS,
                                                  SLAB_HI, SLAB_LO,
                                                  STACK_DEPTH,
                                                  check_rays, fold_hits,
                                                  hit_outputs, mt_row_best,
                                                  run_rows,
                                                  slab_child, start_work,
                                                  tally)

WARP = 32                   # rays per packet: one CUDA warp
QCAP = 48                   # leaf-queue entries per packet
NODE_PAUSE = QCAP - 8       # a node step queues at most 8 leaves
TMAX_CAP = 1.0e36
MAX_OUTER = 1 << 20         # node/leaf phase alternations per packet
DONE = -(2 ** 31)
ARITY = 8
PAIR_CHUNK = 4096           # (packet, row) pairs a twin leaf pass tests


def trace_packet_wide(tables: WideTables, orig, dirn, tmin, tmax, *,
                      any_hit: bool = False, exact: bool = False):
    """Trace rays through the wide tables. Returns (tri, t, u, v), each
    (R,)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    if not uses_kernel(orig):
        return trace_packet_wide_ref(tables, orig, dirn, tmin, tmax,
                                     any_hit=any_hit, exact=exact)
    outs = hit_outputs(orig)
    if orig.shape[0]:
        _launch(tables, orig.contiguous(), dirn.contiguous(),
                tmin.contiguous(), tmax.contiguous(), any_hit, exact, outs)
        trace_packet_wide.launches += 1
    return outs


trace_packet_wide.launches = 0   # kernel launches since the last reset


def _launch(tables: WideTables, orig, dirn, tmin, tmax, any_hit, exact,
            outs):
    """One launch of ntrace_packet_wide on the current CUDA stream; raises
    on a launch error."""
    from ntrace_tpu_torch.kernels.build import launch

    for t in (tables.nodes_w, tables.tris12):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("wide tables must be contiguous and 16-byte "
                             "aligned (node slots load as float4)")
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        launch("ntrace_packet_wide", tables.nodes_w.data_ptr(),
               tables.tris12.data_ptr(), orig.data_ptr(), dirn.data_ptr(),
               tmin.data_ptr(), tmax.data_ptr(), orig.shape[0],
               tables.nodes_w.shape[0], tables.tris12.shape[0],
               tables.tris_per_row, int(any_hit), int(exact),
               *(o.data_ptr() for o in outs), stream)


def _tree(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce (P, 32) over the packet in the warp's butterfly order (lane i
    with lane i ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1). Returns (P,)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = op(x[:, :h], x[:, h:])
    return x[:, 0]


def _pick(vals, a: torch.Tensor) -> torch.Tensor:
    """vals[a[p]][p] for a list of three (P,) tensors and axes a (P,)."""
    return torch.stack(vals, 1).gather(1, a[:, None].long())[:, 0]


def packet_frustum(o, d, tn, present) -> dict:
    """The per-packet constants of packet_wide.py:122-175 from (P, 32, 3)
    origins and directions and (P, 32) tmin; lanes where `present` is
    False take no part. Returns (P,)-shaped tensors by name."""
    inf = float("inf")
    olo = [_tree(torch.where(present, o[..., a], inf), torch.fmin)
           for a in range(3)]
    ohi = [_tree(torch.where(present, o[..., a], -inf), torch.fmax)
           for a in range(3)]
    dlo = [_tree(torch.where(present, d[..., a], inf), torch.fmin)
           for a in range(3)]
    dhi = [_tree(torch.where(present, d[..., a], -inf), torch.fmax)
           for a in range(3)]
    dsum = [_tree(torch.where(present, d[..., a], 0.0), torch.add)
            for a in range(3)]
    signs = ((dsum[0] >= 0).to(torch.int32)
             | ((dsum[1] >= 0).to(torch.int32) << 1)
             | ((dsum[2] >= 0).to(torch.int32) << 2))
    # dominant axis: sign-consistent with the largest least |d|
    sc = [torch.where(dlo[a] * dhi[a] > 0,
                      torch.fmin(dlo[a].abs(), dhi[a].abs()),
                      torch.full_like(dlo[a], -1.0)) for a in range(3)]
    A = torch.where(sc[0] >= torch.fmax(sc[1], sc[2]), 0,
                    torch.where(sc[1] >= sc[2], 1, 2)).to(torch.int64)
    degen = torch.fmax(sc[0], torch.fmax(sc[1], sc[2])) < 0
    dAl, dAh = _pick(dlo, A), _pick(dhi, A)
    sg = torch.where(dAl > 0, 1.0, -1.0).to(torch.float32)
    zero = torch.zeros_like(dAl)
    planes = []
    for bi in range(2):
        b = torch.where(A == 0, bi + 1, torch.where(A == 1, bi * 2, bi))
        dbl, dbh = _pick(dlo, b), _pick(dhi, b)
        c = (dbl / dAl, dbl / dAh, dbh / dAl, dbh / dAh)
        u_lo = torch.fmin(torch.fmin(c[0], c[1]), torch.fmin(c[2], c[3]))
        u_hi = torch.fmax(torch.fmax(c[0], c[1]), torch.fmax(c[2], c[3]))
        # n = sg * (e_b - u_lo e_A) and sg * (u_hi e_A - e_b)
        for on_a, on_b in ((sg * (0.0 - u_lo), sg), (sg * u_hi, -sg)):
            planes.append(torch.stack([
                torch.where(A == a, on_a, torch.where(b == a, on_b, zero))
                for a in range(3)], 1))
    n = torch.stack(planes, 1)                              # (P, 4, 3)
    lo3, hi3 = torch.stack(olo, 1)[:, None], torch.stack(ohi, 1)[:, None]
    bb = torch.where(n > 0, n * lo3, n * hi3)
    beta = (bb[..., 0] + bb[..., 1]) + bb[..., 2]           # (P, 4)
    babs = (bb[..., 0].abs() + bb[..., 1].abs()) + bb[..., 2].abs()
    one = torch.ones_like(dAl)
    return {
        "signs": signs, "degen": degen, "A": A, "n": n, "beta": beta,
        "babs": babs,
        "plane_pass": ~torch.isfinite(n).all(2),
        "iAl": 1.0 / torch.where(degen, one, dAh),
        "iAh": 1.0 / torch.where(degen, one, dAl),
        "oAl": _pick(olo, A), "oAh": _pick(ohi, A),
        "tn_lo": _tree(torch.where(present, tn, inf), torch.fmin),
    }


def frustum_hits(F: dict, p: torch.Tensor, row: torch.Tensor,
                 ptmax: torch.Tensor) -> torch.Tensor:
    """exact=False node test (packet_wide.py:199-233) of the 8 child slots
    of `row` (k, 128) for packets p (k,). Returns (k, 8) hit flags by
    slot."""
    rv = row.view(-1, ARITY, 16)
    lo, hi = rv[..., 0:6:2], rv[..., 1:6:2]                 # (k, 8, 3)
    n = F["n"][p][:, :, None, :]                            # (k, 4, 1, 3)
    X = n * torch.where(n > 0, hi[:, None], lo[:, None])
    d2 = (X[..., 0] + X[..., 1]) + X[..., 2]                # (k, 4, 8)
    sx = (X[..., 0].abs() + X[..., 1].abs()) + X[..., 2].abs()
    slack = -(SLAB_EPS * (sx + F["babs"][p][:, :, None]))
    ok = F["plane_pass"][p][:, :, None] | (
        d2 - F["beta"][p][:, :, None] >= slack)
    degen = F["degen"][p]
    inside = ok.all(1) | degen[:, None]
    A = F["A"][p][:, None, None].expand(-1, ARITY, 1)
    vlo, vhi = lo.gather(2, A)[..., 0], hi.gather(2, A)[..., 0]
    iAl, iAh = F["iAl"][p][:, None], F["iAh"][p][:, None]
    oAl, oAh = F["oAl"][p][:, None], F["oAh"][p][:, None]

    def span(v):
        dl, dh = v - oAl, v - oAh
        a, b, c, e = dl * iAl, dl * iAh, dh * iAl, dh * iAh
        return (torch.fmin(torch.fmin(a, b), torch.fmin(c, e)),
                torch.fmax(torch.fmax(a, b), torch.fmax(c, e)))

    (nlo, xlo), (nhi, xhi) = span(vlo), span(vhi)
    ent = torch.where(degen[:, None], -INF,
                      torch.fmax(torch.fmin(nlo, nhi), torch.tensor(-INF)))
    ext = torch.where(degen[:, None], INF,
                      torch.fmin(torch.fmax(xlo, xhi), torch.tensor(INF)))
    tn_lo = F["tn_lo"][p][:, None]
    return inside & (torch.fmax(ent, tn_lo) * SLAB_LO
                     <= torch.fmin(ext, ptmax[p][:, None]) * SLAB_HI)


class _Packets:
    """Per-packet state of the twin (first dimension the packet) and the
    per-ray state as (P, 32)."""

    def __init__(self, orig, dirn, tmin, tmax):
        r, dev = orig.shape[0], orig.device
        self.P = P = -(-r // WARP)
        pad = P * WARP - r

        def lanes(a, fill):
            if pad:
                a = torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])
            return a.reshape(P, WARP, *a.shape[1:])

        self.present = lanes(torch.ones(r, dtype=torch.bool, device=dev),
                             False)
        self.o, self.d = lanes(orig, 0.0), lanes(dirn, 1.0)
        self.inv = safe_inv_dir(self.d)
        self.tn = lanes(tmin, 0.0)
        self.ht = lanes(torch.minimum(tmax, torch.tensor(TMAX_CAP)), 0.0)
        self.live = self.present & (self.ht > self.tn)
        self.hid = torch.full((P, WARP), -1, dtype=torch.int32, device=dev)
        self.hu = torch.zeros((P, WARP), dtype=torch.float32, device=dev)
        self.hv = torch.zeros_like(self.hu)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((P, *shape), dtype=dtype, device=dev)

        self.item, self.sp, self.qn = zeros(), zeros(), zeros()
        self.steps = zeros(dtype=torch.int64)
        self.outer = zeros()
        self.leafph = zeros(dtype=torch.bool)
        self.ptmax = zeros(dtype=torch.float32)
        self.stack, self.queue = zeros(STACK_DEPTH), zeros(QCAP)

    def refresh_ptmax(self, p):
        self.ptmax[p] = _tree(torch.where(self.present[p], self.ht[p],
                                          float("-inf")), torch.fmax)


def trace_packet_wide_ref(tables: WideTables, orig, dirn, tmin, tmax, *,
                          any_hit: bool = False, exact: bool = False,
                          work: dict | None = None):
    """Plain torch twin of the wide packet kernel, on any device. `work`,
    when given, counts packet node visits into work["node_visits"] and
    triangle slot tests (live rays times rows times tris_per_row) into
    work["tri_slot_tests"], and marks the node rows and triangle rows read
    where it comes from packet_common.work_with_reads."""
    check_rays(tables, orig, dirn, tmin, tmax)
    r = orig.shape[0]
    s = _Packets(orig, dirn, tmin, tmax)
    start_work(work)
    if r:
        F = packet_frustum(s.o, s.d, s.tn, s.present)
        # A packet without a live ray can accept nothing: no walk.
        todo = s.live.any(1)
        s.refresh_ptmax(torch.nonzero(todo).squeeze(1))
        while bool(todo.any()):
            node = todo & ~s.leafph
            go = node & (s.item != DONE) & (s.qn < NODE_PAUSE)
            s.leafph |= node & ~go
            cut = go & (s.steps >= MAX_STEPS)
            s.item[cut], s.qn[cut] = DONE, 0
            p = torch.nonzero(go & ~cut).squeeze(1)
            if p.numel():
                _node_step(s, F, p, tables, exact, any_hit, work)
            leaf = todo & s.leafph & ~node
            p = torch.nonzero(leaf & (s.qn > 0)).squeeze(1)
            if p.numel():
                _leaf_loop(s, p, tables, any_hit, work)
            # The end of a leaf loop: the next phase alternation, or done.
            end = leaf & (s.qn == 0)
            s.outer[end] += 1
            again = end & (s.item != DONE) & (s.outer < MAX_OUTER)
            todo &= ~(end & ~again)
            s.leafph &= ~again
            s.refresh_ptmax(torch.nonzero(again).squeeze(1))
    out = [s.hid, s.ht, s.hu, s.hv]
    return tuple(a.reshape(-1)[:r].clone() for a in out)


def ray_votes(s: _Packets, p, row: torch.Tensor,
              any_hit: bool) -> torch.Tensor:
    """The per-ray vote of packets p (k,) on the 8 child slots of `row`
    (k, 128): each present ray slab-tests every child against its own
    running hit (-INF for a dead ray in any-hit mode), and a child passes
    when one ray's test does. Returns (k, 8) by slot."""
    o, inv = s.o[p], s.inv[p]
    ht = s.ht[p]
    if any_hit:
        ht = torch.where(s.present[p] & ~s.live[p], -INF, ht)
    args = (o[..., 0], o[..., 1], o[..., 2], inv[..., 0], inv[..., 1],
            inv[..., 2], s.tn[p], ht)
    present = s.present[p]
    return torch.stack([
        (slab_child(row[:, None, :], 16 * c, *args)[0] & present).any(1)
        for c in range(ARITY)], 1)


def node_hits(s: _Packets, F: dict, p, row: torch.Tensor, exact: bool,
              any_hit: bool) -> torch.Tensor:
    """The verdict of packets p (k,) on the 8 child slots of `row` (k, 128):
    the per-ray vote, under the packet frustum when exact is False. Both
    tests are conservative, so exact=False's verdict is a subset of
    exact=True's and loses no hit. Returns (k, 8) by slot."""
    hits = ray_votes(s, p, row, any_hit)
    return hits if exact else hits & frustum_hits(F, p, row, s.ptmax)


def _node_step(s: _Packets, F: dict, p, tables: WideTables, exact: bool,
               any_hit: bool, work):
    """Packets p visit their node (packet_wide.py:178-278)."""
    s.steps[p] += 1
    nodes = tables.nodes_w
    ref = s.item[p].clamp(0, nodes.shape[0] - 1)
    row = nodes[ref.long()]                                  # (k, 128)
    if work is not None:
        tally(work, ref, ref[:0], 0)
    hits = node_hits(s, F, p, row, exact, any_hit)
    items8 = row.view(-1, ARITY, 16)[:, :, 6].to(torch.int32)
    slot = torch.arange(ARITY, device=p.device)[None, :] ^ F["signs"][p][:,
                                                                        None]
    slot = slot.long()
    hit = hits.gather(1, slot)                     # by visiting order kk
    it = items8.gather(1, slot)
    cand = hit & (it >= 0)
    has = cand.any(1)
    first = cand.to(torch.uint8).argmax(1)
    desc = torch.where(has, it.gather(1, first[:, None])[:, 0], DONE)
    taken = torch.zeros_like(cand)
    taken[has, first[has]] = True
    push = cand & ~taken
    enq = hit & (it < 0)
    sp, qn = s.sp[p], s.qn[p]
    npush = torch.zeros_like(sp)
    nq = torch.zeros_like(qn)
    for kk in range(ARITY - 1, -1, -1):    # farthest first
        m = push[:, kk]
        s.stack[p[m], (sp + npush)[m].clamp(max=STACK_DEPTH - 1).long()] = \
            it[m, kk]
        npush += m.to(torch.int32)
        m = enq[:, kk]
        s.queue[p[m], (qn + nq)[m].clamp(max=QCAP - 1).long()] = \
            -it[m, kk] - 1
        nq += m.to(torch.int32)
    sp1 = (sp + npush).clamp(max=STACK_DEPTH)
    s.qn[p] = qn + nq
    pop = desc == DONE
    can = pop & (sp1 > 0)
    popped = s.stack[p, (sp1 - 1).clamp(min=0).long()]
    s.item[p] = torch.where(pop, torch.where(can, popped, DONE), desc)
    s.sp[p] = torch.where(can, sp1 - 1, sp1)


def _leaf_loop(s: _Packets, p, tables: WideTables, any_hit: bool, work):
    """Packets p drain their queue (packet_wide.py:281-307): the rows of
    the top run first, each run's rows in order, every live ray folding
    each row by (t, id); in any-hit mode the loop stops after the row at
    which every live ray of the packet holds a hit."""
    tris, tpr = tables.tris12, tables.tris_per_row
    qn = s.qn[p]
    # Queue entries top first: (packet slot j, entry).
    depth = torch.arange(QCAP, device=p.device)
    has = depth[None, :] < qn[:, None]
    qidx = (qn[:, None] - 1 - depth[None, :]).clamp(min=0)
    ent = s.queue[p[:, None], qidx][has]
    own = torch.nonzero(has)[:, 0]
    cnt = (ent & (RUN_ROWS - 1)) + 1
    rows = run_rows(ent >> 5, cnt).clamp(max=tris.shape[0] - 1)
    pk = torch.repeat_interleave(own, cnt.long())        # pair -> slot j
    n_pairs = torch.bincount(pk, minlength=p.numel())
    pos = torch.arange(pk.numel(), device=p.device) - torch.repeat_interleave(
        torch.cumsum(n_pairs, 0) - n_pairs, n_pairs)
    bt, bid, bu, bv = [], [], [], []
    for c in range(0, pk.numel(), PAIR_CHUNK):
        j, rr = pk[c:c + PAIR_CHUNK], rows[c:c + PAIR_CHUNK]
        pp = p[j]
        o, d = s.o[pp], s.d[pp]
        out = mt_row_best(tris[rr][:, None, :], o[..., 0], o[..., 1],
                          o[..., 2], d[..., 0], d[..., 1], d[..., 2],
                          s.tn[pp], tpr)
        for acc, x in zip((bt, bid, bu, bv), out):
            acc.append(x)
    bt, bid, bu, bv = (torch.cat(a) for a in (bt, bid, bu, bv))
    live = s.live[p]
    ht0, hid0 = s.ht[p], s.hid[p]
    # How many rows each packet tests: all of them, or fewer where the
    # any-hit vote stops the loop, or the step backstop.
    limit = n_pairs.clone()
    if any_hit:
        first = torch.full_like(hid0, INT_MAX)
        newly = live[pk] & (bt < ht0[pk])
        first.view(-1).scatter_reduce_(
            0, (pk[:, None] * WARP + torch.arange(WARP, device=p.device))
            [newly], pos[:, None].expand_as(newly)[newly].to(torch.int32),
            "amin")
        first = torch.where(live & (hid0 < 0), first, -1)
        last = first.max(1).values
        stop = last < INT_MAX
        limit = torch.where(stop, (last.long() + 1).clamp(min=1),
                            limit)
    room = MAX_STEPS - s.steps[p]
    cut = limit > room
    limit = torch.minimum(limit, room)
    s.steps[p] += limit
    keep = pos < limit[pk]
    pk, rows, bt, bid, bu, bv = (a[keep] for a in (pk, rows, bt, bid, bu, bv))
    if work is not None:
        n_live = live.sum(1)
        tally(work, rows[:0], rows, 0)
        work["tri_slot_tests"] += int(n_live[pk].sum()) * tpr
    # The fold: each live ray's lexicographic (t, id) minimum over its hit
    # and the rows tested.
    lane = torch.arange(WARP, device=p.device)
    fold = live[pk] & (bid != INT_MAX)
    hits = [x[p].reshape(-1) for x in (s.ht, s.hid, s.hu, s.hv)]
    fold_hits(*hits, (pk[:, None] * WARP + lane)[fold], bt[fold], bid[fold],
              bu[fold], bv[fold])
    s.ht[p], s.hid[p], s.hu[p], s.hv[p] = (x.view(-1, WARP) for x in hits)
    s.qn[p] = 0
    done = cut
    if any_hit:
        done = done | stop
    s.item[p[done]] = DONE
