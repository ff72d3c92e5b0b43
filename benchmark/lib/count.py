"""The benchmark's frozen count of a traversal's work.

A copy of the packet kernel's torch twin (`trace/packet.py:
trace_packet_ref` with `trace/packet_common.py:work_with_reads`) as the
program had it when the benchmark was defined, reduced to what it counts:
for each ray, the while-while walk of the packet kernel (near child first,
the farther pushed with its slab entry distance, a closest-hit pop that
skips every entry whose box the ray has left, an any-hit ray that stops at
the first leaf row that accepts a hit), and per batch the node visits, the
triangle slot tests (leaf rows tested times triangles a row), and which
node records and triangle rows were read. It runs on the tables the
program built, so it counts the same work whatever kernel traces a batch;
a later change to the program's twins does not move it. It reads those
tables in the layout they had then (host/bvh/packed.py: 128-lane float32
rows of 16-lane node records and 10-lane triangle slots): `check_layout`
refuses any other, so a change of layout stops the count instead of
misreading it.
"""

from __future__ import annotations

import torch

INF = 3.0e38
INT_MAX = 0x7FFFFFFF
STACK_DEPTH = 128
MAX_STEPS = 4_000_000
DONE = -(2 ** 31)
NODE_LANES = 16
TRI_LANES = 10
SLAB_LO = 1.0 - 2.0 ** -20
SLAB_HI = 1.0 + 2.0 ** -20
OOEPS = 2.0 ** -80
# The program's tables as the count reads them (lib/program.py:
# table_layout); records and slots a row may be fewer than a row holds.
LAYOUT = {"class": "PackedTables",
          "fields": ["nodes8", "nodes_per_row", "num_nodes", "tris12",
                     "tris_per_row"],
          "node_lanes": NODE_LANES, "tri_lanes": TRI_LANES,
          "row_lanes": [128, 128], "dtypes": ["float32", "float32"]}


def check_layout(layout: dict, tables):
    """Raise ValueError unless `layout` (lib/program.py:table_layout) is
    LAYOUT and the tables decode as it says: links to nodes that exist,
    leaf rows inside the triangle table, whole triangle ids."""
    got = {k: layout.get(k) for k in LAYOUT}
    if got != LAYOUT:
        raise ValueError(f"the program's tables are {got}; the frozen count "
                         f"reads {LAYOUT}")
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    if not (1 <= npr * NODE_LANES <= 128 and 1 <= tpr * TRI_LANES <= 128):
        raise ValueError(f"{npr} node records, {tpr} triangle slots a row")
    rec = tables.nodes8[:, :npr * NODE_LANES].reshape(-1, NODE_LANES)
    enc = rec[:tables.num_nodes, 12:14]
    tid = tables.tris12[:, :tpr * TRI_LANES].reshape(-1, TRI_LANES)[:, 9]
    bad = torch.stack([
        (enc != enc.round()).sum(), (enc >= tables.num_nodes).sum(),
        (-enc - 1 >= tables.tris12.shape[0]).sum(),
        (tid != tid.round()).sum() + (tid < -1).sum()]).tolist()
    if any(bad):
        raise ValueError("the tables do not decode in the frozen layout: "
                         f"{bad} bad links, links past the nodes, leaf rows "
                         "past the rows, triangle ids")


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    eps = torch.full_like(d, OOEPS)
    return torch.ones_like(d) / torch.where(d.abs() > eps, d,
                                            torch.where(d >= 0, eps, -eps))


def _slab(rec, base, o, inv, tn, tx):
    t = [(rec[:, base + k] - o[:, k // 2]) * inv[:, k // 2] for k in range(6)]
    begin = torch.fmax(torch.fmax(torch.fmin(t[0], t[1]),
                                  torch.fmin(t[2], t[3])),
                       torch.fmax(torch.fmin(t[4], t[5]), tn))
    end = torch.fmin(torch.fmin(torch.fmax(t[0], t[1]),
                                torch.fmax(t[2], t[3])),
                     torch.fmin(torch.fmax(t[4], t[5]), tx))
    return begin * SLAB_LO <= end * SLAB_HI, begin


def _row_best(trow, o, d, tn, tpr):
    s = trow[:, :tpr * TRI_LANES].unflatten(-1, (tpr, TRI_LANES))
    v0x, v0y, v0z = s[..., 0], s[..., 1], s[..., 2]
    e1x, e1y, e1z = s[..., 3], s[..., 4], s[..., 5]
    e2x, e2y, e2z = s[..., 6], s[..., 7], s[..., 8]
    tid = s[..., 9].to(torch.int32)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
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
    valid = ((det != 0) & (tid >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > tn[:, None]))
    tt = torch.where(valid, t, torch.full_like(t, INF))
    ii = torch.where(valid, tid, torch.full_like(tid, INT_MAX))
    best_t = tt.min(dim=-1).values
    cand = tt == best_t[:, None]
    best_id = torch.where(cand, ii, torch.full_like(ii, INT_MAX)).min(
        dim=-1).values
    return best_t, best_id


class _State:
    def __init__(self, **f):
        self.__dict__.update(f)

    def take(self, keep):
        return _State(**{k: v[keep] for k, v in vars(self).items()})


def count_work(tables, orig, dirn, tmin, tmax, any_hit: bool) -> dict:
    """The packet kernel's work on these rays over `tables` (a
    PackedTables: nodes8, tris12, nodes_per_row, tris_per_row):
    {"node_visits", "slot_tests", "nodes_read", "rows_read"}, the last two
    counts of distinct node records and triangle rows read."""
    dev = orig.device
    nodes = tables.nodes8.reshape(-1)
    tris = tables.tris12
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    nodes_read = torch.zeros(tables.nodes8.shape[0] * npr, dtype=torch.bool,
                             device=dev)
    rows_read = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    work = {"node_visits": 0, "slot_tests": 0}
    ids = torch.nonzero(tmax > tmin).squeeze(1)
    n = ids.numel()

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n, *shape), dtype=dtype, device=dev)

    s = _State(o=orig[ids], d=dirn[ids], inv=_inv_dir(dirn[ids]),
               tn=tmin[ids], ht=tmax[ids], hid=zeros() - 1,
               steps=zeros(dtype=torch.int64), ref=zeros(), cnt=zeros(),
               sp=zeros(), stack_ref=zeros(STACK_DEPTH),
               stack_cnt=zeros(STACK_DEPTH),
               stack_b=zeros(STACK_DEPTH, dtype=torch.float32))
    lanes16 = torch.arange(16, device=dev)
    while s.o.shape[0]:
        s.ref = torch.where(s.steps >= MAX_STEPS,
                            torch.full_like(s.ref, DONE), s.ref)
        inner = torch.nonzero(s.ref >= 0).squeeze(1)
        leaf = torch.nonzero((s.ref < 0) & (s.ref != DONE)).squeeze(1)
        work["node_visits"] += inner.numel()
        nodes_read[s.ref[inner].long()] = True
        if inner.numel():
            _node_step(s, inner, nodes, npr, lanes16, not any_hit)
        if leaf.numel():
            _leaf_step(s, leaf, tris, tpr, any_hit, work, rows_read)
        done = s.ref == DONE
        if 2 * int(done.sum()) >= s.o.shape[0]:
            s = s.take(~done)
    work["nodes_read"] = int(nodes_read.sum())
    work["rows_read"] = int(rows_read.sum())
    return work


def _pop(s, p, cull: bool):
    sp = s.sp[p]
    if cull:
        ht = s.ht[p]
        while True:
            top = (sp - 1).clamp(min=0).long()
            drop = (sp > 0) & (s.stack_b[p, top] * SLAB_LO > ht * SLAB_HI)
            if not bool(drop.any()):
                break
            sp = sp - drop.to(sp.dtype)
    has = sp > 0
    q, top = p[has], (sp[has] - 1).long()
    s.ref[q] = s.stack_ref[q, top]
    s.cnt[q] = s.stack_cnt[q, top]
    s.sp[p] = torch.where(has, sp - 1, sp)
    s.ref[p[~has]] = DONE


def _node_step(s, i, nodes, npr, lanes16, cull: bool):
    s.steps[i] += 1
    node = s.ref[i].long()
    rec = nodes[((node // npr) * 128 + (node % npr) * NODE_LANES)[:, None]
                + lanes16]
    o, inv, tn, ht = s.o[i], s.inv[i], s.tn[i], s.ht[i]
    h0, b0 = _slab(rec, 0, o, inv, tn, ht)
    h1, b1 = _slab(rec, 6, o, inv, tn, ht)
    lanes = rec[:, 12:16].to(torch.int32)
    enc0, enc1, cnt0, cnt1 = lanes[:, 0], lanes[:, 1], lanes[:, 2], lanes[:, 3]
    both = h0 & h1
    first0 = b0 <= b1
    sp = s.sp[i]
    pushed = i[both]
    slot = sp[both].clamp(max=STACK_DEPTH - 1).long()
    s.stack_ref[pushed, slot] = torch.where(first0, enc1, enc0)[both]
    s.stack_cnt[pushed, slot] = torch.where(first0, cnt1, cnt0)[both]
    if cull:
        s.stack_b[pushed, slot] = torch.where(first0, b1, b0)[both]
    s.sp[i] = torch.where(both, (sp + 1).clamp(max=STACK_DEPTH), sp)
    done = torch.full_like(enc0, DONE)
    s.ref[i] = torch.where(both, torch.where(first0, enc0, enc1),
                           torch.where(h0, enc0, torch.where(h1, enc1, done)))
    s.cnt[i] = torch.where(both, torch.where(first0, cnt0, cnt1),
                           torch.where(h0, cnt0, cnt1))
    _pop(s, i[~(h0 | h1)], cull)


def _leaf_step(s, i, tris, tpr, any_hit, work, rows_read):
    s.steps[i] += 1
    row0 = (-s.ref[i] - 1).long()
    cnt = s.cnt[i].clamp(min=1)
    o, d, tn = s.o[i], s.d[i], s.tn[i]
    ht, hid = s.ht[i], s.hid[i]
    for k in range(int(cnt.max())):
        m = k < cnt
        if any_hit:
            m &= hid < 0
        rows = row0[m] + k
        work["slot_tests"] += rows.numel() * tpr
        rows_read[rows] = True
        bt, bid = _row_best(tris[rows], o[m], d[m], tn[m], tpr)
        acc = (bid != INT_MAX) & ((bt < ht[m]) | ((bt == ht[m])
                                                  & (bid < hid[m])))
        ht[m] = torch.where(acc, bt, ht[m])
        hid[m] = torch.where(acc, bid, hid[m])
    s.ht[i], s.hid[i] = ht, hid
    if any_hit:
        hit = hid >= 0
        s.ref[i[hit]] = DONE
        i = i[~hit]
    _pop(s, i, not any_hit)
