"""What the traversal kernels and their torch twins share.

Counterpart of ntrace_tpu/trace/packet_common.py (slab_child :52-73,
mt_row_best :76-121), written once in torch for the twins of the CUDA
traversal kernels. Every expression keeps the reference's operation order;
`csrc/trace_common.cuh` repeats the same order in CUDA C++, so twins and
kernels agree bit for bit. `fetch_nodes`, `visit_nodes` and `accept_row`
are the steps every twin shares: decode node records, slab-test both
children, and fold one triangle row into the running hit; `RayState`,
`start_twin` and `retire` are the lockstep state the twins share, and
`tally` their count of work. `check_rays`, `hit_outputs` and
`launch_traversal` are the wrappers' side: one signature for the kernels
of packet_trace.cu, packet_ww.cu and packet_ifif.cu. `run_entry` and
`check_leaf_runs` are the leaf-run encoding of the while-while and
speculative while-while schedules.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.host import NODE_LANES, TRI_LANES
from ntrace_tpu_torch.ops.aabb import safe_inv_dir
from ntrace_tpu_torch.tables import PackedTables

INF = 3.0e38
INT_MAX = 0x7FFFFFFF
STACK_DEPTH = 128          # as packet_pallas.py STACK_DEPTH
MAX_STEPS = 4_000_000      # malformed-tree backstop, per ray
DONE = -(2 ** 31)          # traversal reference: nothing left to visit
RUN_ROWS = 32              # rows one leaf-run entry can hold (5 bits)


def check_rays(tables: PackedTables, orig, dirn, tmin, tmax):
    r = orig.shape[0]
    for name, a, shape in (("orig", orig, (r, 3)), ("dirn", dirn, (r, 3)),
                           ("tmin", tmin, (r,)), ("tmax", tmax, (r,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, want {shape}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {a.dtype}, want float32")
        if a.device != tables.device:
            raise ValueError(f"{name} on {a.device}, tables on "
                             f"{tables.device}")
    if r >= 2 ** 31:
        raise ValueError(f"{r} rays exceed the kernel's int32 index")


def check_leaf_runs(tables: PackedTables):
    """A leaf that spans more rows than a run entry holds cannot be
    queued: refuse such tables instead of tracing part of a leaf."""
    if tables.max_leaf_rows > RUN_ROWS:
        raise ValueError(f"a leaf spans {tables.max_leaf_rows} triangle rows;"
                         f" leaf runs hold at most {RUN_ROWS}")


def run_entry(enc: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Leaf-run entry of a leaf child: first_row * 32 + (rows - 1), rows - 1
    clipped to [0, 31] (packet_ww.py:96-97)."""
    return (-enc - 1) * RUN_ROWS + (cnt - 1).clamp(0, RUN_ROWS - 1)


def hit_outputs(orig: torch.Tensor):
    """Empty (tri, t, u, v) outputs for orig's rays, on its device."""
    r, dev = orig.shape[0], orig.device
    return (torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev))


def launch_traversal(name: str, tables, orig, dirn, tmin, tmax, any_hit,
                     outs):
    """One launch of the traversal kernel `name` (the C entry points of
    packet_trace.cu, packet_ww.cu and packet_ifif.cu share one signature)
    on the current CUDA stream; raises on a launch error."""
    from ntrace_tpu_torch.kernels.build import library

    for t in (tables.nodes8, tables.tris12):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("packed tables must be contiguous and 16-byte "
                             "aligned (node records load as float4)")
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        rc = getattr(library(), name)(
            tables.nodes8.data_ptr(), tables.tris12.data_ptr(),
            orig.data_ptr(), dirn.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), orig.shape[0], tables.nodes_per_row,
            tables.tris_per_row, int(any_hit), *(o.data_ptr() for o in outs),
            stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


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


def fetch_nodes(nodes_flat: torch.Tensor, ref: torch.Tensor, npr: int,
                lanes16: torch.Tensor) -> torch.Tensor:
    """(k, 16) node records of node indices `ref` in the flattened node
    table: node i is at row i // npr, lanes 16 * (i % npr) onward."""
    node = ref.long()
    base = (node // npr) * 128 + (node % npr) * 16
    return nodes_flat[base[:, None] + lanes16]


def visit_nodes(rec: torch.Tensor, o, inv, tn, ht):
    """Slab-test both children of each record against its ray's
    [tn, ht]. Returns (h0, b0, h1, b1, enc0, enc1, cnt0, cnt1): hit flags
    and entry distances of child 0 and 1, and their int32 links and row
    counts (float lanes truncated, as astype(int32))."""
    args = (o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2],
            tn, ht)
    h0, b0 = slab_child(rec, 0, *args)
    h1, b1 = slab_child(rec, 6, *args)
    lanes = rec[:, 12:16].to(torch.int32)
    return h0, b0, h1, b1, lanes[:, 0], lanes[:, 1], lanes[:, 2], lanes[:, 3]


def accept_row(trow: torch.Tensor, o, d, tn, tpr: int, ht, hid, hu, hv):
    """Fold each ray's own triangle row into its running hit: the row's
    (t, id) minimum replaces the hit when it is lexicographically smaller.
    Returns the new (ht, hid, hu, hv)."""
    bt, bid, bu, bv = mt_row_best(trow, o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                  d[:, 1], d[:, 2], tn, tpr)
    acc = (bid != INT_MAX) & ((bt < ht) | ((bt == ht) & (bid < hid)))
    return (torch.where(acc, bt, ht), torch.where(acc, bid, hid),
            torch.where(acc, bu, hu), torch.where(acc, bv, hv))


class RayState:
    """Per-ray state of a twin for the rays still in flight: tensors whose
    first dimension is the ray, as attributes."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def take(self, keep: torch.Tensor) -> "RayState":
        return RayState(**{k: v[keep] for k, v in vars(self).items()})

    def zeros(self, *shape, dtype=torch.int32) -> torch.Tensor:
        """A new per-ray field of zeros, (rays, *shape)."""
        return torch.zeros((self.ids.numel(), *shape), dtype=dtype,
                           device=self.ids.device)


def start_twin(orig, dirn, tmin, tmax):
    """The kernels' miss record for every ray (tri -1, t = tmax, u = v = 0),
    and the state of the live rays: ids, o, d, inv (safe reciprocal), tn,
    the running hit (ht, hid, hu, hv) and a step count. A dead ray (tmax <=
    tmin, or NaN) keeps the miss record, as in the kernels. Returns
    (out, state)."""
    r, dev = orig.shape[0], orig.device
    out = [torch.full((r,), -1, dtype=torch.int32, device=dev), tmax.clone(),
           torch.zeros((r,), dtype=torch.float32, device=dev),
           torch.zeros((r,), dtype=torch.float32, device=dev)]
    ids = torch.nonzero(tmax > tmin).squeeze(1)
    s = RayState(ids=ids, o=orig[ids], d=dirn[ids],
                 inv=safe_inv_dir(dirn[ids]), tn=tmin[ids], ht=tmax[ids])
    s.hid = s.zeros() - 1
    s.hu = s.zeros(dtype=torch.float32)
    s.hv = s.zeros(dtype=torch.float32)
    s.steps = s.zeros(dtype=torch.int64)
    return out, s


def retire(s: RayState, done: torch.Tensor, out) -> RayState:
    """Once finished rays are at least half the state, write their hits to
    `out` and drop them (a smaller state keeps each lockstep step cheap)."""
    if 2 * int(done.sum()) >= s.ids.numel():
        fin = s.ids[done]
        for o, v in zip(out, (s.hid, s.ht, s.hu, s.hv)):
            o[fin] = v[done]
        s = s.take(~done)
    return s


def work_with_reads(tables: PackedTables) -> dict:
    """A `work` dict for a twin that also marks which node records
    ("nodes_read") and triangle rows ("rows_read") the traversal reads."""
    dev = tables.nodes8.device
    n_nodes = tables.nodes8.shape[0] * tables.nodes_per_row
    return {"node_visits": 0, "tri_slot_tests": 0,
            "nodes_read": torch.zeros(n_nodes, dtype=torch.bool, device=dev),
            "rows_read": torch.zeros(tables.tris12.shape[0],
                                     dtype=torch.bool, device=dev)}


def read_bytes(tables: PackedTables, work: dict) -> int:
    """Bytes of the node records and triangle slots marked in `work`."""
    return 4 * (int(work["nodes_read"].sum()) * NODE_LANES
                + int(work["rows_read"].sum()) * tables.tris_per_row
                * TRI_LANES)


def run_rows(row0: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The triangle rows of leaf runs row0[i] .. row0[i] + cnt[i] - 1, one
    run after another."""
    cnt = cnt.long()
    start = torch.repeat_interleave(row0.long(), cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    return start + torch.arange(start.numel(), device=start.device) - first


def start_work(work: dict | None):
    """Zero counts in a caller's `work` that has none yet."""
    if work is not None:
        work.setdefault("node_visits", 0)
        work.setdefault("tri_slot_tests", 0)


def tally(work: dict | None, nodes: torch.Tensor, rows: torch.Tensor,
          tpr: int):
    """Count one lockstep step into `work`: a visit of each node in `nodes`
    and tpr slot tests for each triangle row in `rows`; mark them read
    where `work` comes from work_with_reads."""
    if work is None:
        return
    work["node_visits"] += nodes.numel()
    work["tri_slot_tests"] += rows.numel() * tpr
    if "nodes_read" in work:
        work["nodes_read"][nodes.long()] = True
        work["rows_read"][rows.long()] = True
