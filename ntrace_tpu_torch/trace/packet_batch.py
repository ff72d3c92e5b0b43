"""What the node-batch and deferred-leaf traversals share: the knobs and
their checks, the stack bound, the launch, and one torch twin of the three
CUDA kernels (csrc/packet_bfs.cu, packet_dleaf.cu, packet_bdl.cu, on the
shared csrc/packet_batch.cuh).

Counterparts of ntrace_tpu/trace/packet_bfs.py, packet_dleaf.py and
packet_bdl.py. A packet is `rows` warps of 32 consecutive rays (one CUDA
block of rows * 32 threads, a thread per ray; the reference's packet is
rows x 128 lanes). The packet shares one traversal on one stack; rays past
the batch are the reference's pad rays (orig 0, dirn 1, tmin 1, tmax 0),
dead, and take part in the packet's direction sums as the reference's do.
Per step a packet:
  - pops up to `batch` nodes off its stack (8 for bfs and bdl, 1 for
    dleaf) and every live ray slab-tests both children of each against its
    running hit t as it stood at the start of the step (a dead ray wants
    nothing); a warp's OR of its rays' verdicts is its ray row's wants mask;
  - routes the children in reverse pop order (the top of the stack, popped
    first, is routed last): hit internal children are pushed far first and
    near last, near by the pack-time order code in lane 14 of a node whose
    children are both internal, against the signs of the packet's direction
    sums (packet_bfs.py:66-68, 256-269); hit leaf children become runs
    (first row, rows) in that order, merged with the sibling's when
    merge_sibs is set and the two runs are contiguous
    (packet_bdl.py:301-328); a run of no rows is dropped;
  - bfs: each warp's live rays test every row of the step's runs that the
    warp's wants mask selects. The reference tests every run on the whole
    packet (packet_bfs.py:236-278), whose TPU sublanes run in lockstep.
    Closest hits and any-hit tri >= 0 are the same either way: the slab
    test is conservative at the stale t, so a ray still tests the leaf
    whose box holds its hit. Which triangle an any-hit ray holds when
    its packet stops can differ: a spatial split references a triangle
    from several leaves, each box clipped, and a row of a leaf the warp
    did not want may hold a triangle the ray hits outside that box;
  - dleaf, bdl: each run goes onto the queue of each group of `qgroup` warps
    (dleaf: one warp) that wants it, `pending` counting the queued rows;
    then drains run while pending >= drain_min, or while the stack is empty
    and work is pending (packet_dleaf.py:188-229, 283-298). A drain refills
    each group's empty active run from the top of its queue and tests one
    row of it against the group's live rays; a group with nothing queued
    sits the drain out;
  - any hit: once every ray of the packet holds a hit or is dead, the
    packet stops (packet_bdl.py:363-366). The kernel tests this at the
    first barrier of the next step, after the same leaf work.
MAX_STEPS is a backstop on malformed trees, per packet.

The stack cannot overflow: its size (Schedule.stack) is what the
deepest tree the wrappers take can need. Entries stay sorted by depth
from the bottom up, because a step pushes its children above what
remains and routes the deepest popped node's last. A step that pushes nodes of depth k has popped
a node of depth k - 1 and so everything above it, every entry of depth
>= k among them. So no more entries of a depth are ever on the stack than
one step pushes: 2 * batch. Depths run from 0 (the root) to max_depth, so
the stack holds at most 2 * batch * (max_depth + 1) entries: 4,096 = 16 *
256 for bfs and bdl, which refuse tables deeper than 255. With one node a
step (dleaf) the stack is a depth-first one: at most one entry of each
depth but the top one, which may hold two siblings, max_depth + 2 entries,
so dleaf's 128 take trees down to depth 126. The reference clamps pushes
and pops past its stack's end (packet_bfs.py:166-169, 266-269); here a
tree that could overflow is refused (`check_tables`).

Queues cannot overflow either: a queued run holds at least one row, so a
queue holds no more runs than `pending` rows; after a step's drains
pending < drain_min <= 64, and a step queues at most 2 * batch = 16 runs a
group, so a queue never holds more than 79 < QCAP = 96 runs.

The twin (`trace_batch_ref`) steps every packet through this loop in
lockstep, with the kernel's pops, verdicts, push order, queues, drains,
stale t and early exit, so closest and any hits are bit-equal to the
kernel's, any-hit `tri` included. Closest hits equal trace_packet's on
every ray: the slab test is conservative and the (t, id) fold order-free.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.ops.aabb import safe_inv_dir
from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_common import (INT_MAX, check_rays,
                                                  fetch_nodes, fold_hits,
                                                  hit_outputs, mt_row_best,
                                                  run_rows, slab_child,
                                                  start_work)

WARP = 32
MAX_ROWS = 32          # warps per packet: a block of at most 1,024 threads
QCAP = 96              # runs per queue (packet_dleaf.py QCAP)
MAX_DRAIN_MIN = 64     # the queue bound above
QGROUPS = (1, 2, 4, 8, 16)
PAIR_LANES = 1 << 18   # (row, ray) pairs a twin tests in one batch


@dataclass(frozen=True)
class Schedule:
    """One of the three kernels: its C entry point, nodes popped a step,
    whether leaf runs wait in queues, its stack and its step backstop."""
    entry: str
    batch: int
    queued: bool
    stack: int
    max_steps: int
    any_npr: bool      # takes any nodes_per_row (else only 1)

    def stack_need(self, max_depth: int) -> int:
        """The most stack entries a tree of depth max_depth can need (the
        module's argument)."""
        if self.batch == 1:
            return max_depth + 2
        return 2 * self.batch * (max_depth + 1)


BFS = Schedule("ntrace_packet_bfs", 8, False, 4096, 1_000_000, False)
DLEAF = Schedule("ntrace_packet_dleaf", 1, True, 128, 4_000_000, True)
BDL = Schedule("ntrace_packet_bdl", 8, True, 4096, 1_000_000, False)


def check_tables(tables: PackedTables, sched: Schedule):
    """Refuse tables the kernel does not take: nodes_per_row != 1 for bfs
    and bdl (their node batch loads one record a row, as the reference's),
    and trees deep enough to overflow the stack."""
    if not sched.any_npr and tables.nodes_per_row != 1:
        raise ValueError(f"{sched.entry} needs nodes_per_row == 1, got "
                         f"{tables.nodes_per_row}")
    need = sched.stack_need(tables.max_depth)
    if need > sched.stack:
        deepest = next(d for d in range(tables.max_depth, -1, -1)
                       if sched.stack_need(d) <= sched.stack)
        raise ValueError(f"tree depth {tables.max_depth}: {sched.entry}'s "
                         f"stack of {sched.stack} takes depth {deepest} at "
                         f"most")


def knobs(sched: Schedule, rows: int, qgroup: int = 1,
          drain_min: int = 0) -> tuple[int, int, int]:
    """Check the knobs; returns (rows, qgroup, drain_min) with drain_min 0
    resolved to one per queue."""
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows must be in [1, {MAX_ROWS}] (warps per "
                         f"packet), got {rows}")
    if qgroup not in QGROUPS or rows % qgroup:
        raise ValueError(f"qgroup must be one of {QGROUPS} and divide rows "
                         f"{rows}, got {qgroup}")
    if not sched.queued:
        return rows, 1, 1
    dmin = drain_min or rows // qgroup
    if not 1 <= dmin <= MAX_DRAIN_MIN:
        raise ValueError(f"drain_min must be in [1, {MAX_DRAIN_MIN}] (the "
                         f"queue bound), got {dmin}")
    return rows, qgroup, dmin


def trace_batch(kernel, sched: Schedule, tables: PackedTables, orig, dirn,
                tmin, tmax, any_hit: bool, rows: int, qgroup: int = 1,
                drain_min: int = 0, merge_sibs: bool = False):
    """What the three wrappers share: check, then the twin on the CPU or
    one launch of the kernel on a CUDA device (counted on `kernel`)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_tables(tables, sched)
    rows, qgroup, dmin = knobs(sched, rows, qgroup, drain_min)
    if not uses_kernel(orig):
        return trace_batch_ref(sched, tables, orig, dirn, tmin, tmax,
                               any_hit=any_hit, rows=rows, qgroup=qgroup,
                               drain_min=dmin, merge_sibs=merge_sibs)
    outs = hit_outputs(orig)
    if orig.shape[0]:
        launch_batch(sched, tables, orig.contiguous(), dirn.contiguous(),
                     tmin.contiguous(), tmax.contiguous(), any_hit, rows,
                     qgroup, dmin, merge_sibs, outs)
        kernel.launches += 1
    return outs


def launch_batch(sched: Schedule, tables, orig, dirn, tmin, tmax, any_hit,
                 rows, qgroup, dmin, merge_sibs, outs):
    """One launch of the schedule's entry point on the current CUDA stream;
    raises on a launch error. bfs takes rows; dleaf rows and drain_min;
    bdl rows, drain_min, qgroup and merge_sibs; each then the stack's
    entries, stack_need(max_depth), which sizes the block's shared
    memory."""
    from ntrace_tpu_torch.kernels.build import launch

    for t in (tables.nodes8, tables.tris12):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("packed tables must be contiguous and 16-byte "
                             "aligned (node records load as float4)")
    extra = {"ntrace_packet_bfs": (rows,),
             "ntrace_packet_dleaf": (rows, dmin),
             "ntrace_packet_bdl": (rows, dmin, qgroup, int(merge_sibs))}
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        launch(sched.entry, tables.nodes8.data_ptr(),
               tables.tris12.data_ptr(), orig.data_ptr(), dirn.data_ptr(),
               tmin.data_ptr(), tmax.data_ptr(), orig.shape[0],
               tables.nodes_per_row, tables.tris_per_row, int(any_hit),
               *extra[sched.entry], sched.stack_need(tables.max_depth),
               *(o.data_ptr() for o in outs), stream)


def occupancy(sched: Schedule, max_depth: int, any_hit: bool, rows: int,
              qgroup: int = 1) -> tuple[int, int, int]:
    """What a launch on tables of depth max_depth runs, from the CUDA
    runtime on the current device: (registers a thread, shared memory a
    block in bytes, resident blocks an SM)."""
    from ntrace_tpu_torch.kernels.build import launch

    out = (ctypes.c_int * 3)()
    launch(sched.entry + "_occupancy", int(any_hit), rows, qgroup,
           sched.stack_need(max_depth), out)
    return tuple(out)


def packet_signs(d: torch.Tensor) -> torch.Tensor:
    """Octant of each packet's direction sums from its (P, rows * 32, 3)
    directions, summed as the kernel sums them: each warp by the shuffle
    butterfly (lane ^ 16, ^ 8, ^ 4, ^ 2, ^ 1), then the warps' sums one
    after another. Returns (P,) int32."""
    x = d.view(d.shape[0], -1, WARP, 3)
    while x.shape[2] > 1:
        h = x.shape[2] // 2
        x = x[:, :, :h] + x[:, :, h:]
    x = x[:, :, 0]                                   # (P, rows, 3)
    s = x[:, 0]
    for w in range(1, x.shape[1]):
        s = s + x[:, w]
    return ((s[:, 0] >= 0).to(torch.int32)
            | ((s[:, 1] >= 0).to(torch.int32) << 1)
            | ((s[:, 2] >= 0).to(torch.int32) << 2))


class _Packets:
    """The twin's state: per ray as (P, rows * 32), per packet as (P,),
    queues as (P, groups, ...)."""

    def __init__(self, sched: Schedule, orig, dirn, tmin, tmax, rows: int,
                 qgroup: int):
        r, dev = orig.shape[0], orig.device
        self.W = W = rows * WARP
        self.P = P = -(-r // W)
        self.G, self.Wg = rows // qgroup, qgroup * WARP
        pad = P * W - r

        def lanes(a, fill):
            if pad:
                a = torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])
            return a.reshape(P, W, *a.shape[1:])

        self.o, self.d = lanes(orig, 0.0), lanes(dirn, 1.0)
        self.inv = safe_inv_dir(self.d)
        self.tn = lanes(tmin, 1.0)
        self.ht = lanes(tmax, 0.0).clone()
        self.live = self.ht > self.tn
        self.hid = torch.full((P, W), -1, dtype=torch.int32, device=dev)
        self.hu = torch.zeros((P, W), dtype=torch.float32, device=dev)
        self.hv = torch.zeros_like(self.hu)
        self.signs = packet_signs(self.d)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros((P, *shape), dtype=dtype, device=dev)

        # One spare column past the stack and the queues (see _node_step).
        self.stack, self.sp = zeros(sched.stack + 1), zeros() + 1
        self.pending = zeros()
        self.queue = zeros(self.G, QCAP + 1, 2) if sched.queued else None
        self.qn, self.arow, self.aleft = (zeros(self.G) for _ in range(3))


def trace_batch_ref(sched: Schedule, tables: PackedTables, orig, dirn, tmin,
                    tmax, *, any_hit: bool = False, rows: int = 8,
                    qgroup: int = 1, drain_min: int = 0,
                    merge_sibs: bool = False, work: dict | None = None):
    """Plain torch twin of the schedule's kernel, on any device. `work`,
    when given, counts ray node visits (each live ray of a packet, for each
    node the packet pops) into work["node_visits"], triangle slot tests
    (live rays times tested rows times tris_per_row) into
    work["tri_slot_tests"], steps summed over packets into
    work["packet_steps"], and, for dleaf and bdl, drains summed over
    packets into work["packet_drains"] and rows tested in drains summed
    over groups into work["drain_rows"]; it marks the node records and
    triangle rows read where it comes from packet_common.work_with_reads.

    Each lockstep iteration is one step of every packet still walking:
    the pops, slab tests and routing of the kernel, vectorized over the
    packets (the routing order is kept by prefix sums); a step's drains are
    evaluated at once, since the rows a group tests in them are the first
    rows of its active run and then of its queue from the top, as many as
    the drain loop's trip count, which the queued row counts decide."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_tables(tables, sched)
    rows, qgroup, dmin = knobs(sched, rows, qgroup, drain_min)
    r = orig.shape[0]
    start_work(work)
    if work is not None:
        for key in ("packet_steps", "packet_drains", "drain_rows"):
            work.setdefault(key, 0)
    if not r:
        return hit_outputs(orig)
    s = _Packets(sched, orig, dirn, tmin, tmax, rows, qgroup)
    nodes = tables.nodes8.reshape(-1)
    lanes16 = torch.arange(16, device=orig.device)
    act = torch.ones(s.P, dtype=torch.bool, device=orig.device)
    # The most entries a stack and a queue held (the module's bounds).
    top = torch.zeros(2, dtype=torch.int32, device=orig.device)
    steps = 0
    while True:
        a = torch.nonzero(act).squeeze(1)
        if not a.numel():
            break
        runs = _node_step(s, sched, a, tables, nodes, lanes16, rows,
                          merge_sibs, work)
        top[0] = torch.maximum(top[0], s.sp[a].max())
        if sched.queued:
            _enqueue(s, a, runs)
            top[1] = torch.maximum(top[1], s.qn[a].max())
            _drains(s, a, tables, dmin, work)
        elif bool(runs[3].any()):
            # bfs: each warp (a group of one) tests the runs it wants.
            row0, n, w, take = runs
            A, K = take.shape
            n = torch.where(take[:, None, :] & w.transpose(1, 2),
                            n[:, None, :], 0)                  # (A, rows, K)
            _test_pairs(s, tables, *_expand(
                a.repeat_interleave(rows),
                torch.arange(rows, device=a.device).repeat(A),
                row0.repeat_interleave(rows, 0), n.reshape(-1, K)), work)
        sp, pend = s.sp[a], s.pending[a]
        if any_hit:
            done = ((s.hid[a] >= 0) | ~s.live[a]).all(1)
            sp, pend = sp.masked_fill(done, 0), pend.masked_fill(done, 0)
            s.sp[a], s.pending[a] = sp, pend
        # Every packet walks from the first step until it stops, so its
        # step count is the loop's.
        steps += 1
        if work is not None:
            work["packet_steps"] += a.numel()
        act[a] = ((sp > 0) | (pend > 0)) & (steps < sched.max_steps)
    depth, queued = top.tolist()
    if depth > sched.stack or queued > QCAP:
        raise RuntimeError(f"{sched.entry} twin: a stack held {depth} of "
                           f"{sched.stack} entries, a queue {queued} of "
                           f"{QCAP} runs")
    return tuple(x.reshape(-1)[:r].clone() for x in (s.hid, s.ht, s.hu, s.hv))


def _in_order(*xs):
    """(A, B, C) tensors by popped slot j and candidate c, flattened into
    the routing order: slot B - 1 first, each slot's candidates in order."""
    return [x.flip(1).flatten(1, 2) for x in xs]


def _node_step(s: _Packets, sched: Schedule, a, tables, nodes, lanes16,
               rows: int, merge_sibs: bool, work):
    """Packets a pop, slab-test and route one batch of nodes. Returns the
    step's leaf runs in routing order, (row0, nrows, wants by warp, taken)
    as (A, K), (A, K), (A, K, rows) and (A, K) with K = 2 or 3 a node."""
    B, A, dev = sched.batch, a.numel(), a.device
    sp = s.sp[a]
    nb = sp.clamp(max=B)
    j = torch.arange(B, device=dev)
    valid = j[None, :] < nb[:, None]
    ref = torch.where(valid, s.stack[a[:, None],
                                     (sp[:, None] - 1 - j).clamp(min=0)], 0)
    sp = sp - nb
    rec = fetch_nodes(nodes, ref.reshape(-1), tables.nodes_per_row,
                      lanes16).view(A, B, 16)
    live = s.live[a]
    if work is not None:
        work["node_visits"] += int((live.sum(1)[:, None] * valid).sum())
        if "nodes_read" in work:
            work["nodes_read"][ref[valid].long()] = True
    o, inv = s.o[a][:, None, None], s.inv[a][:, None, None]  # (A,1,1,W,3)
    args = (o[..., 0], o[..., 1], o[..., 2], inv[..., 0], inv[..., 1],
            inv[..., 2], s.tn[a][:, None, None],
            s.ht[a][:, None, None])                       # stale t
    # Both children at once: the bounds as (A, B, child, 1, 6).
    box = rec[..., :12].view(A, B, 2, 1, 6)
    h = slab_child(box, 0, *args)[0]                      # (A, B, 2, W)
    h &= valid[:, :, None, None] & live[:, None, None, :]
    wants = h.view(A, B, 2, rows, WARP).any(-1)           # (A, B, 2, rows)
    b0, b1 = wants.any(-1).unbind(2)                      # (A, B)
    w0, w1 = wants.unbind(2)
    enc0, enc1, c0, c1 = rec[..., 12:16].to(torch.int32).unbind(2)
    l0, l1 = b0 & (enc0 < 0), b1 & (enc1 < 0)
    if merge_sibs:
        both = l0 & l1 & ((-enc1 - 1) == (-enc0 - 1) + c0)
        take = torch.stack([both, l0 & ~both, l1 & ~both], 2)
        row0 = torch.stack([-enc0 - 1, -enc0 - 1, -enc1 - 1], 2)
        n = torch.stack([c0 + c1, c0, c1], 2)
        w = torch.stack([w0 | w1, w0, w1], 2)
    else:
        take = torch.stack([l0, l1], 2)
        row0 = torch.stack([-enc0 - 1, -enc1 - 1], 2)
        n = torch.stack([c0, c1], 2)
        w = torch.stack([w0, w1], 2)
    take, row0, n, w = _in_order(take & (n > 0), row0, n, w)
    # Internal children: far, then near (first0: child 0 is near).
    i0, i1 = b0 & (enc0 >= 0), b1 & (enc1 >= 0)
    shift = (c0 >> 1).clamp(0, 2)
    first0 = torch.where((enc0 >= 0) & (enc1 >= 0),
                         ((s.signs[a][:, None] >> shift) & 1) == (c0 & 1),
                         True)
    val, ok = _in_order(
        torch.stack([torch.where(first0, enc1, enc0),
                     torch.where(first0, enc0, enc1)], 2),
        torch.stack([torch.where(first0, i1, i0),
                     torch.where(first0, i0, i1)], 2))
    # Pushes past the stack would land in its last column, a spare one:
    # the loop's `top` check refuses them.
    pos = sp[:, None] + torch.cumsum(ok, 1, dtype=torch.int32) - 1
    spare = s.stack.shape[1] - 1
    s.stack[a[:, None].expand_as(pos),
            torch.where(ok, pos, spare).clamp(max=spare).long()] = val
    s.sp[a] = sp + ok.sum(1, dtype=torch.int32)
    return row0, n, w, take


def _expand(p, g, row0, n):
    """The (packet, group, triangle row) pairs of runs: M (packet, group)
    pairs p, g (M,) with up to K runs each, first rows row0 and row counts
    n (M, K; a run of no rows is none). Returns (packets, groups, rows)."""
    keep = n > 0
    m = torch.nonzero(keep)[:, 0]
    cnt = n[keep].long()
    return (torch.repeat_interleave(p[m], cnt),
            torch.repeat_interleave(g[m], cnt), run_rows(row0[keep], cnt))


def _test_pairs(s: _Packets, tables, p, g, rows, work):
    """Each (packet p, group g, row) pair: the group's live rays test the
    triangle row, and fold it into their hits (fold_hits, order-free)."""
    if work is not None:
        lv = s.live.view(s.P, -1, s.Wg)[p, g]
        work["tri_slot_tests"] += int(lv.sum()) * tables.tris_per_row
        if "rows_read" in work:
            work["rows_read"][rows.long()] = True
    tpr, Wg = tables.tris_per_row, s.Wg
    lane = torch.arange(Wg, device=p.device)
    hits = [x.view(-1) for x in (s.ht, s.hid, s.hu, s.hv)]
    view = [x.view(s.P, -1, Wg, *x.shape[2:]) for x in (s.o, s.d, s.tn,
                                                        s.live)]
    chunk = max(PAIR_LANES // Wg, 1)
    for c in range(0, p.numel(), chunk):
        pc, gc = p[c:c + chunk], g[c:c + chunk]
        o, d, tn, live = (x[pc, gc] for x in view)
        bt, bid, bu, bv = mt_row_best(
            tables.tris12[rows[c:c + chunk].long()][:, None, :], o[..., 0],
            o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2], tn, tpr)
        fold = live & (bid != INT_MAX)
        ray = ((pc * s.W + gc * Wg)[:, None] + lane)[fold]
        fold_hits(*hits, ray, bt[fold], bid[fold], bu[fold], bv[fold])


def _enqueue(s: _Packets, a, runs):
    """dleaf, bdl: the step's runs, in order, onto the queue of every group
    of the packet that wants them."""
    row0, n, w, take = runs
    A, K = take.shape
    put = take[:, :, None] & w.view(A, K, s.G, -1).any(-1)   # (A, K, G)
    pos = (s.qn[a][:, None, :] + torch.cumsum(put, 1, dtype=torch.int32)
           - put.to(torch.int32))
    # Runs not taken, or past QCAP (the loop's check refuses those), land
    # in the spare last slot.
    pos = torch.where(put, pos, QCAP).clamp(max=QCAP).long()
    s.queue[a[:, None, None].expand_as(pos),
            torch.arange(s.G, device=a.device).expand_as(pos), pos] = \
        torch.stack([row0, n], 2)[:, :, None, :].expand(*pos.shape, 2)
    s.qn[a] += put.sum(1, dtype=torch.int32)
    s.pending[a] += (put * n[:, :, None]).sum((1, 2), dtype=torch.int32)


def _drains(s: _Packets, a, tables, dmin: int, work):
    """dleaf, bdl: a step's drains at once. A group with R rows left (its
    active run's, then its queue's) tests one a drain while it has any, so
    after i drains pending is the sum over groups of max(R - i, 0); drains
    run while pending >= drain_min, or while the stack is empty and rows
    are pending. Each group tests its first min(drains, R) rows: the
    active run's, then the queued runs' from the top, the last run touched
    becoming the active run."""
    empty = s.sp[a] == 0
    pend = s.pending[a]
    drain = (pend >= dmin) | (empty & (pend > 0))
    if not bool(drain.any()):
        return
    a, empty = a[drain], empty[drain][:, None]
    A, G, dev = a.numel(), s.G, a.device
    qn = s.qn[a].long()                                    # (A, G)
    depth = torch.arange(1, QCAP + 1, device=dev)
    inq = depth <= qn[..., None]                           # (A, G, QCAP)
    ent = s.queue[a[:, None, None], torch.arange(G, device=dev)[:, None],
                  (qn[..., None] - depth).clamp(min=0)]    # top first
    row0 = torch.cat([s.arow[a][..., None], ent[..., 0]], 2)
    n = torch.cat([s.aleft[a][..., None],
                   torch.where(inq, ent[..., 1], 0)], 2)   # (A, G, 1 + QCAP)
    left = n.sum(2)                                        # R by group
    i = torch.arange(int(left.max()) + 1, device=dev)
    pend = (left[..., None] - i).clamp(min=0).sum(1)       # (A, drains)
    go = (pend >= dmin) | (empty & (pend > 0))
    drains = (~go).to(torch.int8).argmax(1)                # first stop
    k = torch.minimum(left, drains[:, None])               # rows by group
    if work is not None:
        work["packet_drains"] += int(drains.sum())
        work["drain_rows"] += int(k.sum())
    cum = torch.cumsum(n, 2)
    used = (k[..., None] - (cum - n)).clamp(min=0).minimum(n)
    _test_pairs(s, tables, *_expand(
        a[:, None].expand(A, G).reshape(-1),
        torch.arange(G, device=dev).expand(A, G).reshape(-1),
        row0.flatten(0, 1), used.flatten(0, 1)), work)
    # The last run touched becomes the active run; the runs above it in
    # the queue are gone.
    last = torch.where(used > 0, torch.arange(1 + QCAP, device=dev),
                       0).amax(2, keepdim=True)
    moved = k > 0
    s.arow[a] = torch.where(moved, (row0.gather(2, last)
                                    + used.gather(2, last))[..., 0],
                            s.arow[a]).to(torch.int32)
    s.aleft[a] = torch.where(moved, (n.gather(2, last)
                                     - used.gather(2, last))[..., 0],
                             s.aleft[a]).to(torch.int32)
    s.qn[a] = (qn - last[..., 0]).to(torch.int32)
    s.pending[a] -= k.sum(1, dtype=torch.int32)
