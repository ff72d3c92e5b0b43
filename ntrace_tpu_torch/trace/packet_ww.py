"""While-while BVH traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_ww.py:trace_packet_ww (236-296),
registry name `tesla_persistent_while_while`. Same contract as
`trace/packet.py:trace_packet`: orig/dirn (R, 3) f32, tmin/tmax (R,) f32
-> tri i32, t, u, v f32; the closest hit, lowest triangle id on a tie in
t, tri -1 / t = tmax / u = v = 0 on a miss; any-hit stops a ray at its
first accepted hit; a dead ray (tmax <= tmin) is a miss at once.

The schedule is the reference's phase split, per ray (csrc/packet_ww.cu
says why): a node loop that runs only slab tests and defers every hit leaf
into a queue of row runs (QCAP 32 entries of first_row * 32 + rows - 1,
paused at QCAP - 2), then a leaf loop that runs only Moller-Trumbore, one
row per step, from the top of the queue. hitT shrinks only in the leaf
loop, up to a queue's worth of leaves late; the closest-hit result does
not depend on that (its acceptance is order-free), so it is bit-equal to
trace_packet's on every ray.

Rays on a CUDA device go through the kernel; rays on the CPU through
`trace_packet_ww_ref`, the kernel's per-ray state machine in torch with
its exact control flow and op order. Nothing falls back.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_common import (DONE, MAX_STEPS,
                                                  RUN_ROWS, STACK_DEPTH,
                                                  RayState, accept_row,
                                                  check_leaf_runs, check_rays,
                                                  fetch_nodes, hit_outputs,
                                                  launch_traversal, retire,
                                                  run_entry, start_twin,
                                                  start_work, tally,
                                                  visit_nodes)

QCAP = 32          # leaf-queue entries per ray (packet_ww.py QCAP)


def trace_packet_ww(tables: PackedTables, orig, dirn, tmin, tmax, *,
                    any_hit: bool = False):
    """Trace rays through `tables`. Returns (tri, t, u, v), each (R,)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_leaf_runs(tables)
    if not uses_kernel(orig):
        return trace_packet_ww_ref(tables, orig, dirn, tmin, tmax,
                                   any_hit=any_hit)
    outs = hit_outputs(orig)
    if orig.shape[0]:
        launch_traversal("ntrace_packet_ww", tables, orig.contiguous(),
                         dirn.contiguous(), tmin.contiguous(),
                         tmax.contiguous(), any_hit, outs)
        trace_packet_ww.launches += 1
    return outs


trace_packet_ww.launches = 0   # kernel launches since the last reset


def trace_packet_ww_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                        any_hit: bool = False, work: dict | None = None):
    """Plain torch twin of the while-while kernel, on any device.

    Every ray runs the kernel's loops as a state machine: per lockstep
    iteration a ray in its node loop visits one node, a ray in its leaf
    loop tests one queued row. `work`, when given, counts node visits into
    work["node_visits"] and triangle slot tests (rows times
    tris_per_row) into work["tri_slot_tests"], as trace_packet_ref does.
    """
    return run_while_while(tables, orig, dirn, tmin, tmax, any_hit, work,
                           near_by_entry)


def near_by_entry(s: RayState, i: torch.Tensor, b0, b1, cnt0):
    """packet_ww.cu's near-first rule: the child entered first; a tie goes
    to child 0."""
    return b0 <= b1


def run_while_while(tables: PackedTables, orig, dirn, tmin, tmax,
                    any_hit: bool, work: dict | None, near_first):
    """The while-while state machine shared by the ww and pipe twins.
    near_first(s, i, b0, b1, cnt0) says, for rays i whose node has both
    children hit and internal, whether child 0 is descended first."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_leaf_runs(tables)
    dev = orig.device
    nodes = tables.nodes8.reshape(-1)
    tris = tables.tris12
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    out, s = start_twin(orig, dirn, tmin, tmax)
    s.item, s.sp, s.qn = s.zeros(), s.zeros(), s.zeros()
    s.leafph = s.zeros(dtype=torch.bool)      # in the leaf loop
    s.stack, s.queue = s.zeros(STACK_DEPTH), s.zeros(QCAP)
    lanes16 = torch.arange(16, device=dev)
    start_work(work)
    while s.ids.numel():
        # The backstop: a ray at MAX_STEPS stops where it is.
        cut = s.steps >= MAX_STEPS
        s.item[cut] = DONE
        s.qn[cut] = 0
        inner = torch.nonzero(~s.leafph & (s.item != DONE)).squeeze(1)
        leaf = torch.nonzero(s.leafph & (s.qn > 0)).squeeze(1)
        if work is not None:
            top = (s.qn[leaf] - 1).long()
            tally(work, s.item[inner], s.queue[leaf, top] >> 5, tpr)
        if inner.numel():
            _node_step(s, inner, nodes, npr, lanes16, near_first)
        if leaf.numel():
            _leaf_step(s, leaf, tris, tpr, any_hit)
        # Loop exits of the kernel: the node loop ends when the ray is done
        # or its queue is nearly full; the leaf loop when the queue is
        # empty, and then the ray is finished or walks on.
        s.leafph = torch.where(s.leafph, s.qn > 0,
                               (s.item == DONE) | (s.qn >= QCAP - 2))
        s = retire(s, (s.item == DONE) & (s.qn == 0), out)
    return tuple(out)


def _node_step(s: RayState, i: torch.Tensor, nodes, npr: int, lanes16,
               near_first):
    """Rays i visit their node: hit leaf children join the queue (child 0
    first), the nearer hit internal child (by near_first) is descended and
    the farther pushed; with no internal child hit the ray pops or is
    done."""
    s.steps[i] += 1
    rec = fetch_nodes(nodes, s.item[i], npr, lanes16)
    h0, b0, h1, b1, enc0, enc1, cnt0, cnt1 = visit_nodes(
        rec, s.o[i], s.inv[i], s.tn[i], s.ht[i])
    l0, l1 = enc0 < 0, enc1 < 0
    qn = s.qn[i]
    for hit, leaf, enc, cnt in ((h0, l0, enc0, cnt0), (h1, l1, enc1, cnt1)):
        q = hit & leaf
        s.queue[i[q], qn[q].long()] = run_entry(enc, cnt)[q]
        qn = qn + q.to(torch.int32)
    s.qn[i] = qn
    i0, i1 = h0 & ~l0, h1 & ~l1
    both = i0 & i1
    first0 = near_first(s, i, b0, b1, cnt0)
    sp = s.sp[i]
    slot = sp[both].clamp(max=STACK_DEPTH - 1).long()
    s.stack[i[both], slot] = torch.where(first0, enc1, enc0)[both]
    sp = torch.where(both, (sp + 1).clamp(max=STACK_DEPTH), sp)
    pop = ~(i0 | i1)
    can = pop & (sp > 0)
    top = (sp - 1).clamp(min=0).long()
    popped = s.stack[i, top]
    done = torch.full_like(enc0, DONE)
    s.item[i] = torch.where(
        both, torch.where(first0, enc0, enc1),
        torch.where(i0, enc0, torch.where(i1, enc1,
                                          torch.where(can, popped, done))))
    s.sp[i] = torch.where(can, sp - 1, sp)


def _leaf_step(s: RayState, i: torch.Tensor, tris, tpr: int,
               any_hit: bool):
    """Rays i test the next row of the run on top of their queue."""
    s.steps[i] += 1
    qn = s.qn[i]
    top = (qn - 1).long()
    entry = s.queue[i, top]
    s.ht[i], s.hid[i], s.hu[i], s.hv[i] = accept_row(
        tris[(entry >> 5).long()], s.o[i], s.d[i], s.tn[i], tpr, s.ht[i],
        s.hid[i], s.hu[i], s.hv[i])
    more = (entry & (RUN_ROWS - 1)) > 0
    s.queue[i[more], top[more]] = entry[more] + (RUN_ROWS - 1)
    s.qn[i] = torch.where(more, qn, qn - 1)
    if any_hit:
        hit = i[s.hid[i] >= 0]
        s.qn[hit] = 0
        s.item[hit] = DONE
