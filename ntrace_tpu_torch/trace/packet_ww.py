"""While-while BVH traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_ww.py:trace_packet_ww (236-296),
registry name `tesla_persistent_while_while`. Same contract as
`trace/packet.py:trace_packet`: orig/dirn (R, 3) f32, tmin/tmax (R,) f32
-> tri i32, t, u, v f32; the closest hit, lowest triangle id on a tie in
t, tri -1 / t = tmax / u = v = 0 on a miss; any-hit stops a ray at its
first accepted hit; a dead ray (tmax <= tmin) is a miss at once.

The schedule is Aila and Laine's while-while, per ray (csrc/packet_ww.cu
says how it maps to Hopper): a node loop that runs only slab tests and
queues each hit leaf as a row run (first_row * 32 + rows - 1, child 0
first), then a leaf loop that runs only Moller-Trumbore, one row per step,
from the top of the queue until it is empty. The node loop pauses as soon
as a step queues a run, so a leaf is tested one node step after it is
found and the hit distance shrinks before the next box test, as in the
packet kernel; a step queues at most two runs, so the queue holds at most
QCAP = 2. The closest-hit result does not depend on the order (its
acceptance is order-free), so it is bit-equal to trace_packet's on every
ray; which triangle an any-hit ray holds follows the order.

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

QCAP = 2           # leaf-queue runs per ray: one node step queues at most 2


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
    tris_per_row) into work["tri_slot_tests"], as trace_packet_ref does,
    and the most runs a queue held into work["queue_max"] where `work`
    has that key.
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
    near_first(s, i, b0, b1, cnt0) says, for rays i, whether child 0 is
    descended first when both children are hit and internal. A ray is in
    its leaf loop while its queue holds a run: the node loop pauses once a
    step queues one. Raises if a queue would hold more than QCAP runs.
    Where `work` has the key "queue_max", it keeps the most runs a queue
    held; where it has "fetch_steps", it also counts the node steps that go
    on to a node, and in "fetch_predicted" those whose next node is the one
    packet_pipe.cu loads before the slab tests (predicted_next)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_leaf_runs(tables)
    dev = orig.device
    nodes = tables.nodes8.reshape(-1)
    tris = tables.tris12
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    out, s = start_twin(orig, dirn, tmin, tmax)
    s.item, s.sp, s.qn = s.zeros(), s.zeros(), s.zeros()
    s.stack, s.queue = s.zeros(STACK_DEPTH), s.zeros(QCAP)
    lanes16 = torch.arange(16, device=dev)
    qmax = 0
    start_work(work)
    while s.ids.numel():
        # The backstop: a ray at MAX_STEPS stops where it is.
        cut = s.steps >= MAX_STEPS
        s.item[cut] = DONE
        s.qn[cut] = 0
        inner = torch.nonzero((s.qn == 0) & (s.item != DONE)).squeeze(1)
        leaf = torch.nonzero(s.qn > 0).squeeze(1)
        if work is not None:
            top = (s.qn[leaf] - 1).long()
            tally(work, s.item[inner], s.queue[leaf, top] >> 5, tpr)
        if inner.numel():
            qn = int(_node_step(s, inner, nodes, npr, lanes16, near_first,
                                work))
            if qn > QCAP:
                raise RuntimeError(f"while-while twin: a queue held {qn} of "
                                   f"{QCAP} runs")
            qmax = max(qmax, qn)
        if leaf.numel():
            _leaf_step(s, leaf, tris, tpr, any_hit)
        s = retire(s, (s.item == DONE) & (s.qn == 0), out)
    if work is not None and "queue_max" in work:
        work["queue_max"] = max(work["queue_max"], qmax)
    return tuple(out)


def predicted_next(first0, enc0, enc1, popped):
    """The node packet_pipe.cu loads before a step's slab tests: the near
    child by the order code (first0) when both children are internal, the
    internal child when the other is a leaf, else the stack top (`popped`,
    DONE when the stack is empty)."""
    i0, i1 = enc0 >= 0, enc1 >= 0
    return torch.where(i0 & i1, torch.where(first0, enc0, enc1),
                       torch.where(i0, enc0, torch.where(i1, enc1, popped)))


def _node_step(s: RayState, i: torch.Tensor, nodes, npr: int, lanes16,
               near_first, work):
    """Rays i visit their node: hit leaf children join the queue (child 0
    first), the nearer hit internal child (by near_first) is descended and
    the farther pushed; with no internal child hit the ray pops or is
    done. Returns the most runs a queue of rays i holds after the step."""
    s.steps[i] += 1
    rec = fetch_nodes(nodes, s.item[i], npr, lanes16)
    h0, b0, h1, b1, enc0, enc1, cnt0, cnt1 = visit_nodes(
        rec, s.o[i], s.inv[i], s.tn[i], s.ht[i])
    l0, l1 = enc0 < 0, enc1 < 0
    qn = s.qn[i]
    for hit, leaf, enc, cnt in ((h0, l0, enc0, cnt0), (h1, l1, enc1, cnt1)):
        q = hit & leaf
        # A run past QCAP lands in the last slot; the caller then raises.
        slot = qn[q].clamp(max=QCAP - 1).long()
        s.queue[i[q], slot] = run_entry(enc, cnt)[q]
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
    top = (sp - 1).clamp(min=0).long()
    # The stack top, DONE when empty: a popping step pushed nothing, so it
    # is the pre-step top.
    popped = torch.where(sp > 0, s.stack[i, top], DONE)
    nxt = torch.where(
        both, torch.where(first0, enc0, enc1),
        torch.where(i0, enc0, torch.where(i1, enc1, popped)))
    if work is not None and "fetch_steps" in work:
        go = nxt != DONE
        pred = predicted_next(first0, enc0, enc1, popped)
        work["fetch_steps"] += int(go.sum())
        work["fetch_predicted"] += int((go & (nxt == pred)).sum())
    s.item[i] = nxt
    s.sp[i] = torch.where(pop & (sp > 0), sp - 1, sp)
    return qn.max()


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
