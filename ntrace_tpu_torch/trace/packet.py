"""BVH traversal over the packed tables: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_pallas.py:trace_packet (416-514).
`trace_packet` keeps the reference's public layout (orig/dirn (R, 3) f32,
tmin/tmax (R,) f32 -> tri i32, t, u, v f32, each (R,)) and its result: the
closest hit, lowest triangle id on a tie in t, tri -1 / t = tmax / u = v = 0
on a miss; any-hit mode stops a ray at the first leaf row that accepts a
hit.

Rays on a CUDA device go through the hand-written kernel
(csrc/packet_trace.cu: one thread a ray, a per-ray while-while; closest-hit
pops skip every stack entry whose box the slab test would now fail, by the
entry distance stored with it; an any-hit ray stops at the first leaf row
that accepts a hit); rays on the CPU go through
`trace_packet_ref`, a lockstep per-ray while-while in torch with the
kernel's exact control flow and op order. Nothing falls back from one to
the other.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_common import (DONE, MAX_STEPS,
                                                  STACK_DEPTH, RayState,
                                                  accept_row, check_rays,
                                                  fetch_nodes, hit_outputs,
                                                  launch_traversal, retire,
                                                  skip_culled, start_twin,
                                                  start_work, tally,
                                                  visit_nodes)


def trace_packet(tables: PackedTables, orig, dirn, tmin, tmax, *,
                 any_hit: bool = False):
    """Trace rays through `tables`. Returns (tri, t, u, v), each (R,)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    if not uses_kernel(orig):
        return trace_packet_ref(tables, orig, dirn, tmin, tmax,
                                any_hit=any_hit)
    outs = hit_outputs(orig)
    if orig.shape[0]:
        _launch(tables, orig.contiguous(), dirn.contiguous(),
                tmin.contiguous(), tmax.contiguous(), any_hit, outs)
        trace_packet.launches += 1
    return outs


trace_packet.launches = 0   # kernel launches since the last reset


def _launch(tables, orig, dirn, tmin, tmax, any_hit, outs):
    """One launch of ntrace_packet_trace on the current CUDA stream."""
    launch_traversal("ntrace_packet_trace", tables, orig, dirn, tmin, tmax,
                     any_hit, outs)


def trace_packet_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                     any_hit: bool = False, work: dict | None = None):
    """Plain torch twin of the CUDA kernel, on any device.

    Each ray runs the kernel's while-while as a state machine: per lockstep
    iteration a ray either visits one internal node or tests one leaf, so
    every ray performs exactly the kernel's sequence of steps, with the same
    stack (clamped at STACK_DEPTH), the same near-first order, the same
    pops (closest hit: past every entry whose box the ray has left, by the
    entry distance pushed with it), the same any-hit stop after a row, and
    the same slab and Moller-Trumbore op order (trace/packet_common.py).
    `work`, when given, counts the kernel's work on these rays into
    work["node_visits"] and work["tri_slot_tests"] (leaf rows tested times
    tris_per_row), and marks what it reads where `work` comes from
    packet_common.work_with_reads. Where `work` has the keys
    "culled_node_visits" and "culled_slot_tests", closest-hit rays also
    count into them what the cull on pop saved: one visit a culled node
    (its children would fail the slab test) and the slots of each culled
    leaf. Added to the first two, they give the work of the same walk
    without the cull.
    """
    check_rays(tables, orig, dirn, tmin, tmax)
    dev = orig.device
    nodes = tables.nodes8.reshape(-1)
    tris = tables.tris12
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    cull = not any_hit
    out, s = start_twin(orig, dirn, tmin, tmax)
    s.ref, s.cnt, s.sp = s.zeros(), s.zeros(), s.zeros()
    s.stack_ref, s.stack_cnt = s.zeros(STACK_DEPTH), s.zeros(STACK_DEPTH)
    if cull:
        s.stack_b = s.zeros(STACK_DEPTH, dtype=torch.float32)
    lanes16 = torch.arange(16, device=dev)
    start_work(work)
    # The culled items are counted where the caller's `work` asks for them.
    culls = work if work is not None and "culled_node_visits" in work \
        else None
    while s.ids.numel():
        s.ref = torch.where(s.steps >= MAX_STEPS,
                            torch.full_like(s.ref, DONE), s.ref)
        inner = torch.nonzero(s.ref >= 0).squeeze(1)
        leaf = torch.nonzero((s.ref < 0) & (s.ref != DONE)).squeeze(1)
        if work is not None:
            tally(work, s.ref[inner], inner[:0], tpr)
        if inner.numel():
            _node_step(s, inner, nodes, npr, lanes16, cull, culls, tpr)
        if leaf.numel():
            _leaf_step(s, leaf, tris, tpr, any_hit, work, culls)
        s = retire(s, s.ref == DONE, out)
    return tuple(out)


def _pop(s: RayState, p: torch.Tensor, cull: bool, culls, tpr: int):
    """Rays p take the stack top, or finish when the stack is empty. With
    `cull`, a ray first skips every top entry whose box it has left
    (packet_common.skip_culled), counting them into `culls` (a work dict)
    unless it is None."""
    def dropped(q, top):
        if culls is not None:
            ref = s.stack_ref[q, top]
            rows = s.stack_cnt[q, top].clamp(min=1)
            culls["culled_node_visits"] += int((ref >= 0).sum())
            culls["culled_slot_tests"] += int(rows[ref < 0].sum()) * tpr

    sp = skip_culled(s, p, dropped) if cull else s.sp[p]
    has = sp > 0
    q, top = p[has], (sp[has] - 1).long()
    s.ref[q] = s.stack_ref[q, top]
    s.cnt[q] = s.stack_cnt[q, top]
    s.sp[p] = torch.where(has, sp - 1, sp)
    s.ref[p[~has]] = DONE


def _node_step(s: RayState, i: torch.Tensor, nodes, npr: int, lanes16,
               cull: bool, culls, tpr: int):
    """Rays i visit their internal node: test both children, descend the
    nearer hit child and push the farther (with its entry distance where
    pops cull), pop on a miss."""
    s.steps[i] += 1
    rec = fetch_nodes(nodes, s.ref[i], npr, lanes16)          # (|i|, 16)
    h0, b0, h1, b1, enc0, enc1, cnt0, cnt1 = visit_nodes(
        rec, s.o[i], s.inv[i], s.tn[i], s.ht[i])
    both = h0 & h1
    first0 = b0 <= b1               # near child first; a tie goes to child 0
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
    _pop(s, i[~(h0 | h1)], cull, culls, tpr)


def _leaf_step(s: RayState, i: torch.Tensor, tris, tpr: int,
               any_hit: bool, work, culls):
    """Rays i test the rows of their leaf (max(count, 1) of them; an
    any-hit ray stops after the first row that accepts a hit and is done),
    then pop."""
    s.steps[i] += 1
    row0 = (-s.ref[i] - 1).long()
    cnt = s.cnt[i].clamp(min=1)
    o, d, tn = s.o[i], s.d[i], s.tn[i]
    ht, hid, hu, hv = s.ht[i], s.hid[i], s.hu[i], s.hv[i]
    for k in range(int(cnt.max())):
        m = k < cnt
        if any_hit:
            m &= hid < 0
        if work is not None:
            tally(work, row0[:0], row0[m] + k, tpr)
        ht[m], hid[m], hu[m], hv[m] = accept_row(
            tris[row0[m] + k], o[m], d[m], tn[m], tpr, ht[m], hid[m], hu[m],
            hv[m])
    s.ht[i], s.hid[i], s.hu[i], s.hv[i] = ht, hid, hu, hv
    if any_hit:
        hit = hid >= 0
        s.ref[i[hit]] = DONE
        i = i[~hit]
    _pop(s, i, not any_hit, culls, tpr)
