"""Speculative while-while BVH traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_ifif.py:trace_packet_ifif
(250-328), registry name `tesla_persistent_speculative_while_while`. Same
contract as `trace/packet.py:trace_packet` (closest hit with the lowest id
on a tie in t, the reference's miss record, any-hit stops at the first
leaf row that accepts a hit, dead rays are misses at once).

The schedule is Aila and Laine's speculative while-while (HPG 2009, §3),
run by each warp of 32 consecutive rays in lockstep (csrc/packet_ifif.cu
says why). Work items use the reference's mixed encoding
(packet_ifif.py:18-23): item >= 0 is a node, item < 0 a leaf run,
v = -item - 1 with first row v >> 5 and v & 31 more rows; DONE is INT_MIN
here. A ray that meets a leaf postpones it and keeps walking (the
speculation); the warp runs node steps while a vote finds a lane still
searching for its first leaf, then leaf steps (each testing a run, an
any-hit ray only up to its first accepting row) while a vote finds a lane
holding one. A closest-hit ray keeps the slab entry distance of each
item's box and drops an item whose box it has left: on every pop, and
after a leaf step for the item it held through it. The closest-hit result
does not depend on the order of leaves, so it is bit-equal to
trace_packet's; the any-hit triangle does, and the twin models the warps
and their votes so that it is bit-equal to the kernel's too.

Rays on a CUDA device go through the kernel; rays on the CPU through
`trace_packet_ifif_ref`. Nothing falls back.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_common import (DONE, MAX_STEPS,
                                                  RUN_ROWS, STACK_DEPTH,
                                                  RayState, accept_row,
                                                  check_leaf_runs, check_rays,
                                                  culled, fetch_nodes,
                                                  hit_outputs,
                                                  launch_traversal, retire,
                                                  run_entry, skip_culled,
                                                  start_twin, start_work,
                                                  tally, visit_nodes)

WARP = 32          # rays that vote together: one CUDA warp
NO_LEAF = 0        # the postponed-leaf slot is empty (a leaf item is < 0)


def trace_packet_ifif(tables: PackedTables, orig, dirn, tmin, tmax, *,
                      any_hit: bool = False):
    """Trace rays through `tables`. Returns (tri, t, u, v), each (R,)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_leaf_runs(tables)
    if not uses_kernel(orig):
        return trace_packet_ifif_ref(tables, orig, dirn, tmin, tmax,
                                     any_hit=any_hit)
    outs = hit_outputs(orig)
    if orig.shape[0]:
        launch_traversal("ntrace_packet_ifif", tables, orig.contiguous(),
                         dirn.contiguous(), tmin.contiguous(),
                         tmax.contiguous(), any_hit, outs)
        trace_packet_ifif.launches += 1
    return outs


trace_packet_ifif.launches = 0   # kernel launches since the last reset


def _warp_any(flag: torch.Tensor, warp: torch.Tensor, n_warps: int):
    """Per-warp OR of a per-ray flag (__any_sync over the warp)."""
    out = torch.zeros((n_warps,), dtype=torch.bool, device=flag.device)
    out[warp[flag]] = True
    return out


def trace_packet_ifif_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                          any_hit: bool = False, work: dict | None = None):
    """Plain torch twin of the speculative while-while kernel, on any
    device.

    Ray r belongs to warp r // 32, as in the kernel's launch. Per lockstep
    iteration every warp is in its node phase or its leaf phase: in a node
    phase each of its rays with a node item visits it, in a leaf phase each
    ray holding a postponed leaf tests it; then the warp votes its next
    phase exactly as the kernel does. `work`, when given, counts node
    visits and triangle slot tests (rows tested times tris_per_row), and,
    where it has their keys, the culled items (work["culled_node_visits"],
    work["culled_slot_tests"]), as trace_packet_ref does.
    """
    check_rays(tables, orig, dirn, tmin, tmax)
    check_leaf_runs(tables)
    dev = orig.device
    nodes = tables.nodes8.reshape(-1)
    tris = tables.tris12
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    n_warps = -(-orig.shape[0] // WARP)
    cull = not any_hit
    out, s = start_twin(orig, dirn, tmin, tmax)
    s.warp = s.ids // WARP
    s.item, s.sp = s.zeros(), s.zeros()
    s.leaf = s.zeros()                        # NO_LEAF
    s.stack = s.zeros(STACK_DEPTH)
    if cull:
        # Entry distances of the item in hand and of the stacked items.
        s.item_b = s.zeros(dtype=torch.float32)
        s.stack_b = s.zeros(STACK_DEPTH, dtype=torch.float32)
    node_phase = torch.ones((n_warps,), dtype=torch.bool, device=dev)
    lanes16 = torch.arange(16, device=dev)
    start_work(work)
    # The culled items are counted where the caller's `work` asks for them.
    culls = work if work is not None and "culled_node_visits" in work \
        else None
    while s.ids.numel():
        ph = node_phase[s.warp]
        inner = ph & (s.item >= 0)
        leafy = ~ph & (s.leaf < 0)
        # The backstop: a ray at MAX_STEPS that would step stops there.
        cut = (inner | leafy) & (s.steps >= MAX_STEPS)
        s.item[cut] = DONE
        s.leaf[cut] = NO_LEAF
        inner = torch.nonzero(inner & ~cut).squeeze(1)
        leafy = torch.nonzero(leafy & ~cut).squeeze(1)
        if work is not None:
            tally(work, s.item[inner], inner[:0], tpr)
        if inner.numel():
            _node_step(s, inner, nodes, npr, lanes16, cull, culls, tpr)
        if leafy.numel():
            _leaf_step(s, leafy, tris, tpr, any_hit, work, culls)
        # The votes: a node phase goes on while a lane still searches for
        # its first leaf, a leaf phase while a lane holds one.
        searching = _warp_any((s.item >= 0) & (s.leaf >= 0), s.warp, n_warps)
        holding = _warp_any(s.leaf < 0, s.warp, n_warps)
        node_phase = torch.where(node_phase, searching, ~holding)
        s = retire(s, (s.item == DONE) & (s.leaf >= 0), out)
    return tuple(out)


def _count_culled(culls, items: torch.Tensor, tpr: int):
    """Count culled items into `culls` (a work dict; None counts nothing):
    a node a visit, a run its slots."""
    if culls is None or not items.numel():
        return
    v = -items[items < 0] - 1
    culls["culled_node_visits"] += int((items >= 0).sum())
    culls["culled_slot_tests"] += int(((v & (RUN_ROWS - 1)) + 1).sum()) * tpr


def _pop(s: RayState, i: torch.Tensor, cull: bool, culls, tpr: int):
    """The stack top of rays i (popped), or DONE where a stack is empty;
    with `cull`, past every entry whose box the ray has left
    (packet_common.skip_culled). Returns the items and, with `cull`, their
    entry distances (else None)."""
    if cull:
        sp = skip_culled(s, i, lambda q, top: _count_culled(
            culls, s.stack[q, top], tpr))
    else:
        sp = s.sp[i]
    can = sp > 0
    top = (sp - 1).clamp(min=0).long()
    popped = torch.where(can, s.stack[i, top], DONE)
    s.sp[i] = torch.where(can, sp - 1, sp)
    return popped, (s.stack_b[i, top] if cull else None)


def _take(s: RayState, i: torch.Tensor, cull: bool, culls, tpr: int):
    """Rays i take their popped item (and its entry distance) in hand."""
    s.item[i], b = _pop(s, i, cull, culls, tpr)
    if cull:
        s.item_b[i] = b


def _node_step(s: RayState, i: torch.Tensor, nodes, npr: int, lanes16,
               cull: bool, culls, tpr: int):
    """Rays i visit their node: children become work items (nodes as they
    are, leaves as runs), the nearer hit child is next and the farther is
    pushed (with its entry distance where pops cull); a miss pops. A leaf
    item then goes to the empty postponed-leaf slot and the ray pops on:
    the speculative walk."""
    s.steps[i] += 1
    rec = fetch_nodes(nodes, s.item[i], npr, lanes16)
    h0, b0, h1, b1, enc0, enc1, cnt0, cnt1 = visit_nodes(
        rec, s.o[i], s.inv[i], s.tn[i], s.ht[i])
    it0 = torch.where(enc0 < 0, -run_entry(enc0, cnt0) - 1, enc0)
    it1 = torch.where(enc1 < 0, -run_entry(enc1, cnt1) - 1, enc1)
    both = h0 & h1
    first0 = b0 <= b1               # near child first; a tie goes to child 0
    sp = s.sp[i]
    slot = sp[both].clamp(max=STACK_DEPTH - 1).long()
    s.stack[i[both], slot] = torch.where(first0, it1, it0)[both]
    if cull:
        s.stack_b[i[both], slot] = torch.where(first0, b1, b0)[both]
        s.item_b[i] = torch.where(both, torch.where(first0, b0, b1),
                                  torch.where(h0, b0, b1))
    s.sp[i] = torch.where(both, (sp + 1).clamp(max=STACK_DEPTH), sp)
    s.item[i] = torch.where(both, torch.where(first0, it0, it1),
                            torch.where(h0, it0, it1))
    _take(s, i[~(h0 | h1)], cull, culls, tpr)
    nxt = s.item[i]
    p = i[(nxt < 0) & (nxt != DONE) & (s.leaf[i] >= 0)]
    s.leaf[p] = s.item[p]
    _take(s, p, cull, culls, tpr)


def _leaf_step(s: RayState, i: torch.Tensor, tris, tpr: int,
               any_hit: bool, work, culls):
    """Rays i test the rows of their postponed leaf run (an any-hit ray up
    to the first row that accepts a hit, and is then done). A closest-hit
    ray then drops the item it held if the ray has left its box, and pops
    on; the next leaf item, if the ray holds one, takes the slot and the
    ray pops on."""
    s.steps[i] += 1
    v = -s.leaf[i] - 1
    row0 = (v >> 5).long()
    rows = (v & (RUN_ROWS - 1)) + 1
    o, d, tn = s.o[i], s.d[i], s.tn[i]
    ht, hid, hu, hv = s.ht[i], s.hid[i], s.hu[i], s.hv[i]
    for k in range(int(rows.max())):
        m = k < rows
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
        s.item[i[hit]] = DONE
        s.leaf[i[hit]] = NO_LEAF
        i = i[~hit]
    else:
        item = s.item[i]
        stale = (item != DONE) & culled(s.item_b[i], s.ht[i])
        _count_culled(culls, item[stale], tpr)
        _take(s, i[stale], True, culls, tpr)
    item = s.item[i]
    nxt_leaf = (item < 0) & (item != DONE)
    s.leaf[i] = torch.where(nxt_leaf, item, NO_LEAF)
    _take(s, i[nxt_leaf], not any_hit, culls, tpr)
