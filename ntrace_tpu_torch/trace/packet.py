"""BVH traversal over the packed tables: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_pallas.py:trace_packet (416-514).
`trace_packet` keeps the reference's public layout (orig/dirn (R, 3) f32,
tmin/tmax (R,) f32 -> tri i32, t, u, v f32, each (R,)) and its result: the
closest hit, lowest triangle id on a tie in t, tri -1 / t = tmax / u = v = 0
on a miss; any-hit mode stops a ray at the first leaf that accepts a hit.

Rays on a CUDA device go through the hand-written kernel
(csrc/packet_trace.cu); rays on the CPU go through `trace_packet_ref`, a
lockstep per-ray while-while in torch with the kernel's exact control flow
and op order. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.ops.aabb import safe_inv_dir
from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_common import INT_MAX, mt_row_best, slab_child

STACK_DEPTH = 128          # as packet_pallas.py STACK_DEPTH
MAX_STEPS = 4_000_000      # malformed-tree backstop, per ray
DONE = -(2 ** 31)          # traversal reference: nothing left to visit


def _check(tables: PackedTables, orig, dirn, tmin, tmax):
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


def trace_packet(tables: PackedTables, orig, dirn, tmin, tmax, *,
                 any_hit: bool = False):
    """Trace rays through `tables`. Returns (tri, t, u, v), each (R,)."""
    _check(tables, orig, dirn, tmin, tmax)
    if not uses_kernel(orig):
        return trace_packet_ref(tables, orig, dirn, tmin, tmax,
                                any_hit=any_hit)
    r = orig.shape[0]
    dev = orig.device
    outs = (torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.float32, device=dev))
    if r:
        _launch(tables, orig.contiguous(), dirn.contiguous(),
                tmin.contiguous(), tmax.contiguous(), any_hit, outs)
        trace_packet.launches += 1
    return outs


trace_packet.launches = 0   # kernel launches since the last reset


def _launch(tables, orig, dirn, tmin, tmax, any_hit, outs):
    """One launch of ntrace_packet_trace on the current CUDA stream."""
    from ntrace_tpu_torch.kernels.build import library

    for t in (tables.nodes8, tables.tris12):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("packed tables must be contiguous and 16-byte "
                             "aligned (node records load as float4)")
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        rc = library().ntrace_packet_trace(
            tables.nodes8.data_ptr(), tables.tris12.data_ptr(),
            orig.data_ptr(), dirn.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), orig.shape[0], tables.nodes_per_row,
            tables.tris_per_row, int(any_hit), *(o.data_ptr() for o in outs),
            stream)
    if rc != 0:
        raise RuntimeError(f"ntrace_packet_trace launch failed: CUDA error "
                           f"{rc}")


class _RayState:
    """Per-ray traversal state of the twin, for the rays still in flight."""

    FIELDS = ("ids", "o", "d", "inv", "tn", "ht", "hid", "hu", "hv", "ref",
              "cnt", "sp", "steps", "stack_ref", "stack_cnt")

    def __init__(self, **kw):
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    def take(self, keep: torch.Tensor) -> "_RayState":
        return _RayState(**{k: getattr(self, k)[keep] for k in self.FIELDS})


def trace_packet_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                     any_hit: bool = False, work: dict | None = None):
    """Plain torch twin of the CUDA kernel, on any device.

    Each ray runs the kernel's while-while as a state machine: per lockstep
    iteration a ray either visits one internal node or tests one leaf, so
    every ray performs exactly the kernel's sequence of steps, with the same
    stack (clamped at STACK_DEPTH), the same near-first order and the same
    slab and Moller-Trumbore op order (trace/packet_common.py).
    `work`, when given, counts the kernel's work on these rays into
    work["node_visits"] and work["tri_slot_tests"] (leaf rows times
    tris_per_row).
    """
    _check(tables, orig, dirn, tmin, tmax)
    dev = orig.device
    r = orig.shape[0]
    nodes = tables.nodes8.reshape(-1)
    tris = tables.tris12
    npr, tpr = tables.nodes_per_row, tables.tris_per_row
    out = [torch.full((r,), -1, dtype=torch.int32, device=dev), tmax.clone(),
           torch.zeros((r,), dtype=torch.float32, device=dev),
           torch.zeros((r,), dtype=torch.float32, device=dev)]
    # A dead ray (tmax <= tmin, or NaN) keeps the miss record, as in the
    # kernel.
    ids = torch.nonzero(tmax > tmin).squeeze(1)
    n = ids.numel()
    i32 = dict(dtype=torch.int32, device=dev)
    s = _RayState(
        ids=ids, o=orig[ids], d=dirn[ids], inv=safe_inv_dir(dirn[ids]),
        tn=tmin[ids], ht=tmax[ids], hid=torch.full((n,), -1, **i32),
        hu=torch.zeros((n,), dtype=torch.float32, device=dev),
        hv=torch.zeros((n,), dtype=torch.float32, device=dev),
        ref=torch.zeros((n,), **i32), cnt=torch.zeros((n,), **i32),
        sp=torch.zeros((n,), **i32),
        steps=torch.zeros((n,), dtype=torch.int64, device=dev),
        stack_ref=torch.zeros((n, STACK_DEPTH), **i32),
        stack_cnt=torch.zeros((n, STACK_DEPTH), **i32))
    lanes16 = torch.arange(16, device=dev)
    if work is not None:
        work.setdefault("node_visits", 0)
        work.setdefault("tri_slot_tests", 0)
    while n:
        s.ref = torch.where(s.steps >= MAX_STEPS,
                            torch.full_like(s.ref, DONE), s.ref)
        inner = torch.nonzero(s.ref >= 0).squeeze(1)
        leaf = torch.nonzero((s.ref < 0) & (s.ref != DONE)).squeeze(1)
        if work is not None:
            work["node_visits"] += inner.numel()
            work["tri_slot_tests"] += int(s.cnt[leaf].sum()) * tpr
        if inner.numel():
            _node_step(s, inner, nodes, npr, lanes16)
        if leaf.numel():
            _leaf_step(s, leaf, tris, tpr, any_hit)
        done = s.ref == DONE
        n_done = int(done.sum())
        if 2 * n_done >= n:   # retire finished rays, shrink the state
            fin = s.ids[done]
            for o, v in zip(out, (s.hid, s.ht, s.hu, s.hv)):
                o[fin] = v[done]
            s = s.take(~done)
            n -= n_done
    return tuple(out)


def _pop(s: _RayState, p: torch.Tensor):
    """Rays p take the stack top, or finish when the stack is empty."""
    sp = s.sp[p]
    has = sp > 0
    q, top = p[has], (sp[has] - 1).long()
    s.ref[q] = s.stack_ref[q, top]
    s.cnt[q] = s.stack_cnt[q, top]
    s.sp[q] = top.to(torch.int32)
    s.ref[p[~has]] = DONE


def _node_step(s: _RayState, i: torch.Tensor, nodes, npr: int, lanes16):
    """Rays i visit their internal node: test both children, descend the
    nearer hit child and push the farther, pop on a miss."""
    s.steps[i] += 1
    node = s.ref[i].long()
    base = (node // npr) * 128 + (node % npr) * 16
    rec = nodes[base[:, None] + lanes16]                    # (|i|, 16)
    o, inv, tn, ht = s.o[i], s.inv[i], s.tn[i], s.ht[i]
    args = (o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2],
            tn, ht)
    h0, b0 = slab_child(rec, 0, *args)
    h1, b1 = slab_child(rec, 6, *args)
    enc0, enc1 = rec[:, 12].to(torch.int32), rec[:, 13].to(torch.int32)
    cnt0, cnt1 = rec[:, 14].to(torch.int32), rec[:, 15].to(torch.int32)
    both = h0 & h1
    first0 = b0 <= b1               # near child first; a tie goes to child 0
    sp = s.sp[i]
    pushed = i[both]
    slot = sp[both].clamp(max=STACK_DEPTH - 1).long()
    s.stack_ref[pushed, slot] = torch.where(first0, enc1, enc0)[both]
    s.stack_cnt[pushed, slot] = torch.where(first0, cnt1, cnt0)[both]
    s.sp[i] = torch.where(both, (sp + 1).clamp(max=STACK_DEPTH), sp)
    done = torch.full_like(enc0, DONE)
    s.ref[i] = torch.where(both, torch.where(first0, enc0, enc1),
                           torch.where(h0, enc0, torch.where(h1, enc1, done)))
    s.cnt[i] = torch.where(both, torch.where(first0, cnt0, cnt1),
                           torch.where(h0, cnt0, cnt1))
    _pop(s, i[~(h0 | h1)])


def _leaf_step(s: _RayState, i: torch.Tensor, tris, tpr: int,
               any_hit: bool):
    """Rays i test every slot of every row of their leaf, then pop."""
    s.steps[i] += 1
    row0 = (-s.ref[i] - 1).long()
    cnt = s.cnt[i]
    o, d, tn = s.o[i], s.d[i], s.tn[i]
    ht, hid, hu, hv = s.ht[i], s.hid[i], s.hu[i], s.hv[i]
    for k in range(int(cnt.max())):
        m = k < cnt
        bt, bid, bu, bv = mt_row_best(
            tris[row0[m] + k], o[m, 0], o[m, 1], o[m, 2], d[m, 0], d[m, 1],
            d[m, 2], tn[m], tpr)
        ct, cid = ht[m], hid[m]
        acc = (bid != INT_MAX) & ((bt < ct) | ((bt == ct) & (bid < cid)))
        ht[m] = torch.where(acc, bt, ct)
        hid[m] = torch.where(acc, bid, cid)
        hu[m] = torch.where(acc, bu, hu[m])
        hv[m] = torch.where(acc, bv, hv[m])
    s.ht[i], s.hid[i], s.hu[i], s.hv[i] = ht, hid, hu, hv
    if any_hit:
        hit = hid >= 0
        s.ref[i[hit]] = DONE
        i = i[~hit]
    _pop(s, i)
