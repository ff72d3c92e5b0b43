"""Pipelined while-while BVH traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_pipe.py:trace_packet_pipe (273-330,
kernel 51-264). Same contract and tables as `trace/packet_ww.py`: orig/dirn
(R, 3) f32, tmin/tmax (R,) f32 -> tri i32, t, u, v f32; the closest hit,
lowest triangle id on a tie in t, the reference's miss record; any-hit
stops a ray at its first accepted hit; a dead ray is a miss at once.

The schedule is the reference's software-pipelined while-while, per ray
(csrc/packet_pipe.cu says how it maps to Hopper):
  - the node loop carries the current node's record; a step issues the
    loads of child 0, child 1 and the stack top before it slab-tests the
    carried record, then takes the next record from those three (a popping
    step never pushes, so the pre-step top is the pop target);
  - near/far comes from the pack-time order code in the cnt0 lane
    (packet_pipe.py:123-128) and the ray's own direction octant, the
    packet of one ray that a thread is;
  - hit leaves join a queue of row runs (QCAP 32 entries, the node loop
    paused at QCAP - 2), child 0 first;
  - the leaf loop carries (entry, row): the next entry is the run's next
    row or the queue slot below, and the queue is never rewritten.
The carried record is always the record of the ray's current node, and the
carried entry is what packet_ww's in-place queue write would hold, so the
twin runs the while-while state machine of trace/packet_ww.py with this
near/far rule: every ray takes the kernel's steps in the kernel's order.
Closest hits are bit-equal to trace_packet's (the fold is order-free);
any-hit `tri` may differ from packet_ww's, whose near/far rule differs.

Rays on a CUDA device go through the kernel; rays on the CPU through
`trace_packet_pipe_ref`. Nothing falls back.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel
from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_common import (RayState, check_leaf_runs,
                                                  check_rays, hit_outputs,
                                                  launch_traversal)
from ntrace_tpu_torch.trace.packet_ww import run_while_while


def trace_packet_pipe(tables: PackedTables, orig, dirn, tmin, tmax, *,
                      any_hit: bool = False):
    """Trace rays through `tables`. Returns (tri, t, u, v), each (R,)."""
    check_rays(tables, orig, dirn, tmin, tmax)
    check_leaf_runs(tables)
    if not uses_kernel(orig):
        return trace_packet_pipe_ref(tables, orig, dirn, tmin, tmax,
                                     any_hit=any_hit)
    outs = hit_outputs(orig)
    if orig.shape[0]:
        launch_traversal("ntrace_packet_pipe", tables, orig.contiguous(),
                         dirn.contiguous(), tmin.contiguous(),
                         tmax.contiguous(), any_hit, outs)
        trace_packet_pipe.launches += 1
    return outs


trace_packet_pipe.launches = 0   # kernel launches since the last reset


def near_by_code(s: RayState, i: torch.Tensor, b0, b1, cnt0):
    """packet_pipe.py:123-128: child 0 first when the ray's direction sign
    on the code's axis (cnt0 >> 1) matches the code's low-side bit (cnt0 &
    1). A shift outside [0, 32) reads a 0 bit, as shift_right_logical."""
    d = s.d[i]
    signs = ((d[:, 0] >= 0).to(torch.int32)
             | ((d[:, 1] >= 0).to(torch.int32) << 1)
             | ((d[:, 2] >= 0).to(torch.int32) << 2))
    sh = cnt0 >> 1
    ok = (sh >= 0) & (sh < 32)
    bit = torch.where(ok, (signs >> sh.clamp(0, 31)) & 1, 0)
    return bit == (cnt0 & 1)


def trace_packet_pipe_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                          any_hit: bool = False, work: dict | None = None):
    """Plain torch twin of the pipelined while-while kernel, on any device.
    `work` counts node visits and triangle slot tests as trace_packet_ref
    does."""
    return run_while_while(tables, orig, dirn, tmin, tmax, any_hit, work,
                           near_by_code)
