"""While-while traversal with an early-issued node fetch: the CUDA kernel
and its torch twin.

Counterpart of ntrace_tpu/trace/packet_pipe.py:trace_packet_pipe (273-330,
kernel 51-264). Same contract and tables as `trace/packet_ww.py`: orig/dirn
(R, 3) f32, tmin/tmax (R,) f32 -> tri i32, t, u, v f32; the closest hit,
lowest triangle id on a tie in t, the reference's miss record; any-hit
stops a ray at its first accepted hit; a dead ray is a miss at once.

The schedule is packet_ww's while-while, per ray (csrc/packet_pipe.cu says
how it maps to Hopper), with what sets the reference's pipelined engine
apart:
  - near/far comes from the pack-time order code in the cnt0 lane
    (packet_pipe.py:123-128) and the ray's own direction octant, the
    packet of one ray that a thread is;
  - the kernel issues the fetch of the likeliest next record before the
    slab tests (predicted_next in trace/packet_ww.py: the code-near child
    when both children are internal, the internal one when the other is a
    leaf, else the stack top) and loads another only when the step takes
    another. That changes when a record is loaded, not which nodes a ray
    visits, so the twin runs trace/packet_ww.py's state machine with this
    near/far rule; `work` may count how often the guess was taken;
  - hit leaves join a queue of at most two runs, child 0 first, and the
    node loop pauses as soon as a step queues one.
Every ray takes the kernel's steps in the kernel's order. Closest hits are
bit-equal to trace_packet's (the fold is order-free); any-hit `tri` may
differ from packet_ww's, whose near/far rule differs.

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
    """Plain torch twin of the kernel, on any device. `work` counts node
    visits and triangle slot tests as trace_packet_ref does; where it has
    the keys "fetch_steps" and "fetch_predicted", also the node steps that
    go on to a node and those whose next node is the record the kernel
    fetched before the slab tests (run_while_while)."""
    return run_while_while(tables, orig, dirn, tmin, tmax, any_hit, work,
                           near_by_code)
