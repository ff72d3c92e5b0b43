"""Deferred-leaf packet traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_dleaf.py:trace_packet_dleaf
(323-383, kernel 122-320), the engine "packet_dleaf". Same contract as
`trace/packet.py:trace_packet` (tri, t, u, v; closest hit with the lowest
id on a tie; the miss record; in any-hit mode a packet stops once every
ray of it holds a hit or is dead).

A packet of `rows` warps walks one node a step on a shared stack of 128,
near first by the pack-time order code; a hit leaf's run of triangle rows
goes onto the queue (96 runs) of each warp whose rays want it, and drains
test one row of each warp's queue against that warp's rays while at least
`drain_min` rows are pending (0: one per warp), or while the stack is
empty and rows are pending (trace/packet_batch.py has the schedule,
csrc/packet_dleaf.cu the kernel). Any nodes_per_row; trees no deeper than
126. Rays on a CUDA device go through the kernel, rays on the CPU through
`trace_packet_dleaf_ref`. Nothing falls back.
"""

from __future__ import annotations

from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_batch import DLEAF, trace_batch, \
    trace_batch_ref


def trace_packet_dleaf(tables: PackedTables, orig, dirn, tmin, tmax, *,
                       any_hit: bool = False, rows: int = 8,
                       drain_min: int = 0):
    """Trace rays through `tables` in packets of `rows` warps. Returns
    (tri, t, u, v), each (R,)."""
    return trace_batch(trace_packet_dleaf, DLEAF, tables, orig, dirn, tmin,
                       tmax, any_hit, rows, drain_min=drain_min)


trace_packet_dleaf.launches = 0   # kernel launches since the last reset


def trace_packet_dleaf_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                           any_hit: bool = False, rows: int = 8,
                           drain_min: int = 0, work: dict | None = None):
    """Plain torch twin of the deferred-leaf kernel, on any device
    (trace_batch_ref: the kernel's control flow, `work` counted)."""
    return trace_batch_ref(DLEAF, tables, orig, dirn, tmin, tmax,
                           any_hit=any_hit, rows=rows, drain_min=drain_min,
                           work=work)
