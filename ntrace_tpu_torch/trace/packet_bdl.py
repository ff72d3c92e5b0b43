"""Node-batch packet traversal with deferred leaves: the CUDA kernel and its
torch twin.

Counterpart of ntrace_tpu/trace/packet_bdl.py:trace_packet_bdl (388-461,
kernel 72-385), the engine "packet_bdl". Same contract as
`trace/packet.py:trace_packet` (tri, t, u, v; closest hit with the lowest
id on a tie; the miss record; in any-hit mode a packet stops once every
ray of it holds a hit or is dead).

packet_bfs's node batch (8 nodes a step on a stack of 4,096) with
packet_dleaf's queues and drains: one queue for each group of `qgroup`
warps (1, 2, 4, 8 or 16, dividing `rows`), every warp of a group testing
the union of the group's runs; `merge_sibs` queues the contiguous runs of
two hit leaf siblings as one (trace/packet_batch.py has the schedule,
csrc/packet_bdl.cu the kernel). Tables need nodes_per_row == 1 and a tree
no deeper than 255. Rays on a CUDA device go through the kernel, rays on
the CPU through `trace_packet_bdl_ref`. Nothing falls back.
"""

from __future__ import annotations

from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_batch import BDL, trace_batch, \
    trace_batch_ref


def trace_packet_bdl(tables: PackedTables, orig, dirn, tmin, tmax, *,
                     any_hit: bool = False, rows: int = 8, drain_min: int = 0,
                     qgroup: int = 1, merge_sibs: bool = False):
    """Trace rays through `tables` in packets of `rows` warps. Returns
    (tri, t, u, v), each (R,)."""
    return trace_batch(trace_packet_bdl, BDL, tables, orig, dirn, tmin, tmax,
                       any_hit, rows, qgroup, drain_min, merge_sibs)


trace_packet_bdl.launches = 0   # kernel launches since the last reset


def trace_packet_bdl_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                         any_hit: bool = False, rows: int = 8,
                         drain_min: int = 0, qgroup: int = 1,
                         merge_sibs: bool = False, work: dict | None = None):
    """Plain torch twin of the kernel, on any device (trace_batch_ref: the
    kernel's control flow, `work` counted)."""
    return trace_batch_ref(BDL, tables, orig, dirn, tmin, tmax,
                           any_hit=any_hit, rows=rows, qgroup=qgroup,
                           drain_min=drain_min, merge_sibs=merge_sibs,
                           work=work)
