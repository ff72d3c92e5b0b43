"""Node-batch packet traversal: the CUDA kernel and its torch twin.

Counterpart of ntrace_tpu/trace/packet_bfs.py:trace_packet_bfs (304-369,
kernel 52-301), the engine "packet_bfs". Same contract as
`trace/packet.py:trace_packet`: orig/dirn (R, 3) f32, tmin/tmax (R,) f32
-> tri i32, t, u, v f32; the closest hit, lowest triangle id on a tie in
t, tri -1 / t = tmax / u = v = 0 on a miss; in any-hit mode a packet stops
once every ray of it holds a hit or is dead.

A packet of `rows` warps shares one stack of up to 4,096 nodes; each step
pops up to 8 nodes, every ray slab-tests their 16 children, the packet's
OR routes them, and each warp tests the rows of the step's hit leaves
that its own rays want (trace/packet_batch.py has the schedule,
csrc/packet_bfs.cu the kernel).
Tables need nodes_per_row == 1 and a tree no deeper than 255. Rays on a
CUDA device go through the kernel, rays on the CPU through
`trace_packet_bfs_ref`. Nothing falls back.
"""

from __future__ import annotations

from ntrace_tpu_torch.tables import PackedTables
from ntrace_tpu_torch.trace.packet_batch import BFS, trace_batch, \
    trace_batch_ref


def trace_packet_bfs(tables: PackedTables, orig, dirn, tmin, tmax, *,
                     any_hit: bool = False, rows: int = 8):
    """Trace rays through `tables` in packets of `rows` warps. Returns
    (tri, t, u, v), each (R,)."""
    return trace_batch(trace_packet_bfs, BFS, tables, orig, dirn, tmin, tmax,
                       any_hit, rows)


trace_packet_bfs.launches = 0   # kernel launches since the last reset


def trace_packet_bfs_ref(tables: PackedTables, orig, dirn, tmin, tmax, *,
                         any_hit: bool = False, rows: int = 8,
                         work: dict | None = None):
    """Plain torch twin of the node-batch kernel, on any device
    (trace_batch_ref: the kernel's control flow, `work` counted)."""
    return trace_batch_ref(BFS, tables, orig, dirn, tmin, tmax,
                           any_hit=any_hit, rows=rows, work=work)
