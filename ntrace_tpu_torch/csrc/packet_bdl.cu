// Node-batch packet traversal with deferred leaves: packet_bfs's batch of up
// to 8 nodes a step, with per-warp wants masks; packet_dleaf's queues and
// drains, one queue for each group of `qgroup` warps, every warp of a group
// testing the union of the group's runs; with merge_sibs, the contiguous
// runs of two hit leaf siblings queue as one.
//
// Replaces: ntrace_tpu/trace/packet_bdl.py:_make_kernel, the Pallas TPU
// kernel behind trace_packet_bdl (engine "packet_bdl"). The TPU kernel
// extracts the per-row 16-child masks through rows / 2 packed reduces and
// pushes runs with branchless junk-slot SMEM stores; here each warp's
// __reduce_or_sync is its mask, warp 0 routes the batch and queues each
// group's runs in parallel (a lane a child, then a lane a group), and
// each warp tests its group's rows of the step's drains with no block
// barrier between them: the kernel template of packet_batch.cuh (its note
// says what bounds it on an H100 and what the design does about it). The
// stack holds up to 4,096 nodes, sized at launch to what the tree's depth
// can need (depth <= 255); a queue holds 96 runs and cannot overflow at
// drain_min <= 64 (trace/packet_batch.py); MAX_STEPS 1,000,000 per
// packet.

#include "packet_batch.cuh"

extern "C" int ntrace_packet_bdl(const void* nodes, const void* tris,
                                 const void* orig, const void* dirn,
                                 const void* tmin, const void* tmax,
                                 int n_rays, int nodes_per_row,
                                 int tris_per_row, int any_hit, int rows,
                                 int drain_min, int qgroup, int merge_sibs,
                                 int stack, void* out_tri, void* out_t,
                                 void* out_u, void* out_v, void* stream) {
    return ntrace::batch::launch<8, true, 4096, 1000000LL>(
        nodes, tris, orig, dirn, tmin, tmax, n_rays, nodes_per_row,
        tris_per_row, any_hit, rows, qgroup, drain_min, merge_sibs, stack,
        out_tri, out_t, out_u, out_v, stream);
}

// What a launch with these knobs would run (packet_batch.cuh:occupancy).
extern "C" int ntrace_packet_bdl_occupancy(int any_hit, int rows,
                                           int qgroup, int stack, int* out) {
    return ntrace::batch::occupancy<8, true, 4096, 1000000LL>(
        any_hit, rows, qgroup, stack, out);
}
