// Node-batch packet traversal: a packet of `rows` warps pops up to 8 nodes
// a step off one shared stack, every ray slab-tests their 16 children, and
// each warp tests the rows of the step's hit leaves that its own rays want.
//
// Replaces: ntrace_tpu/trace/packet_bfs.py:_make_kernel, the Pallas TPU
// kernel behind trace_packet_bfs (engine "packet_bfs"). The TPU kernel
// batches nodes to split one scalar chain per node over 8 independent row
// loads, folds the 16 verdicts in four packed reduces, and tests every run
// of the step on the whole packet, since its sublanes run in lockstep and
// skipping one saves nothing; here a block is the packet, a warp issues on
// its own and skips the runs its wants mask does not select, and the
// kernel template of packet_batch.cuh does the step (its note says what
// bounds it on an H100 and what the design does about it). The stack
// holds up to 4,096 nodes, sized at launch to what the tree's depth can
// need (depth <= 255, trace/packet_batch.py); MAX_STEPS 1,000,000 per
// packet.

#include "packet_batch.cuh"

extern "C" int ntrace_packet_bfs(const void* nodes, const void* tris,
                                 const void* orig, const void* dirn,
                                 const void* tmin, const void* tmax,
                                 int n_rays, int nodes_per_row,
                                 int tris_per_row, int any_hit, int rows,
                                 int stack, void* out_tri, void* out_t,
                                 void* out_u, void* out_v, void* stream) {
    return ntrace::batch::launch<8, false, 4096, 1000000LL>(
        nodes, tris, orig, dirn, tmin, tmax, n_rays, nodes_per_row,
        tris_per_row, any_hit, rows, 1, 1, 0, stack, out_tri, out_t, out_u,
        out_v, stream);
}

// What a launch with these knobs would run (packet_batch.cuh:occupancy).
extern "C" int ntrace_packet_bfs_occupancy(int any_hit, int rows,
                                           int qgroup, int stack, int* out) {
    return ntrace::batch::occupancy<8, false, 4096, 1000000LL>(
        any_hit, rows, qgroup, stack, out);
}
