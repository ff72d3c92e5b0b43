// Deferred-leaf packet traversal: a packet of `rows` warps walks one node a
// step on a shared stack; a hit leaf's run of triangle rows goes onto the
// queue of each warp whose rays want it, and the step's drains test rows
// of each warp's queue against that warp's rays.
//
// Replaces: ntrace_tpu/trace/packet_dleaf.py:_make_kernel, the Pallas TPU
// kernel behind trace_packet_dleaf (engine "packet_dleaf"). On the TPU the
// deferral turns lockstep leaf work into one (rows, 128) Moller-Trumbore
// tile in which each sublane tests its own row, a drain at a time; a warp
// is that sublane here, and the kernel template of packet_batch.cuh does
// the step with a batch of one node: the drain count of a step is worked
// out once, and each warp then tests its rows of all the step's drains in
// a row, with no block barrier between them (its note says what bounds it
// on an H100 and what the design does about it). A warp with nothing
// queued sits a drain out instead of re-testing row 0 (that filler only
// fills a TPU tile). The stack holds up to 128 nodes, sized at launch to
// what the tree's depth can need (depth <= 126); a queue holds 96 runs
// and cannot overflow at drain_min <= 64 (trace/packet_batch.py);
// MAX_STEPS 4,000,000 per packet. Any nodes_per_row.

#include "packet_batch.cuh"

extern "C" int ntrace_packet_dleaf(const void* nodes, const void* tris,
                                   const void* orig, const void* dirn,
                                   const void* tmin, const void* tmax,
                                   int n_rays, int nodes_per_row,
                                   int tris_per_row, int any_hit, int rows,
                                   int drain_min, int stack, void* out_tri,
                                   void* out_t, void* out_u, void* out_v,
                                   void* stream) {
    return ntrace::batch::launch<1, true, 128, 4000000LL>(
        nodes, tris, orig, dirn, tmin, tmax, n_rays, nodes_per_row,
        tris_per_row, any_hit, rows, 1, drain_min, 0, stack, out_tri, out_t,
        out_u, out_v, stream);
}

// What a launch with these knobs would run (packet_batch.cuh:occupancy).
extern "C" int ntrace_packet_dleaf_occupancy(int any_hit, int rows,
                                             int qgroup, int stack, int* out) {
    return ntrace::batch::occupancy<1, true, 128, 4000000LL>(
        any_hit, rows, qgroup, stack, out);
}
