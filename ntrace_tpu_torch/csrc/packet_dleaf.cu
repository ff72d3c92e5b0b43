// Deferred-leaf packet traversal: a packet of `rows` warps walks one node a
// step on a shared stack; a hit leaf's run of triangle rows goes onto the
// queue of each warp whose rays want it, and drains test one row of each
// warp's queue against that warp's rays.
//
// Replaces: ntrace_tpu/trace/packet_dleaf.py:_make_kernel, the Pallas TPU
// kernel behind trace_packet_dleaf (engine "packet_dleaf"). On the TPU the
// deferral turns lockstep leaf work into one (rows, 128) Moller-Trumbore
// tile in which each sublane tests its own row; a warp is that sublane
// here, and the kernel template of packet_batch.cuh does the step with a
// batch of one node (its note says what bounds it on an H100 and what the
// design does about it). A warp with nothing queued sits a drain out
// instead of re-testing row 0 (that filler only fills a TPU tile). The
// stack holds 128 nodes and cannot overflow on the trees the wrapper takes
// (depth <= 126); a queue holds 96 runs and cannot overflow at drain_min
// <= 64 (trace/packet_batch.py); MAX_STEPS 4,000,000 per packet. Any
// nodes_per_row.

#include "packet_batch.cuh"

extern "C" int ntrace_packet_dleaf(const void* nodes, const void* tris,
                                   const void* orig, const void* dirn,
                                   const void* tmin, const void* tmax,
                                   int n_rays, int nodes_per_row,
                                   int tris_per_row, int any_hit, int rows,
                                   int drain_min, void* out_tri, void* out_t,
                                   void* out_u, void* out_v, void* stream) {
    return ntrace::batch::launch<1, true, 128, 4000000LL>(
        nodes, tris, orig, dirn, tmin, tmax, n_rays, nodes_per_row,
        tris_per_row, any_hit, rows, 1, drain_min, 0, out_tri, out_t, out_u,
        out_v, stream);
}
