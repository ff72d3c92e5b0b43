// Closest-hit / any-hit BVH traversal over the lane-packed tables of
// ntrace_tpu/bvh/packed.py, one CUDA thread per ray.
//
// Replaces: ntrace_tpu/trace/packet_pallas.py:_make_kernel, the Pallas TPU
// packet kernel behind trace_packet. It computes the same function, not the
// same schedule. The TPU kernel walks one shared SMEM stack per tile of 1024+
// rays because a TPU has no per-lane gather; a GPU thread gathers freely, so
// here every ray runs its own Aila-Laine while-while loop:
//   inner loop: fetch a node record, slab-test both children against the
//               running hit distance, descend the nearer hit child and push
//               the farther one, pop on a miss; leave when the ray holds a
//               leaf reference (or is done);
//   leaf loop : Moller-Trumbore on every slot of every row the leaf spans,
//               then pop; leave when the ray pops an internal node.
// The stack is per thread: STACK_DEPTH (128) (ref, row count) entries in
// local memory, clamped on overflow exactly as packet_pallas.py:359-361
// clamps its shared stack, with MAX_STEPS as a backstop against malformed
// trees. Any-hit rays stop after the first leaf that accepts a hit.
//
// What bounds it on an H100: latency and divergence of the dependent
// node/row fetches. Each step's address comes from the previous step's
// record, and neighbouring rays of a warp part ways in the tree. The tables
// (17 MB for the conference scene) stay resident in the 50 MB L2, so the
// fetches are L2 hits, not HBM traffic. There is no matrix work and no
// fixed tile to stream, so wgmma and TMA have no place here. Persistent
// threads with dynamic ray fetch (kepler_dynamic_fetch) are the known next
// step; this first kernel is plain and exact.
//
// Numerics and table layout: trace_common.cuh, shared with packet_ww.cu
// and packet_ifif.cu.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

struct Ref {
    int ref;   // >= 0 internal node, < 0 leaf (-first_row - 1), kDone
    int cnt;   // leaf row count (meaningless for internal nodes)
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) packet_trace_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;   // no padding rays: the ragged edge is masked

    const Ray ray = load_ray(orig, dirn, tmin, r);
    Hit hit{tmax[r], -1, 0.0f, 0.0f};

    Ref stack[kStackDepth];
    int sp = 0;
    // A dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    int ref = hit.t > ray.tn ? 0 : kDone;
    int cnt = 0;
    long long steps = 0;

    while (ref != kDone) {
        while (ref >= 0) {
            if (steps == kMaxSteps) { ref = kDone; break; }
            ++steps;
            float rec[kNodeLanes];
            load_node(nodes, ref, npr, rec);
            float b0, b1;
            const bool h0 = slab(rec, ray, hit.t, &b0);
            const bool h1 = slab(rec + 6, ray, hit.t, &b1);
            const Ref c0{static_cast<int>(rec[12]), static_cast<int>(rec[14])};
            const Ref c1{static_cast<int>(rec[13]), static_cast<int>(rec[15])};
            Ref next;
            if (h0 && h1) {
                // Near child first; a tie goes to child 0.
                const bool first0 = b0 <= b1;
                stack[min(sp, kStackDepth - 1)] = first0 ? c1 : c0;
                sp = min(sp + 1, kStackDepth);
                next = first0 ? c0 : c1;
            } else if (h0) {
                next = c0;
            } else if (h1) {
                next = c1;
            } else if (sp > 0) {
                next = stack[--sp];
            } else {
                next = Ref{kDone, 0};
            }
            ref = next.ref;
            cnt = next.cnt;
        }
        while (ref < 0 && ref != kDone) {
            if (steps == kMaxSteps) { ref = kDone; break; }
            ++steps;
            const int row0 = -ref - 1;
            for (int k = 0; k < cnt; ++k) {
                test_row(tris, row0 + k, tpr, ray, hit);
            }
            if (kAnyHit && hit.id >= 0) { ref = kDone; break; }
            if (sp > 0) {
                const Ref next = stack[--sp];
                ref = next.ref;
                cnt = next.cnt;
            } else {
                ref = kDone;
            }
        }
    }
    store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_trace, packet_trace_kernel)
