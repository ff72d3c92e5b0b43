// While-while BVH traversal over the lane-packed tables, one CUDA thread per
// ray, in the Aila-Laine while-while schedule.
//
// Replaces: ntrace_tpu/trace/packet_ww.py:_make_kernel, registry name
// tesla_persistent_while_while. It computes the same function, not the same
// schedule. The TPU kernel runs one shared SMEM stack and leaf queue per
// packet of rows x 128 rays, branch-free, with dump-slot writes and
// interleaved packets, and its node loop runs until the queue holds 30
// runs, since there a pause costs a packet-wide loop exit. None of that
// carries over to a GPU thread, which branches and gathers freely. What is
// kept is the phase split. Per ray:
//   node loop: fetch a node record and slab-test both children (no
//              triangle work). A hit leaf child becomes a queued run
//              first_row * 32 + rows - 1 (packet_ww.py:96-97), child 0
//              first; the nearer hit internal child is descended and the
//              farther pushed; with no internal child hit the ray pops.
//              The loop pauses as soon as a step queues a run, or when the
//              ray is done.
//   leaf loop: Moller-Trumbore on one row per step (no slab work), from
//              the run on top of the queue, until the queue is empty. An
//              any-hit ray stops at the first row that accepts a hit.
// The ray alternates the two loops until it is done. Choices made:
//   - a leaf is tested one node step after it is found, so the running hit
//     distance shrinks before the next box test: the node loop culls as
//     the packet kernel's does (the same node visits and slot tests within
//     0.1% on conference). A pause at 30 runs let the hit distance lag by
//     up to 30 leaves (2.2x the packet kernel's slot tests);
//   - a step queues at most two runs (child 0's, then child 1's), so the
//     queue holds two (RunQueue<2>, 16 bytes of local memory beside the
//     stack; two registers measured 2-4% slower, trace_common.cuh);
//   - per-ray queues and stacks, no warp voting: the loops are the
//     per-thread while-while of Aila and Laine (HPG 2009, section 3);
//   - near-first by the entry distances of the slab test (as
//     packet_trace.cu), not the pack-time order code the TPU kernel reads
//     because its packets share one stack (packet_pipe.cu keeps that rule);
//   - the stack (128 node indices) clamps on overflow as packet_trace.cu,
//     MAX_STEPS counts node and row steps alike.
// The result does not depend on the visiting order (trace_common.cuh
// numerics), so closest hits are bit-equal to packet_trace.cu's; which
// triangle an any-hit ray holds follows the order. A leaf that spans more
// than 32 rows cannot be queued; the wrapper (trace/packet_ww.py) refuses
// such tables.
//
// What bounds it on an H100: as packet_trace.cu, the latency of dependent
// node and row fetches from L2 and divergence within a warp; the stack
// (512 bytes) and the queue live in local memory (the ptxas report in
// chip_smoke.py's phase 2 says how much). Persistent warps that fetch
// 32-ray batches from a global counter measured 5-8% slower on the
// primary and shadow batches (scripts/ww_ab.py), so each thread traces
// the ray of its launch index.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int r,
    int npr, int tpr, int* __restrict__ out_tri, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    const Ray ray = load_ray(orig, dirn, tmin, r);
    Hit hit{tmax[r], -1, 0.0f, 0.0f};

    int stack[kStackDepth];
    int sp = 0;
    RunQueue<2> queue;
    // A dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    int item = hit.t > ray.tn ? 0 : kDone;
    long long steps = 0;

    while (item != kDone) {
        // Node loop: slab tests only, until a step queues a run.
        while (item != kDone && queue.n == 0) {
            if (steps == kMaxSteps) { item = kDone; queue.n = 0; break; }
            ++steps;
            float rec[kNodeLanes];
            load_node(nodes, item, npr, rec);
            float b0, b1;
            const bool h0 = slab(rec, ray, hit.t, &b0);
            const bool h1 = slab(rec + 6, ray, hit.t, &b1);
            const int enc0 = static_cast<int>(rec[12]);
            const int enc1 = static_cast<int>(rec[13]);
            const int cnt0 = static_cast<int>(rec[14]);
            const int cnt1 = static_cast<int>(rec[15]);
            const bool l0 = enc0 < 0, l1 = enc1 < 0;
            if (h0 && l0) queue.push(run_entry(enc0, cnt0));
            if (h1 && l1) queue.push(run_entry(enc1, cnt1));
            const bool i0 = h0 && !l0, i1 = h1 && !l1;
            if (i0 && i1) {
                // Near child first; a tie goes to child 0.
                const bool first0 = b0 <= b1;
                stack[min(sp, kStackDepth - 1)] = first0 ? enc1 : enc0;
                sp = min(sp + 1, kStackDepth);
                item = first0 ? enc0 : enc1;
            } else if (i0) {
                item = enc0;
            } else if (i1) {
                item = enc1;
            } else {
                item = sp > 0 ? stack[--sp] : kDone;
            }
        }
        // Leaf loop: one triangle row per step, from the top of the queue.
        while (queue.n > 0) {
            if (steps == kMaxSteps) { item = kDone; queue.n = 0; break; }
            ++steps;
            test_row(tris, queue.front() >> 5, tpr, ray, hit);
            queue.advance();
            if (kAnyHit && hit.id >= 0) { item = kDone; queue.n = 0; }
        }
    }
    store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) packet_ww_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;
    trace_ray<kAnyHit>(nodes, tris, orig, dirn, tmin, tmax, r, npr, tpr,
                       out_tri, out_t, out_u, out_v);
}

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_ww, packet_ww_kernel)
