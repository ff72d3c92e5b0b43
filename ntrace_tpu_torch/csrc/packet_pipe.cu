// While-while BVH traversal with an early-issued node fetch over the
// lane-packed tables, one CUDA thread per ray.
//
// Replaces: ntrace_tpu/trace/packet_pipe.py:_make_kernel (registry engine
// packet_pipe). The TPU kernel is hand software pipelining for an in-order
// core with a static schedule: it carries the current node's row, issues
// the loads of every possible next row (child 0, child 1, the stack top)
// before the slab work, and selects one at the end of the step; its leaf
// loop loads the next row before the Moller-Trumbore work; and its node
// loop runs until the queue holds 30 runs. On an H100 a warp scheduler
// hides one warp's loads behind other warps' work, and the three records in
// flight cost a thread 48 registers (112 in all, against 48 for
// packet_ww.cu), which leaves fewer warps to do that. What is kept is what
// the engine computes and what sets it apart:
//   - near/far from the pack-time order code in the cnt0 lane (axis * 2 +
//     child 0 on the low side) and the ray's direction octant, the packet
//     of one ray that a thread is (packet_pipe.py:123-128); packet_ww.cu
//     orders by slab entry distance instead;
//   - the node fetch issued before the slab work. The order code is known
//     before the slab test, so a step first issues the load of the record it
//     will most likely take next, four float4 read-only loads into 16
//     registers: the code-near child when both children are internal, the
//     internal child when the other is a leaf, the stack top when both are
//     leaves (a popping step never pushed, so the pre-step top is the pop
//     target). Then both children of the carried record are slab-tested;
//     hit leaves are queued as runs first_row * 32 + rows - 1, child 0
//     first; of two hit internal children the code-near one is descended
//     and the other pushed. If the step takes another record than the one
//     in flight (a child missed), that one is loaded after the decision,
//     which is packet_ww.cu's critical path, paid only then.
// The node loop pauses as soon as a step queues a run, and the leaf loop
// tests the queue's rows, one Moller-Trumbore row per step, until it is
// empty, as in packet_ww.cu: so the running hit distance shrinks before the
// next box test, and the queue holds two runs (RunQueue<2>). An any-hit ray
// stops at its first accepted hit. The result does not depend on the
// visiting order (trace_common.cuh), so closest hits are bit-equal to
// packet_trace.cu's on every ray; which triangle an any-hit ray holds
// follows the order.
//
// What bounds it on an H100: as packet_ww.cu, the latency of dependent
// node and row fetches from L2 and divergence within a warp. The record in
// flight costs 16 registers beside the carried one (80 a thread against
// packet_ww.cu's 48), so fewer warps hide the latency; capping the kernel
// at 64 registers spills and is slower, and an L1 prefetch of the next row
// in the leaf loop gains nothing (scripts/ww_ab.py). The stack (512 bytes)
// and the queue live in local memory (the ptxas report in chip_smoke.py's
// phase 2). Leaves over 32 rows cannot be queued: the wrapper
// (trace/packet_pipe.py) refuses such tables.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) packet_pipe_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;

    const Ray ray = load_ray(orig, dirn, tmin, r);
    Hit hit{tmax[r], -1, 0.0f, 0.0f};
    // The packet of one ray: its direction octant (packet_signs).
    const int signs = (ray.dx >= 0.0f ? 1 : 0) | (ray.dy >= 0.0f ? 2 : 0)
                      | (ray.dz >= 0.0f ? 4 : 0);

    int stack[kStackDepth];
    int sp = 0;
    RunQueue<2> queue;
    // A dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    int item = hit.t > ray.tn ? 0 : kDone;
    long long steps = 0;
    float rec[kNodeLanes];   // the record of node `item`
    if (item != kDone) load_node(nodes, 0, npr, rec);

    while (item != kDone) {
        // Node loop on the carried record, until a step queues a run.
        while (item != kDone && queue.n == 0) {
            if (steps == kMaxSteps) { item = kDone; queue.n = 0; break; }
            ++steps;
            const int enc0 = static_cast<int>(rec[12]);
            const int enc1 = static_cast<int>(rec[13]);
            const int cnt0 = static_cast<int>(rec[14]);
            const int cnt1 = static_cast<int>(rec[15]);
            const bool l0 = enc0 < 0, l1 = enc1 < 0;
            const int sh = cnt0 >> 1;
            const int bit = (sh >= 0 && sh < 32) ? (signs >> sh) & 1 : 0;
            const bool first0 = bit == (cnt0 & 1);
            const int top = sp > 0 ? stack[sp - 1] : kDone;
            // 1. issue the load of the likeliest next record
            const int guess = !l0 && !l1 ? (first0 ? enc0 : enc1)
                              : !l0      ? enc0
                              : !l1      ? enc1
                                         : top;
            float pre[kNodeLanes];
            if (guess != kDone) load_node(nodes, guess, npr, pre);
            // 2. slab tests and decisions on the carried record
            float b0, b1;
            const bool h0 = slab(rec, ray, hit.t, &b0);
            const bool h1 = slab(rec + 6, ray, hit.t, &b1);
            if (h0 && l0) queue.push(run_entry(enc0, cnt0));
            if (h1 && l1) queue.push(run_entry(enc1, cnt1));
            const bool i0 = h0 && !l0, i1 = h1 && !l1;
            int next;
            if (i0 && i1) {
                stack[min(sp, kStackDepth - 1)] = first0 ? enc1 : enc0;
                sp = min(sp + 1, kStackDepth);
                next = first0 ? enc0 : enc1;
            } else if (i0) {
                next = enc0;
            } else if (i1) {
                next = enc1;
            } else {
                next = top;           // kDone when the stack is empty
                if (sp > 0) --sp;
            }
            // 3. the next record: the one in flight, or a late load
            if (next != kDone) {
                if (next == guess) {
#pragma unroll
                    for (int k = 0; k < kNodeLanes; ++k) rec[k] = pre[k];
                } else {
                    load_node(nodes, next, npr, rec);
                }
            }
            item = next;
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

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_pipe, packet_pipe_kernel)
