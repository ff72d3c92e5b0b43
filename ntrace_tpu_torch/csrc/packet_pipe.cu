// Pipelined while-while BVH traversal over the lane-packed tables, one CUDA
// thread per ray.
//
// Replaces: ntrace_tpu/trace/packet_pipe.py:_make_kernel (registry engine
// packet_pipe). The TPU kernel is hand software pipelining for an in-order
// core with a static schedule: it carries the current node's row, issues
// the loads of every possible next row (child 0, child 1, the stack top)
// before the slab work on the carried row, and selects the next row from
// them at the end of the step; its leaf loop carries (entry, row) and
// loads the next row before the Moller-Trumbore work. Per ray, here:
//   node loop: the record of the current node is carried in registers. A
//              step first issues the loads of child 0's and child 1's
//              records (when they are internal) and of the stack top's
//              (when the stack holds one): a step that pops never pushed,
//              so the pre-step top is the pop target. Then both children
//              of the carried record are slab-tested; hit leaves become
//              queue entries first_row * 32 + rows - 1, child 0 first; of
//              two hit internal children the order code in the cnt0 lane
//              (axis * 2 + child 0 on the low side) and the ray's
//              direction octant pick the near one (packet_pipe.py:123-128),
//              the far one is pushed. The next carried record is picked
//              from the three loaded ones. The loop pauses at QCAP - 2
//              queued runs (QCAP 32).
//   leaf loop: carries the entry on top of the queue. A step computes the
//              next entry (the run's next row, or the queue slot below)
//              and prefetches that row into L1 before it tests the carried
//              row, one Moller-Trumbore row per step. The queue is never
//              rewritten. An any-hit ray stops at its first accepted hit.
// On Hopper the loads issued first are the point: an out-of-order warp
// scheduler hides one dependent L2 load behind another warp's work, but a
// thread's own next node fetch sits on its critical path, and issuing it
// before the slab arithmetic overlaps the two within the thread.
// The result does not depend on the visiting order (trace_common.cuh), so
// closest hits are bit-equal to packet_trace.cu's on every ray.
//
// What bounds it on an H100: as packet_ww.cu, the latency of dependent
// node and row fetches from L2 and divergence within a warp; the three
// prefetched records cost 48 registers a thread, and the stack (512 bytes)
// and queue (128 bytes) live in local memory (the ptxas report in
// chip_smoke.py's phase 2). Leaves over 32 rows cannot be queued: the
// wrapper (trace/packet_pipe.py) refuses such tables.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

constexpr int kQcap = 32;   // packet_pipe.py QCAP

__device__ __forceinline__ void copy_rec(const float* src, float* dst) {
#pragma unroll
    for (int k = 0; k < kNodeLanes; ++k) dst[k] = src[k];
}

// L1 prefetch of the used lanes of triangle row `row` (tpr * 40 bytes).
__device__ __forceinline__ void prefetch_row(const float* tris, int row,
                                             int tpr) {
    const char* p = reinterpret_cast<const char*>(
        tris + static_cast<size_t>(row) * kRowLanes);
    const int bytes = tpr * kTriLanes * 4;
    for (int b = 0; b < bytes; b += 128) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(p + b));
    }
}

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
    int queue[kQcap];
    int sp = 0, qn = 0;
    // A dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    int item = hit.t > ray.tn ? 0 : kDone;
    long long steps = 0;
    float rec[kNodeLanes];
    if (item != kDone) load_node(nodes, 0, npr, rec);

    while (item != kDone) {
        // Node loop on the carried record.
        while (item != kDone && qn < kQcap - 2) {
            if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
            ++steps;
            const int enc0 = static_cast<int>(rec[12]);
            const int enc1 = static_cast<int>(rec[13]);
            const int cnt0 = static_cast<int>(rec[14]);
            const int cnt1 = static_cast<int>(rec[15]);
            const int top = sp > 0 ? stack[sp - 1] : kDone;
            // 1. issue the loads of every possible next record
            float row_a[kNodeLanes], row_b[kNodeLanes], row_s[kNodeLanes];
            if (enc0 >= 0) load_node(nodes, enc0, npr, row_a);
            if (enc1 >= 0) load_node(nodes, enc1, npr, row_b);
            if (top != kDone) load_node(nodes, top, npr, row_s);
            // 2. slab tests and decisions on the carried record
            float b0, b1;
            const bool h0 = slab(rec, ray, hit.t, &b0);
            const bool h1 = slab(rec + 6, ray, hit.t, &b1);
            const bool l0 = enc0 < 0, l1 = enc1 < 0;
            if (h0 && l0) queue[qn++] = run_entry(enc0, cnt0);
            if (h1 && l1) queue[qn++] = run_entry(enc1, cnt1);
            const bool i0 = h0 && !l0, i1 = h1 && !l1;
            int next;
            if (i0 && i1) {
                const int sh = cnt0 >> 1;
                const int bit = (sh >= 0 && sh < 32) ? (signs >> sh) & 1 : 0;
                const bool first0 = bit == (cnt0 & 1);
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
            // 3. the next carried record, from the loaded ones
            if (next == enc0 && !l0) {
                copy_rec(row_a, rec);
            } else if (next == enc1 && !l1) {
                copy_rec(row_b, rec);
            } else if (next != kDone) {
                copy_rec(row_s, rec);
            }
            item = next;
        }
        // Leaf loop on the carried entry.
        if (qn > 0) {
            int entry = queue[qn - 1];
            while (qn > 0) {
                if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
                ++steps;
                const bool more = (entry & 31) > 0;
                const int next = more ? entry + 31 : queue[max(qn - 2, 0)];
                prefetch_row(tris, next >> 5, tpr);
                test_row(tris, entry >> 5, tpr, ray, hit);
                if (!more) --qn;
                entry = next;
                if (kAnyHit && hit.id >= 0) { item = kDone; qn = 0; }
            }
        }
    }
    store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_pipe, packet_pipe_kernel)
