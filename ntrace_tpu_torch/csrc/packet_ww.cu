// While-while BVH traversal over the lane-packed tables, one CUDA thread per
// ray, in the Aila-Laine while-while schedule with the reference's leaf
// queue.
//
// Replaces: ntrace_tpu/trace/packet_ww.py:_make_kernel, registry name
// tesla_persistent_while_while. It computes the same function, not the same
// schedule. The TPU kernel runs one shared SMEM stack and leaf queue per
// packet of rows x 128 rays, branch-free, with dump-slot writes and
// interleaved packets; none of that carries over to a GPU thread, which
// branches and gathers freely. What is kept is what the schedule is: the
// phase split. Per ray:
//   node loop: fetch a node record and slab-test both children (no
//              triangle work). A hit leaf child becomes a queue entry
//              first_row * 32 + rows - 1 (packet_ww.py:96-97), child 0
//              first; the nearer hit internal child is descended and the
//              farther pushed; with no internal child hit the ray pops.
//              The loop pauses when the queue holds QCAP - 2 entries
//              (QCAP 32: a step pushes at most two) or the ray is done.
//   leaf loop: Moller-Trumbore on one row per step (no slab work), from
//              the entry on top of the queue, until the queue is empty.
//              An any-hit ray stops at the first row that accepts a hit.
// The ray alternates the two loops until it is done. Choices made:
//   - per-ray queues and stacks, no warp voting: the loops are the
//     per-thread while-while of Aila and Laine (HPG 2009, section 3);
//   - near-first by the entry distances of the slab test (as
//     packet_trace.cu), not the pack-time order code the TPU kernel reads
//     because its packets share one stack;
//   - the stack (128 node indices) clamps on overflow as packet_trace.cu,
//     MAX_STEPS counts node and row steps alike;
//   - the running hit distance shrinks only in the leaf loop, up to a
//     queue's worth of leaves late, so the node loop tests more boxes than
//     the packet kernel; the result does not depend on it (trace_common.cuh
//     numerics), so closest hits are bit-equal to packet_trace.cu's.
// A leaf that spans more than 32 rows cannot be queued; the wrapper
// (trace/packet_ww.py) refuses such tables.
//
// What bounds it on an H100: as packet_trace.cu, the latency of dependent
// node and row fetches from L2 and divergence within a warp; the stack
// (512 bytes) and the queue (128 bytes) live in local memory (the ptxas
// report in chip_smoke.py's phase 2 says how much). A persistent,
// dynamically fetching version is later speed work.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

constexpr int kQcap = 32;   // packet_ww.py QCAP

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

    const Ray ray = load_ray(orig, dirn, tmin, r);
    Hit hit{tmax[r], -1, 0.0f, 0.0f};

    int stack[kStackDepth];
    int queue[kQcap];
    int sp = 0, qn = 0;
    // A dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    int item = hit.t > ray.tn ? 0 : kDone;
    long long steps = 0;

    while (item != kDone) {
        // Node loop: slab tests only.
        while (item != kDone && qn < kQcap - 2) {
            if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
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
            if (h0 && l0) queue[qn++] = run_entry(enc0, cnt0);
            if (h1 && l1) queue[qn++] = run_entry(enc1, cnt1);
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
        while (qn > 0) {
            if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
            ++steps;
            const int entry = queue[qn - 1];
            test_row(tris, entry >> 5, tpr, ray, hit);
            if (entry & 31) {
                queue[qn - 1] = entry + 31;   // next row, one fewer left
            } else {
                --qn;
            }
            if (kAnyHit && hit.id >= 0) { item = kDone; qn = 0; }
        }
    }
    store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_ww, packet_ww_kernel)
