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
//               leaf (or is done);
//   leaf loop : Moller-Trumbore on every slot of every row the leaf spans,
//               then pop; leave when the ray pops an internal node.
// The Hopper design, against the first port of PR 1:
//   - any hit: the leaf loop stops at the first row that accepts a hit, and
//     the ray is done (it tested the whole leaf before);
//   - closest hit: each stack entry keeps the slab entry distance of its
//     box, and a pop skips every entry whose box the slab test would now
//     fail (trace_common.cuh:culled): the hit distance has often shrunk
//     below it since the push, and such a node was fetched, or such a leaf
//     tested, for nothing. Any-hit entries carry no distance: their hit
//     distance does not shrink before they stop;
//   - a stack entry keeps a leaf's code and its row count apart (8 bytes;
//     12 with the distance, a 1.5 KB stack for closest hits), so a table
//     traces whatever its longest leaf; one-word items, as packet_ifif's
//     runs, measured no faster (scripts/packet_ab.py). A leaf spans
//     max(count, 1) rows;
//   - triangle rows load as float4 pairs of slots (trace_common.cuh:
//     test_row_vec), five 16-byte loads for two slots.
// The stack clamps on overflow exactly as packet_pallas.py:359-361 clamps
// its shared stack, with MAX_STEPS (node visits and leaves) as a backstop
// against malformed trees. The closest hit does not depend on the order of
// leaves (trace_common.cuh numerics), so it is bit-equal to the first
// port's and to every other engine's; which triangle an any-hit ray holds
// follows the order and the row stop. trace/packet.py:trace_packet_ref is
// the twin, step for step.
//
// What bounds it on an H100: latency and divergence of the dependent
// node/row fetches. Each step's address comes from the previous step's
// record, and neighbouring rays of a warp part ways in the tree. The tables
// (17 MB for the conference scene) stay resident in the 50 MB L2, so the
// fetches are L2 hits, not HBM traffic. There is no matrix work and no
// fixed tile to stream, so wgmma and TMA have no place here.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

// Step 2 of the design: popped entries are culled by their entry distance.
template <bool kAnyHit>
constexpr bool kCullOnPop = !kAnyHit;

// A stack entry: the item (a node index, or a leaf's code -first_row - 1),
// a leaf's row count, and where pops cull, the entry distance of the
// item's box.
template <bool kCull>
struct Entry { int item; int cnt; float b; };
template <>
struct alignas(8) Entry<false> { int item; int cnt; };

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) packet_trace_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    constexpr bool kCull = kCullOnPop<kAnyHit>;
    using E = Entry<kCull>;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;   // no padding rays: the ragged edge is masked

    const Ray ray = load_ray(orig, dirn, tmin, r);
    Hit hit{tmax[r], -1, 0.0f, 0.0f};

    E stack[kStackDepth];
    int sp = 0;
    // The item in hand: >= 0 a node, < 0 a leaf, kDone when finished. A
    // dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    E cur{};
    cur.item = hit.t > ray.tn ? 0 : kDone;
    long long steps = 0;

    // The stack top, past every entry whose box the ray has left.
    auto pop = [&]() {
        while (sp > 0) {
            const E e = stack[--sp];
            if constexpr (kCull) {
                if (culled(e.b, hit.t)) continue;
            }
            return e;
        }
        E done{};
        done.item = kDone;
        return done;
    };
    // Child `c` of a node record as an item (with its box's entry `b`).
    auto child = [&](const float* rec, int c, float b) {
        E e{};
        e.item = static_cast<int>(rec[12 + c]);
        e.cnt = static_cast<int>(rec[14 + c]);
        if constexpr (kCull) e.b = b;
        return e;
    };

    while (cur.item != kDone) {
        while (cur.item >= 0) {
            if (steps == kMaxSteps) { cur.item = kDone; break; }
            ++steps;
            float rec[kNodeLanes];
            load_node(nodes, cur.item, npr, rec);
            float b0, b1;
            const bool h0 = slab(rec, ray, hit.t, &b0);
            const bool h1 = slab(rec + 6, ray, hit.t, &b1);
            if (h0 && h1) {
                // Near child first; a tie goes to child 0.
                const bool first0 = b0 <= b1;
                stack[min(sp, kStackDepth - 1)] =
                    first0 ? child(rec, 1, b1) : child(rec, 0, b0);
                sp = min(sp + 1, kStackDepth);
                cur = first0 ? child(rec, 0, b0) : child(rec, 1, b1);
            } else if (h0) {
                cur = child(rec, 0, b0);
            } else if (h1) {
                cur = child(rec, 1, b1);
            } else {
                cur = pop();
            }
        }
        while (cur.item < 0 && cur.item != kDone) {
            if (steps == kMaxSteps) { cur.item = kDone; break; }
            ++steps;
            const int row0 = -cur.item - 1;
            const int rows = max(cur.cnt, 1);
            for (int k = 0; k < rows; ++k) {
                test_row_vec(tris, row0 + k, tpr, ray, hit);
                if (kAnyHit && hit.id >= 0) break;
            }
            if (kAnyHit && hit.id >= 0) { cur.item = kDone; break; }
            cur = pop();
        }
    }
    store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_trace, packet_trace_kernel)
