// Speculative while-while BVH traversal over the lane-packed tables, one
// CUDA thread per ray, each warp of 32 consecutive rays switching phases
// by vote.
//
// Replaces: ntrace_tpu/trace/packet_ifif.py:_make_kernel, registry name
// tesla_persistent_speculative_while_while. It computes the same function,
// not the same schedule. The TPU kernel is branch-free: every step of a
// packet does a node phase AND a leaf phase on one shared stack and
// select-masks the idle one, because a TPU core cannot branch per lane. A
// GPU warp can, so this is the CUDA schedule the registry name stands for,
// Aila and Laine's speculative while-while (HPG 2009, section 3):
//   - work items in the reference's mixed encoding (packet_ifif.py:18-23):
//     item >= 0 is a node, item < 0 a leaf run v = -item - 1 (first row
//     v >> 5, v & 31 more rows); finished is INT_MIN here, not the TPU
//     kernel's 0x40000000, so every non-negative item is a node;
//   - node phase: each lane with a node item visits it (slab tests only):
//     hit children become items, the nearer is next and the farther is
//     pushed (leaf runs go on the stack like nodes), a miss pops. A lane
//     whose next item is a leaf postpones it into its one leaf slot if the
//     slot is empty and pops on: it keeps walking speculatively. The warp
//     stays in the node phase while __any_sync finds a lane still
//     searching for its first leaf (a node item and an empty slot);
//   - leaf phase: each lane holding a postponed run tests its rows
//     (Moller-Trumbore only); if its current item is a leaf run too, that
//     run takes the slot and the lane pops on, as Aila and Laine's
//     "another leaf was postponed" loop. The warp stays in the leaf phase
//     while __any_sync finds a lane holding a run;
//   - the warp loops until __all lanes are done. Every lane of the warp
//     stays in the loop (lanes past the last ray are done from the start),
//     so each vote is over the full mask and the order of leaves is a
//     function of the 32 rays alone: trace/packet_ifif.py's twin models the
//     warps and is bit-equal on any-hit triangles too.
// The Hopper design, against the first port of PR 4:
//   - any hit: a run stops at its first row that accepts a hit, and the
//     lane is done (it tested the whole run before); the votes are as
//     they were;
//   - closest hit: each stack entry, and the item in hand, keeps the slab
//     entry distance of its box, and an item whose box the slab test
//     would now fail is dropped (trace_common.cuh:culled): on every pop,
//     and after a leaf phase for the item the lane held through it, a
//     node or the next leaf, found under an older hit distance. Any-hit
//     entries carry no distance (their hit distance does not shrink before
//     they stop), so their stack stays 512 bytes; closest-hit entries are
//     8 bytes, 1 KB;
//   - triangle rows load as float4 pairs of slots (trace_common.cuh:
//     test_row_vec).
// Choices shared with packet_ww.cu: near-first by slab entry distance, the
// clamped 128-entry stack, MAX_STEPS over node and leaf steps, the 32-row
// limit of a leaf run (refused by the wrapper). Closest hits are bit-equal
// to packet_trace.cu's (trace_common.cuh numerics).
//
// What bounds it on an H100: as packet_trace.cu, dependent L2 fetches and
// divergence; the speculation trades extra node visits (a lane walks past
// its first leaf) for warps that run one kind of work at a time. The stack
// lives in local memory.

#include "trace_common.cuh"

namespace {

using namespace ntrace;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNoLeaf = 0;   // the leaf slot is empty (a leaf item is < 0)

// Closest hits drop items whose box the ray has left (see the head).
template <bool kAnyHit>
constexpr bool kCullOnPop = !kAnyHit;

// A work item, with the entry distance of its box where items are culled.
template <bool kCull>
struct alignas(8) Entry { int item; float b; };
template <>
struct Entry<false> { int item; };

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) packet_ifif_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    constexpr bool kCull = kCullOnPop<kAnyHit>;
    using E = Entry<kCull>;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_range = r < n_rays;   // no early return: lanes must vote

    Ray ray{};
    Hit hit{0.0f, -1, 0.0f, 0.0f};
    E cur{};
    cur.item = kDone;
    int leaf = kNoLeaf;
    if (in_range) {
        ray = load_ray(orig, dirn, tmin, r);
        hit.t = tmax[r];
        // A dead ray (tmax <= tmin, or NaN) can accept no hit.
        cur.item = hit.t > ray.tn ? 0 : kDone;
    }
    E stack[kStackDepth];
    int sp = 0;
    long long steps = 0;
    bool node_phase = true;

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
    // Child `c` of a node record as a work item (its box entered at `b`).
    auto child = [&](const float* rec, int c, float b) {
        E e{};
        const int enc = static_cast<int>(rec[12 + c]);
        e.item = enc < 0 ? -run_entry(enc, static_cast<int>(rec[14 + c])) - 1
                         : enc;
        if constexpr (kCull) e.b = b;
        return e;
    };

    while (__any_sync(kFullMask, cur.item != kDone || leaf < 0)) {
        if (node_phase) {
            if (cur.item >= 0) {
                if (steps == kMaxSteps) {
                    cur.item = kDone;
                    leaf = kNoLeaf;
                } else {
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
                    // First leaf: postpone it and walk on.
                    if (cur.item < 0 && cur.item != kDone && leaf >= 0) {
                        leaf = cur.item;
                        cur = pop();
                    }
                }
            }
            if (!__any_sync(kFullMask, cur.item >= 0 && leaf >= 0)) {
                node_phase = false;
            }
        } else {
            if (leaf < 0) {
                if (steps == kMaxSteps) {
                    cur.item = kDone;
                    leaf = kNoLeaf;
                } else {
                    ++steps;
                    const int v = -leaf - 1;
                    const int row0 = v >> 5, rows = (v & 31) + 1;
                    for (int k = 0; k < rows; ++k) {
                        test_row_vec(tris, row0 + k, tpr, ray, hit);
                        if (kAnyHit && hit.id >= 0) break;
                    }
                    if (kAnyHit && hit.id >= 0) {
                        cur.item = kDone;
                        leaf = kNoLeaf;
                    } else {
                        // The item held through the leaf phase was found
                        // under an older hit distance.
                        if constexpr (kCull) {
                            if (cur.item != kDone && culled(cur.b, hit.t)) {
                                cur = pop();
                            }
                        }
                        if (cur.item < 0 && cur.item != kDone) {
                            // Another leaf was postponed: it is next.
                            leaf = cur.item;
                            cur = pop();
                        } else {
                            leaf = kNoLeaf;
                        }
                    }
                }
            }
            if (!__any_sync(kFullMask, leaf < 0)) node_phase = true;
        }
    }
    if (in_range) store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

}  // namespace

NTRACE_TRAVERSAL_ENTRY(ntrace_packet_ifif, packet_ifif_kernel)
