// 8-wide frustum packet traversal over the octant-addressed wide BVH: one
// warp is one packet of 32 rays that shares one traversal (Aila and
// Laine's packet kernel, HPG 2009, on Hopper).
//
// Replaces: ntrace_tpu/trace/packet_wide.py:_make_kernel (registry name
// tesla_persistent_packet). The TPU kernel runs a packet of rows x 128 rays
// per program, builds per-packet pattern tiles from 14 vector reduces, and
// gets the 8 child verdicts of a node row back through one weighted
// sum-reduce; interleaved packets run phase-locked. Here:
//   - a warp is a packet. Its origin and direction extents, direction
//     sums, least tmin and largest running hit t come from __shfl_xor_sync
//     butterflies in a fixed order (lane ^ 16, ^ 8, ^ 4, ^ 2, ^ 1), over
//     the lanes whose ray exists (lanes past n_rays take no part; dead rays
//     do, as in the reference);
//   - the frustum (packet_wide.py:122-175): four corner planes around the
//     dominant axis, biased by the origin box, and the reciprocal extents
//     of that axis, computed once per packet by every lane alike. A plane
//     whose components are not finite passes every child (the reference's
//     turn NaN and cull every child);
//   - the packet's stack (128 items) and leaf queue (48 runs) live in
//     shared memory; lane 0 writes them, __syncwarp orders the reads;
//   - node step: lanes 0-7 each read one child slot of the 512-byte node
//     row (two float4 loads). exact=false: each of them tests its child
//     against the planes and the t-interval along the dominant axis
//     (packet_wide.py:199-233), and one __ballot_sync returns the 8
//     verdicts. exact=true: every lane slab-tests its ray against all 8
//     children (bounds broadcast by __shfl_sync) and __any_sync ORs each.
//     Children go in slot ^ octant order: the first hit internal child is
//     descended, the other hit internal children pushed far first, hit
//     leaves queued (packet_wide.py:236-278);
//   - leaf step: every live lane runs Moller-Trumbore on the queued row,
//     the (t, id) fold of trace_common.cuh; in any-hit mode __all_sync
//     ends the packet once every live ray has a hit;
//   - the largest running hit t is refreshed once per node/leaf phase
//     alternation; the node loop pauses at QCAP - 8 queued runs.
// The result per ray is exact (leaf tests are; culling is conservative),
// so closest hits are bit-equal to packet_trace.cu's.
//
// What bounds it on an H100: on coherent packets, the operations of the
// leaf tests (every live lane tests every row the packet queues) and the
// dependent node-row fetches from L2; on a degenerate packet (no axis on
// which all 32 directions share a sign) the frustum passes every child and
// the packet walks the whole tree and tests every triangle row. The design
// keeps the node test off the per-ray path (8 lanes, one ballot) and reads
// each node row once per packet, not once per ray; it does not reorder
// rays into coherent packets (the renderer's sort decides) and keeps one
// warp per packet without persistence: later speed work.

#include <math_constants.h>

#include "trace_common.cuh"

namespace {

using namespace ntrace;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarps = kBlock / kWarp;     // packets per block
constexpr int kQcapW = 48;                  // packet_wide.py QCAP
constexpr int kNodePause = kQcapW - 8;      // a node step queues <= 8 runs
constexpr float kTmaxCap = 1.0e36f;         // packet_wide.py TMAX_CAP
constexpr float kBig = 3.0e38f;             // packet_common.py INF
constexpr int kMaxOuter = 1 << 20;          // packet_wide.py MAX_OUTER

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
        v = fminf(v, __shfl_xor_sync(kFull, v, m));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, m));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(kFull, v, m);
    return v;
}

struct Frustum {
    float n[4][3];       // plane normals
    float beta[4];       // origin-box bias of each plane
    float babs[4];       // the sum of |terms| of beta (the plane slack)
    bool pass[4];        // a plane with a non-finite component culls nothing
    float iAl, iAh, oAl, oAh, tn_lo;
    int axis;            // dominant axis A
    bool degen;          // no sign-consistent axis: the planes pass all
    int signs;           // octant of the direction sums
};

__device__ __forceinline__ float pick3(const float* v, int a) {
    return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
}

// packet_wide.py:122-175, every lane alike.
__device__ Frustum make_frustum(const Ray& ray, bool present) {
    const float o[3] = {ray.ox, ray.oy, ray.oz};
    const float d[3] = {ray.dx, ray.dy, ray.dz};
    float olo[3], ohi[3], dlo[3], dhi[3], dsum[3], sc[3];
    for (int a = 0; a < 3; ++a) {
        olo[a] = warp_min(present ? o[a] : CUDART_INF_F);
        ohi[a] = warp_max(present ? o[a] : -CUDART_INF_F);
        dlo[a] = warp_min(present ? d[a] : CUDART_INF_F);
        dhi[a] = warp_max(present ? d[a] : -CUDART_INF_F);
        dsum[a] = warp_sum(present ? d[a] : 0.0f);
        sc[a] = dlo[a] * dhi[a] > 0.0f
                    ? fminf(fabsf(dlo[a]), fabsf(dhi[a])) : -1.0f;
    }
    Frustum f;
    f.signs = (dsum[0] >= 0.0f ? 1 : 0) | (dsum[1] >= 0.0f ? 2 : 0)
              | (dsum[2] >= 0.0f ? 4 : 0);
    const int A = sc[0] >= fmaxf(sc[1], sc[2]) ? 0 : (sc[1] >= sc[2] ? 1 : 2);
    f.axis = A;
    f.degen = fmaxf(sc[0], fmaxf(sc[1], sc[2])) < 0.0f;
    const float dAl = pick3(dlo, A), dAh = pick3(dhi, A);
    const float sg = dAl > 0.0f ? 1.0f : -1.0f;
    for (int bi = 0; bi < 2; ++bi) {
        const int b = A == 0 ? bi + 1 : (A == 1 ? bi * 2 : bi);
        const float dbl = pick3(dlo, b), dbh = pick3(dhi, b);
        const float c0 = dbl / dAl, c1 = dbl / dAh, c2 = dbh / dAl,
                    c3 = dbh / dAh;
        const float u_lo = fminf(fminf(c0, c1), fminf(c2, c3));
        const float u_hi = fmaxf(fmaxf(c0, c1), fmaxf(c2, c3));
        // n = sg * (e_b - u_lo e_A) and sg * (u_hi e_A - e_b)
        const float on_a[2] = {sg * (0.0f - u_lo), sg * u_hi};
        const float on_b[2] = {sg, -sg};
        for (int h = 0; h < 2; ++h) {
            const int p = 2 * bi + h;
            bool finite = true;
            for (int a = 0; a < 3; ++a) {
                const float v = a == A ? on_a[h] : (a == b ? on_b[h] : 0.0f);
                f.n[p][a] = v;
                finite = finite && isfinite(v);
            }
            f.pass[p] = !finite;
            float bb[3];
            for (int a = 0; a < 3; ++a)
                bb[a] = f.n[p][a] > 0.0f ? f.n[p][a] * olo[a]
                                         : f.n[p][a] * ohi[a];
            f.beta[p] = (bb[0] + bb[1]) + bb[2];
            f.babs[p] = (fabsf(bb[0]) + fabsf(bb[1])) + fabsf(bb[2]);
        }
    }
    f.iAl = 1.0f / (f.degen ? 1.0f : dAh);
    f.iAh = 1.0f / (f.degen ? 1.0f : dAl);
    f.oAl = pick3(olo, A);
    f.oAh = pick3(ohi, A);
    f.tn_lo = warp_min(present ? ray.tn : CUDART_INF_F);
    return f;
}

// The conservative node test of one child slot (packet_wide.py:199-233):
// lo/hi are the slot's bounds by axis.
__device__ __forceinline__ bool frustum_hit(const Frustum& f,
                                            const float* lo,
                                            const float* hi, float ptmax) {
    bool inside = true;
    if (!f.degen) {
        for (int p = 0; p < 4; ++p) {
            float x[3];
            for (int a = 0; a < 3; ++a)
                x[a] = f.n[p][a] * (f.n[p][a] > 0.0f ? hi[a] : lo[a]);
            const float d2 = (x[0] + x[1]) + x[2];
            // The slab test's slack on the plane side too, relative to
            // the magnitude of the sums: a plane through a packet's
            // outermost ray rounds it, and a hit on a box edge, outside.
            const float sx = (fabsf(x[0]) + fabsf(x[1])) + fabsf(x[2]);
            inside = inside && (f.pass[p] || d2 - f.beta[p]
                                >= -(kSlabEps * (sx + f.babs[p])));
        }
    }
    float ent = -kBig, ext = kBig;
    if (!f.degen) {
        float tn[2], tx[2];
        const float v[2] = {pick3(lo, f.axis), pick3(hi, f.axis)};
        for (int j = 0; j < 2; ++j) {
            const float dl = v[j] - f.oAl, dh = v[j] - f.oAh;
            const float a = dl * f.iAl, b = dl * f.iAh, c = dh * f.iAl,
                        e = dh * f.iAh;
            tn[j] = fminf(fminf(a, b), fminf(c, e));
            tx[j] = fmaxf(fmaxf(a, b), fmaxf(c, e));
        }
        ent = fmaxf(fminf(tn[0], tn[1]), -kBig);
        ext = fminf(fmaxf(tx[0], tx[1]), kBig);
    }
    // The interval test takes the slab test's slack (trace_common.cuh:slab
    // says why): a box flat on the dominant axis cracks a shared edge
    // otherwise.
    return inside
           && fmaxf(ent, f.tn_lo) * kSlabLo <= fminf(ext, ptmax) * kSlabHi;
}

template <bool kAnyHit, bool kExact>
__global__ void __launch_bounds__(kBlock) packet_wide_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int n_nodes, int n_tri_rows, int tpr,
    int* __restrict__ out_tri, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ int s_stack[kWarps][kStackDepth];
    __shared__ int s_queue[kWarps][kQcapW];
    const int lane = threadIdx.x & (kWarp - 1);
    const int w = threadIdx.x / kWarp;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r - lane >= n_rays) return;           // the whole warp is past the end
    const bool present = r < n_rays;
    int* stack = s_stack[w];
    int* queue = s_queue[w];

    Ray ray{};
    float t0 = 0.0f;
    if (present) {
        ray = load_ray(orig, dirn, tmin, r);
        const float tx = tmax[r];
        t0 = tx > kTmaxCap ? kTmaxCap : tx;   // jnp.minimum: NaN stays NaN
    }
    Hit hit{t0, -1, 0.0f, 0.0f};
    const bool live = present && t0 > ray.tn;
    const bool dead = present && !live;
    // A packet without a live ray can accept nothing: no walk.
    if (__any_sync(kFull, live)) {
        const Frustum f = make_frustum(ray, present);
        int item = 0, sp = 0, qn = 0;
        long long steps = 0;
        for (int outer = 0; item != kDone && outer < kMaxOuter; ++outer) {
            const float ptmax = warp_max(present ? hit.t : -CUDART_INF_F);
            // Node loop.
            while (item != kDone && qn < kNodePause) {
                if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
                ++steps;
                const float* row = nodes + static_cast<size_t>(
                    min(max(item, 0), n_nodes - 1)) * kRowLanes;
                const int k = lane & 7;
                const float4 q0 = __ldg(reinterpret_cast<const float4*>(
                    row + 16 * k));
                const float4 q1 = __ldg(reinterpret_cast<const float4*>(
                    row + 16 * k + 4));
                const float lo[3] = {q0.x, q0.z, q1.x};
                const float hi[3] = {q0.y, q0.w, q1.y};
                const int my_item = static_cast<int>(q1.z);
                unsigned mask = 0;
                if (kExact) {
                    const float live_t = kAnyHit && dead ? -kBig : hit.t;
#pragma unroll
                    for (int c = 0; c < 8; ++c) {
                        float b[6];
                        for (int a = 0; a < 3; ++a) {
                            b[2 * a] = __shfl_sync(kFull, lo[a], c);
                            b[2 * a + 1] = __shfl_sync(kFull, hi[a], c);
                        }
                        float begin;
                        const bool h = present && slab(b, ray, live_t, &begin);
                        if (__any_sync(kFull, h)) mask |= 1u << c;
                    }
                } else {
                    const bool h = lane < 8 && frustum_hit(f, lo, hi, ptmax);
                    mask = __ballot_sync(kFull, h) & 0xffu;
                }
                // Slot ^ octant order: descend the first hit internal
                // child, push the others far first, queue the leaves.
                int items[8];
                bool hits[8];
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    const int slot = kk ^ f.signs;
                    hits[kk] = (mask >> slot) & 1u;
                    items[kk] = __shfl_sync(kFull, my_item, slot);
                }
                int desc = kDone, first = -1;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    if (first < 0 && hits[kk] && items[kk] >= 0) {
                        desc = items[kk];
                        first = kk;
                    }
                }
                int np = 0, nq = 0;
#pragma unroll
                for (int kk = 7; kk >= 0; --kk) {
                    if (hits[kk] && items[kk] >= 0 && kk != first) {
                        if (lane == 0)
                            stack[min(sp + np, kStackDepth - 1)] = items[kk];
                        ++np;
                    }
                    if (hits[kk] && items[kk] < 0) {
                        if (lane == 0)
                            queue[min(qn + nq, kQcapW - 1)] = -items[kk] - 1;
                        ++nq;
                    }
                }
                __syncwarp();
                const int sp1 = min(sp + np, kStackDepth);
                qn += nq;
                if (desc != kDone) {
                    item = desc;
                    sp = sp1;
                } else if (sp1 > 0) {
                    item = stack[sp1 - 1];
                    sp = sp1 - 1;
                } else {
                    item = kDone;
                    sp = sp1;
                }
                __syncwarp();
            }
            // Leaf loop: one queued row per step, from the top run.
            while (qn > 0) {
                if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
                ++steps;
                const int entry = queue[qn - 1];
                const int trow = min(entry >> 5, n_tri_rows - 1);
                if (live) test_row(tris, trow, tpr, ray, hit);
                __syncwarp();
                if (entry & 31) {
                    if (lane == 0) queue[qn - 1] = entry + 31;
                } else {
                    --qn;
                }
                __syncwarp();
                if (kAnyHit && __all_sync(kFull, !live || hit.id >= 0)) {
                    item = kDone;
                    qn = 0;
                }
            }
        }
    }
    if (present) store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

template <bool kAnyHit>
void launch(bool exact, dim3 grid, cudaStream_t s, const float* n,
            const float* t12, const float* o, const float* d,
            const float* tn, const float* tx, int n_rays, int n_nodes,
            int n_tri_rows, int tpr, int* tri, float* t, float* u,
            float* v) {
    if (exact) {
        packet_wide_kernel<kAnyHit, true><<<grid, kBlock, 0, s>>>(
            n, t12, o, d, tn, tx, n_rays, n_nodes, n_tri_rows, tpr, tri, t,
            u, v);
    } else {
        packet_wide_kernel<kAnyHit, false><<<grid, kBlock, 0, s>>>(
            n, t12, o, d, tn, tx, n_rays, n_nodes, n_tri_rows, tpr, tri, t,
            u, v);
    }
}

}  // namespace

// Launches the wide packet kernel on `stream` and returns cudaGetLastError()
// after the launch (0 = cudaSuccess). It does not synchronise and allocates
// nothing.
extern "C" int ntrace_packet_wide(const void* nodes_w, const void* tris,
                                  const void* orig, const void* dirn,
                                  const void* tmin, const void* tmax,
                                  int n_rays, int n_nodes, int n_tri_rows,
                                  int tris_per_row, int any_hit, int exact,
                                  void* out_tri, void* out_t, void* out_u,
                                  void* out_v, void* stream) {
    if (n_rays <= 0) return static_cast<int>(cudaSuccess);
    const dim3 grid((n_rays + kBlock - 1) / kBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto fn) {
        fn(exact != 0, grid, s, static_cast<const float*>(nodes_w),
           static_cast<const float*>(tris), static_cast<const float*>(orig),
           static_cast<const float*>(dirn), static_cast<const float*>(tmin),
           static_cast<const float*>(tmax), n_rays, n_nodes, n_tri_rows,
           tris_per_row, static_cast<int*>(out_tri),
           static_cast<float*>(out_t), static_cast<float*>(out_u),
           static_cast<float*>(out_v));
    };
    if (any_hit) {
        args(launch<true>);
    } else {
        args(launch<false>);
    }
    return static_cast<int>(cudaGetLastError());
}
