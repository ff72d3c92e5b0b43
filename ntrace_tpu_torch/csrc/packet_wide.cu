// 8-wide packet traversal over the octant-addressed wide BVH: one warp is
// one packet of 32 rays that shares one traversal (Aila and Laine's packet
// kernel, HPG 2009, on Hopper).
//
// Replaces: ntrace_tpu/trace/packet_wide.py:_make_kernel (registry name
// tesla_persistent_packet). The TPU kernel runs a packet of rows x 128 rays
// per program, builds per-packet pattern tiles from 14 vector reduces, and
// gets the 8 child verdicts of a node row back through one weighted
// sum-reduce, because per-lane slab work and per-child reduces are dear
// there. On Hopper a thread's own slab test is cheap, so here:
//   - warp w of block b traces packet 4b + w (rays 32 (4b + w) ..+32);
//   - packet reductions: origin and direction extents, direction sums, the
//     least tmin and the largest running hit t (`ptmax`) come from
//     __shfl_xor_sync butterflies in a fixed order (lane ^ 16, ^ 8, ^ 4,
//     ^ 2, ^ 1) over the lanes whose ray exists (dead rays take part, as
//     in the reference);
//   - the frustum (packet_wide.py:122-175): four corner planes around the
//     dominant axis, biased by the origin box, and the reciprocal extents
//     of that axis, once per packet by every lane alike, then kept in the
//     warp's shared memory (it is the same in every lane; in registers it
//     cost the exact=false kernels about 30 registers a thread). A plane
//     whose components are not finite passes every child;
//   - node step: the 16 lanes with (lane & 3) < 2 load the 256 useful bytes
//     of the 512-byte node row (slot k's bounds and item are float4 4k and
//     4k + 1) in one request into the warp's node buffer in shared memory
//     (two buffers by step parity, so one __syncwarp a step orders them).
//     exact=false: lanes 0-7 test their child against the frustum planes
//     and the t-interval along the dominant axis (packet_wide.py:199-233),
//     and one __ballot_sync gives the 8-bit frustum mask. Then, for the
//     children in that mask (all 8 when exact=true), every lane slab-tests
//     its own ray (bounds as broadcast 16-byte loads from shared memory)
//     against its running hit t (-big for a dead ray in any-hit mode), and
//     one __reduce_or_sync folds the lanes' masks: a child is visited when
//     the frustum and at least one ray admit it (exact=true: when one ray
//     does);
//   - routing in parallel: lane kk of 0-7 owns visit position kk (slot
//     kk ^ octant) and finds its stack or queue position by __popc over
//     the positions that precede it in the reference's serial order: the
//     first hit internal child is descended, the others pushed far first,
//     hit leaves queued from kk 7 down to 0 (packet_wide.py:236-278);
//   - leaf phase: the queue is known, so its rows stream through three
//     row buffers per warp in shared memory: while row i is tested, row
//     i + 1 is in flight by cp.async (16 bytes a lane, the row's first
//     ceil(10 tris_per_row / 4) chunks). Every live lane runs
//     Moller-Trumbore on the staged row, the (t, id) fold of
//     trace_common.cuh; in any-hit mode __all_sync ends the packet once
//     every live ray has a hit;
//   - the largest running hit t is refreshed once per node/leaf phase
//     alternation; the node loop pauses at QCAP - 8 queued runs.
// The result per ray is exact (leaf tests are; both culls are
// conservative), so closest hits are bit-equal to packet_trace.cu's, and
// the verdict of a step is the twin's (trace/packet_wide.py:_node_step),
// so any-hit tri is bit-equal to it too.
//
// What bounds it on an H100: on incoherent rays, the leaf tests of rays
// that share a packet but not a leaf (a packet pays for the union of its
// rays' leaves, every live lane testing every queued row); on coherent
// rays, the chain of dependent node-row fetches. The design culls each
// child by the rays themselves (the frustum alone culls nothing on a
// packet with no sign-consistent axis) and keeps the rows a leaf phase
// needs in flight. Persistent warps (each taking the next packet from a
// global counter; the reference's name) were built and timed against
// this one-warp-a-packet launch: faster on AO and diffuse batches, slower
// on primary and shadow ones, so the launch stays one warp a packet
// (chip_smoke.py phase 11 times both). Left for later: forming coherent
// packets (the renderer's ray sort decides them) and spreading a leaf's
// (ray, triangle) pairs over the lanes whose rays want it.

#include <math_constants.h>

#include "trace_common.cuh"

namespace {

using namespace ntrace;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarps = kBlock / kWarp;     // warps per block
constexpr int kQcapW = 48;                  // packet_wide.py QCAP
constexpr int kNodePause = kQcapW - 8;      // a node step queues <= 8 runs
constexpr float kTmaxCap = 1.0e36f;         // packet_wide.py TMAX_CAP
constexpr float kBig = 3.0e38f;             // packet_common.py INF
constexpr int kMaxOuter = 1 << 20;          // packet_wide.py MAX_OUTER
constexpr int kRowBufs = 3;                 // tested, in flight, free

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

// One warp's shared memory. Slot k of a node row is node[par][2k] =
// (lo.x, hi.x, lo.y, hi.y), node[par][2k + 1] = (lo.z, hi.z, item, -). The
// frustum is the same in every lane, so it lives here, not in registers.
struct WarpSmem {
    float4 node[2][16];
    float4 rows[kRowBufs][kRowLanes / 4];
    int stack[kStackDepth];
    int queue[kQcapW];
    Frustum frustum;
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

// The conservative packet test of one child slot (packet_wide.py:199-233):
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

// One packet: rays [32 * pk, 32 * pk + 32) of the batch.
template <bool kAnyHit, bool kExact>
__device__ __forceinline__ void trace_one_packet(
    WarpSmem& sm, int lane, int pk, const float* __restrict__ nodes,
    const float* __restrict__ tris, const float* __restrict__ orig,
    const float* __restrict__ dirn, const float* __restrict__ tmin,
    const float* __restrict__ tmax, int n_rays, int n_nodes, int n_tri_rows,
    int tpr, int* __restrict__ out_tri, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    const int r = pk * kWarp + lane;
    const bool present = r < n_rays;
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
        int signs;
        {
            const Frustum f = make_frustum(ray, present);
            signs = f.signs;
            // Read after the first node step's __syncwarp.
            if (lane == 0) sm.frustum = f;
        }
        const int chunks = (kTriLanes * tpr + 3) / 4;
        const int kk = lane & 7;            // lanes 0-7: visit position kk
        const int slot = kk ^ signs;
        const unsigned below = (1u << kk) - 1u;
        int item = 0, sp = 0, qn = 0, par = 0;
        long long steps = 0;
        for (int outer = 0; item != kDone && outer < kMaxOuter; ++outer) {
            const float ptmax =
                kExact ? 0.0f : warp_max(present ? hit.t : -CUDART_INF_F);
            // Node loop.
            while (item != kDone && qn < kNodePause) {
                if (steps == kMaxSteps) { item = kDone; qn = 0; break; }
                ++steps;
                float4* nb = sm.node[par];
                par ^= 1;
                if ((lane & 3) < 2) {
                    const float4* row = reinterpret_cast<const float4*>(
                        nodes + static_cast<size_t>(
                            min(max(item, 0), n_nodes - 1)) * kRowLanes);
                    nb[2 * (lane >> 2) + (lane & 3)] =
                        __ldg(row + 4 * (lane >> 2) + (lane & 3));
                }
                __syncwarp();
                unsigned cand = 0xffu;
                if (!kExact) {
                    bool h = false;
                    if (lane < 8) {
                        const float4 a = nb[2 * lane], b = nb[2 * lane + 1];
                        const float lo[3] = {a.x, a.z, b.x};
                        const float hi[3] = {a.y, a.w, b.y};
                        h = frustum_hit(sm.frustum, lo, hi, ptmax);
                    }
                    cand = __ballot_sync(kFull, h) & 0xffu;
                }
                // The per-ray vote on the children the frustum admits.
                const float live_t = kAnyHit && dead ? -kBig : hit.t;
                unsigned mine = 0;
                for (unsigned m = cand; m != 0; m &= m - 1) {
                    const int c = __ffs(m) - 1;
                    const float4 a = nb[2 * c], b = nb[2 * c + 1];
                    const float bx[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
                    float begin;
                    if (present && slab(bx, ray, live_t, &begin))
                        mine |= 1u << c;
                }
                const unsigned mask = __reduce_or_sync(kFull, mine);
                // Routing: lane kk < 8 places the child at visit position
                // kk where the serial order of the reference would.
                const int it = static_cast<int>(nb[2 * slot + 1].z);
                const bool hs = lane < 8 && ((mask >> slot) & 1u);
                const unsigned inner = __ballot_sync(kFull, hs && it >= 0);
                const unsigned leaves = __ballot_sync(kFull, hs && it < 0);
                const int first = inner ? __ffs(inner) - 1 : 0;
                const int desc = __shfl_sync(kFull, it, first);
                const unsigned push = inner & (inner - 1u);
                if (lane < 8 && ((push >> kk) & 1u)) {
                    // Far first: positions kk+1..7 were pushed before; a
                    // full stack keeps the last push in its top entry.
                    const int pos = sp + __popc(push >> (kk + 1));
                    if (pos < kStackDepth - 1 || (push & below) == 0)
                        sm.stack[min(pos, kStackDepth - 1)] = it;
                }
                if (lane < 8 && ((leaves >> kk) & 1u)) {
                    const int pos = qn + __popc(leaves >> (kk + 1));
                    if (pos < kQcapW - 1 || (leaves & below) == 0)
                        sm.queue[min(pos, kQcapW - 1)] = -it - 1;
                }
                const int sp1 = min(sp + __popc(push), kStackDepth);
                qn += __popc(leaves);
                if (inner) {
                    item = desc;
                    sp = sp1;
                } else if (sp1 > 0) {
                    // Nothing was pushed this step: the top entry was
                    // written before this step's __syncwarp.
                    item = sm.stack[sp1 - 1];
                    sp = sp1 - 1;
                } else {
                    item = kDone;
                    sp = sp1;
                }
            }
            // Leaf phase: the queued rows, top run first, each run's rows
            // in order; row i + 1 in flight while row i is tested.
            __syncwarp();   // the node steps' queue entries
            if (qn > 0) {
                int q = qn - 1, entry = sm.queue[q];
                fetch_row(sm.rows[0], tris, min(entry >> 5, n_tri_rows - 1),
                          chunks, lane);
                for (int i = 0;; ++i) {
                    if (steps == kMaxSteps) { item = kDone; break; }
                    ++steps;
                    int nq = q, next = entry;
                    if (next & 31) {
                        next += 31;             // the run's next row
                    } else if (--nq >= 0) {
                        next = sm.queue[nq];
                    }
                    const bool more = nq >= 0;
                    if (more) {
                        // Buffer (i + 1) % 3 was last read in step i - 2,
                        // before step i - 1's __syncwarp.
                        fetch_row(sm.rows[(i + 1) % kRowBufs], tris,
                                  min(next >> 5, n_tri_rows - 1), chunks,
                                  lane);
                        wait_async<1>();
                    } else {
                        wait_async<0>();
                    }
                    __syncwarp();   // every lane's chunks of row i landed
                    if (live) {
                        test_row_shared(reinterpret_cast<const float*>(
                                            sm.rows[i % kRowBufs]),
                                        tpr, ray, hit);
                    }
                    if (kAnyHit && __all_sync(kFull, !live || hit.id >= 0)) {
                        item = kDone;
                        break;
                    }
                    if (!more) break;
                    q = nq;
                    entry = next;
                }
                wait_async<0>();    // nothing in flight past the phase
                qn = 0;
            }
        }
    }
    if (present) store_hit(hit, r, out_tri, out_t, out_u, out_v);
}

template <bool kAnyHit, bool kExact>
__global__ void __launch_bounds__(kBlock) packet_wide_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int n_nodes, int n_tri_rows, int tpr,
    int* __restrict__ out_tri, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ WarpSmem s_warp[kWarps];
    const int lane = threadIdx.x & (kWarp - 1);
    const int w = threadIdx.x / kWarp;
    const int pk = blockIdx.x * kWarps + w;
    if (pk * kWarp >= n_rays) return;   // the whole warp is past the end
    trace_one_packet<kAnyHit, kExact>(
        s_warp[w], lane, pk, nodes, tris, orig, dirn, tmin, tmax, n_rays,
        n_nodes, n_tri_rows, tpr, out_tri, out_t, out_u, out_v);
}

template <bool kAnyHit, bool kExact>
void launch(int n_rays, cudaStream_t s, const float* n, const float* t12,
            const float* o, const float* d, const float* tn, const float* tx,
            int n_nodes, int n_tri_rows, int tpr, int* tri, float* t,
            float* u, float* v) {
    auto kernel = packet_wide_kernel<kAnyHit, kExact>;
    const int grid = (n_rays + kBlock - 1) / kBlock;
    kernel<<<grid, kBlock, 0, s>>>(n, t12, o, d, tn, tx, n_rays, n_nodes,
                                   n_tri_rows, tpr, tri, t, u, v);
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
    auto args = [&](auto fn) {
        fn(n_rays, static_cast<cudaStream_t>(stream),
           static_cast<const float*>(nodes_w),
           static_cast<const float*>(tris), static_cast<const float*>(orig),
           static_cast<const float*>(dirn), static_cast<const float*>(tmin),
           static_cast<const float*>(tmax), n_nodes, n_tri_rows,
           tris_per_row, static_cast<int*>(out_tri),
           static_cast<float*>(out_t), static_cast<float*>(out_u),
           static_cast<float*>(out_v));
    };
    if (any_hit) {
        if (exact) args(launch<true, true>); else args(launch<true, false>);
    } else {
        if (exact) args(launch<false, true>); else args(launch<false, false>);
    }
    return static_cast<int>(cudaGetLastError());
}
