// Device code shared by the BVH traversal kernels (packet_trace.cu,
// packet_ww.cu, packet_ifif.cu, packet_pipe.cu, packet_wide.cu,
// packet_batch.cuh): the ray and hit records, the table decode, the slab
// test, the Moller-Trumbore row test (from device or shared memory), the
// cp.async staging of rows and records into shared memory, and the
// while-while kernels' leaf queue.
//
// Numerics: the slab test follows packet_pallas.py:_slab_child (73-96)
// and the triangle test packet_pallas.py:186-201, op for op, as
// trace/packet_common.py does in torch. Build with --fmad=false:
// contracting a*b - c*d into an FMA changes the bits. Never build with
// --use_fast_math (approximate 1/x, flush-to-zero). Float lanes that
// encode integers (child links, row counts, triangle ids) convert by
// truncation, as .astype(int32) does. A row is folded into the hit by
//   t < hit_t || (t == hit_t && id < hit_id)
// so the result (lowest id among the closest hits) does not depend on the
// order in which leaves are visited: every schedule gives the same
// closest hit, bit for bit.
//
// Layout (host/bvh/packed.py): node i is the 16 floats at
//   nodes[(i / npr) * 128 + 16 * (i % npr)]
//   [c0 lo.x hi.x lo.y hi.y lo.z hi.z | c1 ... | enc0 enc1 cnt0 cnt1]
// enc < 0 is a leaf whose first triangle row is -enc - 1 and whose row
// count is cnt; triangle slot j of row r is the 10 floats at
//   tris[r * 128 + 10 * j] = [v0.xyz e1.xyz e2.xyz tri_id].

#pragma once

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace ntrace {

constexpr int kStackDepth = 128;           // packet_pallas.py STACK_DEPTH
constexpr long long kMaxSteps = 4000000;   // malformed-tree backstop, per ray
constexpr int kRowLanes = 128;
constexpr int kNodeLanes = 16;
constexpr int kTriLanes = 10;
constexpr int kDone = INT_MIN;             // no node left to visit
constexpr int kBlock = 128;

struct Ray {
    float ox, oy, oz;   // origin
    float dx, dy, dz;   // direction
    float ix, iy, iz;   // safe reciprocal direction
    float tn;           // tmin
};

struct Hit {
    float t;    // starts at tmax; the running hit distance
    int id;     // -1 until a triangle is accepted
    float u, v;
};

// ops/aabb.py safe_inv_dir: 1 / (|d| > 2^-80 ? d : copysign(2^-80, d)).
__device__ __forceinline__ float safe_inv(float d) {
    const float ooeps = __int_as_float(47 << 23);   // 2^-80
    const float g = fabsf(d) > ooeps ? d : (d >= 0.0f ? ooeps : -ooeps);
    return 1.0f / g;
}

__device__ __forceinline__ Ray load_ray(const float* orig, const float* dirn,
                                        const float* tmin, int r) {
    Ray ray;
    ray.ox = orig[3 * r];
    ray.oy = orig[3 * r + 1];
    ray.oz = orig[3 * r + 2];
    ray.dx = dirn[3 * r];
    ray.dy = dirn[3 * r + 1];
    ray.dz = dirn[3 * r + 2];
    ray.ix = safe_inv(ray.dx);
    ray.iy = safe_inv(ray.dy);
    ray.iz = safe_inv(ray.dz);
    ray.tn = tmin[r];
    return ray;
}

// The 16 floats of node `ref` (four 16-byte loads through the read-only
// path).
__device__ __forceinline__ void load_node(const float* __restrict__ nodes,
                                          int ref, int npr, float rec[16]) {
    const float4* rec4 = reinterpret_cast<const float4*>(
        nodes + static_cast<size_t>(ref / npr) * kRowLanes
        + kNodeLanes * (ref % npr));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 w = __ldg(rec4 + q);
        rec[4 * q] = w.x;
        rec[4 * q + 1] = w.y;
        rec[4 * q + 2] = w.z;
        rec[4 * q + 3] = w.w;
    }
}

// packet_pallas.py:_slab_child, made conservative. fminf/fmaxf drop NaN
// like jnp.fmin/fmax; entry is clamped to tmin, exit to the running hit
// distance, and the box passes when
//   t0 * kSlabLo <= t1 * kSlabHi,   kSlabLo/Hi = 1 -/+ 2^-20.
// Why the slack (Ize, "Robust BVH Ray Traversal", JCGT 2013): each slab
// distance (b - o) * inv carries three roundings (the subtraction, the
// reciprocal, the product), a relative error of at most gamma(3) = 3u/(1-3u),
// u = 2^-24, so an exact interval that is not empty can round to t0 > t1
// by 2 gamma(3) (Ize widens t1 by 1 + 2 gamma(3)). Moller-Trumbore rounds
// too: it accepts a point on a shared edge that lies outside its own
// triangle, and so outside that triangle's leaf box, by a few u of
// |o - v0| and of the edge lengths (its differences and edges carry that
// error), which is a few u of t relative when the hit is no nearer than
// an edge's length and the ray does not graze the triangle. A box that is
// flat in one axis (an axis-aligned quad split in two) then rounds the hit
// outside both boxes of the edge, and the tree loses the hit. The same
// few u decide ties: t1 is clamped to the running hit, whose t Moller-
// Trumbore computed, and a box whose t0 rounds just above it would lose
// the lower id at the same t. 2^-20 = 16u covers 2 gamma(3) and leaves
// about 10u for those. Both constants and the products are exact or
// correctly rounded in float, so every kernel and its torch twin
// (trace/packet_common.py:slab_child) agree bit for bit. Needs tmin >= 0
// (t0 >= 0: a box behind the origin, t1 < 0, still fails). A box that
// passes only through the slack costs one more node visit, never a hit.
constexpr float kSlabEps = 0x1p-20f;
constexpr float kSlabLo = 1.0f - kSlabEps;
constexpr float kSlabHi = 1.0f + kSlabEps;

__device__ __forceinline__ bool slab(const float* b, const Ray& r,
                                     float tmax, float* begin) {
    const float tlo_x = (b[0] - r.ox) * r.ix;
    const float thi_x = (b[1] - r.ox) * r.ix;
    const float tlo_y = (b[2] - r.oy) * r.iy;
    const float thi_y = (b[3] - r.oy) * r.iy;
    const float tlo_z = (b[4] - r.oz) * r.iz;
    const float thi_z = (b[5] - r.oz) * r.iz;
    const float t0 = fmaxf(fmaxf(fminf(tlo_x, thi_x), fminf(tlo_y, thi_y)),
                           fmaxf(fminf(tlo_z, thi_z), r.tn));
    const float t1 = fminf(fminf(fmaxf(tlo_x, thi_x), fmaxf(tlo_y, thi_y)),
                           fminf(fmaxf(tlo_z, thi_z), tmax));
    *begin = t0;
    return t0 * kSlabLo <= t1 * kSlabHi;
}

// Moller-Trumbore of the ray against one triangle slot (v0, e1, e2, id),
// a valid hit folded into `hit` by the (t, id) order.
__device__ __forceinline__ void test_slot(float v0x, float v0y, float v0z,
                                          float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z,
                                          int tid, const Ray& r, Hit& hit) {
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
    const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    const float u = (tvx * px + tvy * py + tvz * pz) * inv;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    const bool valid = det != 0.0f && tid >= 0 && u >= 0.0f && v >= 0.0f
                       && u + v <= 1.0f && t > r.tn;
    if (valid && (t < hit.t || (t == hit.t && tid < hit.id))) {
        hit.t = t;
        hit.id = tid;
        hit.u = u;
        hit.v = v;
    }
}

// test_slot over the `tpr` slots of triangle row `row`, read from device
// memory.
__device__ __forceinline__ void test_row(const float* __restrict__ tris,
                                         int row, int tpr, const Ray& r,
                                         Hit& hit) {
    const float* base = tris + static_cast<size_t>(row) * kRowLanes;
    for (int j = 0; j < tpr; ++j) {
        const float* s = base + kTriLanes * j;
        test_slot(__ldg(s + 0), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3),
                  __ldg(s + 4), __ldg(s + 5), __ldg(s + 6), __ldg(s + 7),
                  __ldg(s + 8), static_cast<int>(__ldg(s + 9)), r, hit);
    }
}

// test_row with vector loads (packet_trace.cu, packet_ifif.cu): a row is
// 512 B and a slot 40 B, so slots 2k and 2k + 1 are 80 B from a 16-byte
// boundary, five float4 through the read-only path; an odd last slot is
// five float2. The slots are tested in test_row's order, so the hit is
// test_row's bit for bit.
__device__ __forceinline__ void test_row_vec(const float* __restrict__ tris,
                                             int row, int tpr, const Ray& r,
                                             Hit& hit) {
    const float* base = tris + static_cast<size_t>(row) * kRowLanes;
    int j = 0;
    for (; j + 1 < tpr; j += 2) {
        const float4* s = reinterpret_cast<const float4*>(base
                                                          + kTriLanes * j);
        const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
        const float4 d = __ldg(s + 3), e = __ldg(s + 4);
        test_slot(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x,
                  static_cast<int>(c.y), r, hit);
        test_slot(c.z, c.w, d.x, d.y, d.z, d.w, e.x, e.y, e.z,
                  static_cast<int>(e.w), r, hit);
    }
    if (j < tpr) {
        const float2* s = reinterpret_cast<const float2*>(base
                                                          + kTriLanes * j);
        const float2 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
        const float2 d = __ldg(s + 3), e = __ldg(s + 4);
        test_slot(a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y, e.x,
                  static_cast<int>(e.y), r, hit);
    }
}

// A stack entry whose box the slab test entered at `begin` is culled on pop
// when begin * kSlabLo > hit_t * kSlabHi: slab() compares the same products
// with its exit clamped to hit_t, so the box would fail it now
// (packet_trace.cu, packet_ifif.cu).
__device__ __forceinline__ bool culled(float begin, float hit_t) {
    return begin * kSlabLo > hit_t * kSlabHi;
}

// The same over a row staged in shared memory (`row` 8-byte aligned; a slot
// is 10 floats, so five 8-byte broadcast loads).
__device__ __forceinline__ void test_row_shared(const float* row, int tpr,
                                                const Ray& r, Hit& hit) {
    for (int j = 0; j < tpr; ++j) {
        const float2* s = reinterpret_cast<const float2*>(row + kTriLanes * j);
        const float2 a = s[0], b = s[1], c = s[2], d = s[3], e = s[4];
        test_slot(a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y, e.x,
                  static_cast<int>(e.y), r, hit);
    }
}

// Asynchronous copies into shared memory (cp.async, sm_80 and later; the
// packet_wide and node-batch kernels stage node records and triangle rows
// with them). cp_async16 starts one 16-byte copy (`dst` and `src` 16-byte
// aligned) that waits in the thread's open group; commit_async closes the
// group, and wait_async<n> waits until at most n of the thread's groups
// are still in flight. A copy is visible to the other lanes of a warp
// after the waits and a __syncwarp.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Stage triangle row `row` into `dst` with cp.async: lane c < chunks copies
// 16-byte chunk c (chunks = ceil(10 tris_per_row / 4), the row's used
// bytes). One commit group per call (empty in the other lanes).
__device__ __forceinline__ void fetch_row(float4* dst, const float* tris,
                                          int row, int chunks, int lane) {
    if (lane < chunks)
        cp_async16(dst + lane, tris + static_cast<size_t>(row) * kRowLanes
                               + 4 * lane);
    commit_async();
}

// Miss convention of the reference: tri -1, t = tmax, u = v = 0 (the hit
// record's initial state).
__device__ __forceinline__ void store_hit(const Hit& h, int r, int* out_tri,
                                          float* out_t, float* out_u,
                                          float* out_v) {
    out_tri[r] = h.id;
    out_t[r] = h.t;
    out_u[r] = h.u;
    out_v[r] = h.v;
}

// Queue entry / work item of a leaf run (packet_ww.py:96-97): first_row * 32
// + (rows - 1), rows - 1 clipped to [0, 31].
__device__ __forceinline__ int run_entry(int enc, int cnt) {
    return (-enc - 1) * 32 + min(max(cnt - 1, 0), 31);
}

// The leaf queue of the while-while kernels (packet_ww.cu, packet_pipe.cu):
// up to kCap runs (run_entry values), the top run last, in an array indexed
// by the count (ptxas places it in local memory, beside the stack). A node
// step queues at most two runs, child 0's first, and their node loop pauses
// once a step has queued one, so they use kCap = 2. Two registers and a
// count, or one 64-bit register, measured 2-4% slower on packet_ww's
// primary, shadow and AO batches and alike on the rest (scripts/ww_ab.py).
template <int kCap>
struct RunQueue {
    int n = 0;       // runs queued
    int run[kCap];

    __device__ __forceinline__ void push(int entry) { run[n++] = entry; }
    // The run whose next row is tested next (n > 0).
    __device__ __forceinline__ int front() const { return run[n - 1]; }
    // The top run's next row was tested: the run moves on one row
    // (entry + 31: first row + 1, rows left - 1), or, on its last row,
    // leaves the queue.
    __device__ __forceinline__ void advance() {
        if (run[n - 1] & 31) {
            run[n - 1] += 31;
        } else {
            --n;
        }
    }
};

}  // namespace ntrace

// The C entry point every traversal kernel exports (bound with ctypes,
// ntrace_tpu_torch/kernels/build.py): launches KERNEL<any_hit> on `stream`
// and returns cudaGetLastError() after the launch (0 = cudaSuccess). It does
// not synchronise and allocates nothing.
#define NTRACE_TRAVERSAL_ENTRY(NAME, KERNEL)                                  \
    extern "C" int NAME(const void* nodes, const void* tris,                  \
                        const void* orig, const void* dirn, const void* tmin, \
                        const void* tmax, int n_rays, int nodes_per_row,      \
                        int tris_per_row, int any_hit, void* out_tri,         \
                        void* out_t, void* out_u, void* out_v,                \
                        void* stream) {                                       \
        if (n_rays <= 0) return static_cast<int>(cudaSuccess);                \
        const dim3 grid((n_rays + ntrace::kBlock - 1) / ntrace::kBlock);      \
        const dim3 block(ntrace::kBlock);                                     \
        cudaStream_t s = static_cast<cudaStream_t>(stream);                   \
        const float* n8 = static_cast<const float*>(nodes);                   \
        const float* t12 = static_cast<const float*>(tris);                   \
        const float* o = static_cast<const float*>(orig);                     \
        const float* d = static_cast<const float*>(dirn);                     \
        const float* tn = static_cast<const float*>(tmin);                    \
        const float* tx = static_cast<const float*>(tmax);                    \
        int* tri = static_cast<int*>(out_tri);                                \
        float* t = static_cast<float*>(out_t);                                \
        float* u = static_cast<float*>(out_u);                                \
        float* v = static_cast<float*>(out_v);                                \
        if (any_hit) {                                                        \
            KERNEL<true><<<grid, block, 0, s>>>(                              \
                n8, t12, o, d, tn, tx, n_rays, nodes_per_row, tris_per_row,   \
                tri, t, u, v);                                                \
        } else {                                                              \
            KERNEL<false><<<grid, block, 0, s>>>(                             \
                n8, t12, o, d, tn, tx, n_rays, nodes_per_row, tris_per_row,   \
                tri, t, u, v);                                                \
        }                                                                     \
        return static_cast<int>(cudaGetLastError());                          \
    }
