// Device code shared by the BVH traversal kernels (packet_trace.cu,
// packet_ww.cu, packet_ifif.cu): the ray and hit records, the table
// decode, the slab test and the Moller-Trumbore row test.
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

// packet_pallas.py:_slab_child. fminf/fmaxf drop NaN like jnp.fmin/fmax;
// entry is clamped to tmin, exit to the running hit distance.
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
    return t0 <= t1;
}

// Moller-Trumbore of the ray against the `tpr` slots of triangle row
// `row`, each valid hit folded into `hit` by the (t, id) order.
__device__ __forceinline__ void test_row(const float* __restrict__ tris,
                                         int row, int tpr, const Ray& r,
                                         Hit& hit) {
    const float* base = tris + static_cast<size_t>(row) * kRowLanes;
    for (int j = 0; j < tpr; ++j) {
        const float* s = base + kTriLanes * j;
        const float v0x = __ldg(s + 0), v0y = __ldg(s + 1),
                    v0z = __ldg(s + 2);
        const float e1x = __ldg(s + 3), e1y = __ldg(s + 4),
                    e1z = __ldg(s + 5);
        const float e2x = __ldg(s + 6), e2y = __ldg(s + 7),
                    e2z = __ldg(s + 8);
        const int tid = static_cast<int>(__ldg(s + 9));
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
