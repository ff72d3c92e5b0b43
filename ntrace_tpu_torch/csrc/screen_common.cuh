// Device code shared by the screen-space kernels (dense_trace.cu,
// dense_visits.cu, binraster_trace.cu): the ray and hit records of a bin's
// rays, one Moller-Trumbore test folded into the running hit, and the
// largest hit t of a block.
//
// Numerics: the op order is binraster_dense.py:822-849 (the same as
// binraster.py:510-524 and packet_pallas.py's MT). Build with --fmad=false;
// 1.0f / x is IEEE. The accumulator starts at (tmax, -1, 0, 0) and takes a
// candidate when
//   bt < t || (bt == t && bid < id),  bt = ok ? t : INF, bid = ok ? id : MAX
// so the result, the lowest id among the closest hits, does not depend on
// the order in which triangles are tested. The torch twin of all three
// kernels is trace/binraster.py:fold_visits.

#pragma once

#include <cfloat>
#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace ntrace_screen {

constexpr float kInf = 3.0e38f;   // binraster.py INF

// A canonical primary ray: the camera origin and tmin of every ray of the
// frame (scalars [ox, oy, oz, tmin, tmax]), and its own direction.
struct Ray {
    float ox, oy, oz, dx, dy, dz, tmin;
};

struct Hit {
    float t;
    int id;
    float u, v;
};

// Ray `slot` of a frame of n_rays whose directions are component-stacked
// (all x, then all y, then all z).
__device__ __forceinline__ Ray load_ray(const float* dirs,
                                        const float* scalars, size_t slot,
                                        size_t n_rays) {
    return Ray{scalars[0], scalars[1], scalars[2], dirs[slot],
               dirs[n_rays + slot], dirs[2 * n_rays + slot], scalars[3]};
}

// Moller-Trumbore of ray r against the triangle whose lanes
// [v0.xyz e1.xyz e2.xyz tid] start at c (a negative tid is inert
// padding), folded into h by (t, id).
__device__ __forceinline__ void mt_fold(const float* c, const Ray& r,
                                        Hit& h) {
    const float v0x = c[0], v0y = c[1], v0z = c[2];
    const float e1x = c[3], e1y = c[4], e1z = c[5];
    const float e2x = c[6], e2y = c[7], e2z = c[8];
    const int tid = static_cast<int>(c[9]);
    const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    const float c0 = e2x * qx + e2y * qy + e2z * qz;
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
    const float u = (tvx * px + tvy * py + tvz * pz) * inv;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    const float t = c0 * inv;
    const bool ok = det != 0.0f && tid >= 0 && u >= 0.0f && v >= 0.0f
                    && u + v <= 1.0f && t > r.tmin;
    const float bt = ok ? t : kInf;
    const int bid = ok ? tid : INT_MAX;
    if (bt < h.t || (bt == h.t && bid < h.id)) {
        h.t = bt;
        h.id = bid;
        h.u = u;
        h.v = v;
    }
}

// Largest x over a block of kThreads; every thread gets it. `red` holds
// one float per warp.
template <int kThreads>
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    __syncthreads();   // red is free again
    return m;
}

}  // namespace ntrace_screen
