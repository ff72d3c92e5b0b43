// The dense screen-space engine's visit-list kernel: the walk kernel's
// result (dense_trace.cu:dense_walk), computed over a flat list of
// (tile, bin) visits instead of a walk per bin.
//
// Replaces: ntrace_tpu/trace/binraster_dense.py:_make_visits_kernel
// (trace_dense_visits). It computes the same function, not the TPU
// schedule. There the grid runs the visits in order on one core and keeps
// one bin's accumulator in scratch: reset at the bin's first visit,
// written at its last. The blocks of a CUDA grid have no order, so here
// each visit is independent and the per-ray minimum goes through memory:
//   1. init: every ray's 64-bit key = no hit, u = v = 0;
//   2. one block per visit (and per 256 rays of the bin): the tile (88
//      triangles, 4 KB) into shared memory, each thread folds its ray
//      against the 88 triangles from (tmax, -1), as dense_walk does, and
//      a hit takes atomicMin(key, (t bits << 32) | id);
//   3. the same pass again: a thread whose (t, id) equals the final key
//      writes u and v (equal (t, id) is the same triangle, so every
//      writer writes the same bits);
//   4. finish: tri and t from the key; a miss is (-1, tmax, 0, 0).
// The key orders like (t, id) because every accepted t > tmin >= 0 is a
// positive float, whose bits order as its values (the wrapper refuses
// tmin < 0). The result is the lexicographic (t, id) minimum over the
// visits' candidates with t < tmax: dense_walk's, bit for bit, whatever
// order the blocks run in. A visit's tile index is clamped to the table
// (an empty trailing bin's floor visit may point one past it).
//
// What bounds it on an H100: the pair tests, as dense_walk (one 256 x 88
// block of tests per visit, about 51 float operations and one IEEE
// division each), run twice (passes 2 and 3), plus one 8-byte atomic per
// ray and visit with a hit. The design spends a second pass of arithmetic
// to keep u and v out of the atomic; a 128-bit key would need a lock.
//
// Numerics and the Moller-Trumbore test: screen_common.cuh.

#include <cstdint>

#include <cuda_runtime.h>

#include "screen_common.cuh"

namespace {

using namespace ntrace_screen;

constexpr int kGpt = 8;                       // sublanes per tile
constexpr int kGroups = 11;                   // triangle groups per sublane
constexpr int kCpl = 11;                      // lanes per group
constexpr int kLanes = 128;
constexpr int kTileFloats = kGpt * kLanes;    // 1024 floats = 4 KB
constexpr int kBlock = 256;                   // threads; one float4 each
constexpr unsigned long long kNoHit = ~0ull;
static_assert(kTileFloats == 4 * kBlock, "one float4 of a tile per thread");

__global__ void __launch_bounds__(kBlock) visits_init(
    unsigned long long* __restrict__ keys, float* __restrict__ out_u,
    float* __restrict__ out_v, size_t n) {
    const size_t i = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
    if (i >= n) return;
    keys[i] = kNoHit;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
}

// Pass 2 (kWrite false): atomicMin of each hit's key. Pass 3 (kWrite
// true): u and v of the hits equal to the final key.
template <bool kWrite>
__global__ void __launch_bounds__(kBlock) visits_pass(
    const float* __restrict__ rows, const int* __restrict__ vis_tile,
    const int* __restrict__ vis_bin, const float* __restrict__ dirs,
    const float* __restrict__ scalars, int n_bins, int rays_per_bin,
    int n_tiles, unsigned long long* __restrict__ keys,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float4 tile[kBlock];
    const int b = vis_bin[blockIdx.x];
    if (b < 0 || b >= n_bins) return;      // uniform over the block
    const int w = min(max(vis_tile[blockIdx.x], 0), n_tiles - 1);
    tile[threadIdx.x] = __ldg(reinterpret_cast<const float4*>(
        rows + static_cast<size_t>(w) * kTileFloats) + threadIdx.x);
    __syncthreads();
    const int i = blockIdx.y * kBlock + threadIdx.x;
    if (i >= rays_per_bin) return;
    const size_t n_rays = static_cast<size_t>(n_bins) * rays_per_bin;
    const size_t slot = static_cast<size_t>(b) * rays_per_bin + i;
    const Ray ray = load_ray(dirs, scalars, slot, n_rays);
    Hit h{scalars[4], -1, 0.0f, 0.0f};
    const float* t = reinterpret_cast<const float*>(tile);
#pragma unroll 1
    for (int s = 0; s < kGpt; ++s) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
            mt_fold(t + s * kLanes + g * kCpl, ray, h);
        }
    }
    if (h.id < 0) return;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(h.t)) << 32)
        | static_cast<unsigned int>(h.id);
    if (!kWrite) {
        atomicMin(keys + slot, key);
    } else if (keys[slot] == key) {
        out_u[slot] = h.u;
        out_v[slot] = h.v;
    }
}

__global__ void __launch_bounds__(kBlock) visits_finish(
    const unsigned long long* __restrict__ keys,
    const float* __restrict__ scalars, int* __restrict__ out_tri,
    float* __restrict__ out_t, size_t n) {
    const size_t i = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
    if (i >= n) return;
    const unsigned long long key = keys[i];
    if (key == kNoHit) {
        out_tri[i] = -1;
        out_t[i] = scalars[4];
    } else {
        out_tri[i] = static_cast<int>(key & 0xffffffffull);
        out_t[i] = __uint_as_float(static_cast<unsigned int>(key >> 32));
    }
}

}  // namespace

// C entry point, bound with ctypes (ntrace_tpu_torch/kernels/build.py):
// the four launches on `stream`, in order; returns cudaGetLastError()
// after them (0 = cudaSuccess). `keys` is caller-allocated scratch of
// n_bins * ray_rows * 128 int64. Neither synchronises nor allocates.
extern "C" int ntrace_dense_visits(const void* rows, const void* vis_tile,
                                   const void* vis_bin, const void* dirs,
                                   const void* scalars, void* keys,
                                   int n_visits, int n_bins, int ray_rows,
                                   int n_tiles, void* out_tri, void* out_t,
                                   void* out_u, void* out_v, void* stream) {
    if (n_bins <= 0) return static_cast<int>(cudaSuccess);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rays_per_bin = ray_rows * kLanes;
    const size_t n = static_cast<size_t>(n_bins) * rays_per_bin;
    const unsigned n_blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    auto* k = static_cast<unsigned long long*>(keys);
    auto* u = static_cast<float*>(out_u);
    auto* v = static_cast<float*>(out_v);
    visits_init<<<n_blocks, kBlock, 0, s>>>(k, u, v, n);
    if (n_visits > 0) {
        const dim3 grid(n_visits, (rays_per_bin + kBlock - 1) / kBlock);
        const auto* r = static_cast<const float*>(rows);
        const auto* vt = static_cast<const int*>(vis_tile);
        const auto* vb = static_cast<const int*>(vis_bin);
        const auto* d = static_cast<const float*>(dirs);
        const auto* sc = static_cast<const float*>(scalars);
        visits_pass<false><<<grid, kBlock, 0, s>>>(
            r, vt, vb, d, sc, n_bins, rays_per_bin, n_tiles, k, u, v);
        visits_pass<true><<<grid, kBlock, 0, s>>>(
            r, vt, vb, d, sc, n_bins, rays_per_bin, n_tiles, k, u, v);
    }
    visits_finish<<<n_blocks, kBlock, 0, s>>>(
        k, static_cast<const float*>(scalars), static_cast<int*>(out_tri),
        static_cast<float*>(out_t), n);
    return static_cast<int>(cudaGetLastError());
}
