// The dense screen-space primary engine's two kernels: per screen bin,
// Moller-Trumbore of the bin's rays against its prepped triangle tiles,
// reduced to the lexicographic (t, id) minimum.
//
// Replaces: ntrace_tpu/trace/binraster_dense.py
//   dense_walk <- _make_dense_kernel (trace_dense_rows), with early-z;
//   dense_dma  <- _make_dense_kernel_dma (trace_dense_rows_dma), the same
//                 walk with the tile fetch double-buffered.
// They compute the same function as the Pallas kernels, not their (8, 128)
// sublane schedule. There, one grid step replicates a bin's ray rows over
// eight sublanes and broadcasts each triangle's lanes against them. Here
// one block of 256 threads serves one bin (at tile 16 a bin is 256 rays;
// larger bins take several blocks), one thread per ray. The block copies
// each 8 x 128-float tile (88 triangles, 4 KB) into shared memory once, and
// every thread then reads the triangles as broadcasts: all threads of a
// warp read the same address, so there are no bank conflicts.
//
// Walk per bin: the global-tier tiles [0, g_r1) (triangles that cover too
// many bins to be listed per bin), then the bin's own tiles
// [row0[b], row1[b]). Tile layout (trace/binraster_dense.py:_pack_dense):
// sublane s, group g holds one triangle in lanes 11g..11g+10 as
// [v0.xyz e1.xyz e2.xyz tid zmin]; a negative tid is inert padding.
//
// What bounds it on an H100: the work is one 256 x 88 block of pair tests
// per visited tile, about 45 float operations and one IEEE division per
// pair, and one 4 KB tile load per visit. The conference frame visits some
// 8-9 thousand (bin, tile) pairs: about 2e8 pair tests, so the FP32 pipes
// (no tensor-core work exists here) and the divisions bound it, and the
// tile loads are small and L2-resident (the table is about 20 MB). So the
// design keeps the per-pair work in registers, loads each tile once per
// block as one float4 per thread, and spends nothing on the ray side after
// the first read of the ray's direction. dense_walk pays one load latency
// per tile between two __syncthreads; dense_dma hides it with a two-slot
// cp.async ring (tile k+1 in flight while tile k is tested), which is what
// _make_dense_kernel_dma does with async DMA on the TPU. TMA and wgmma have
// no place: the tiles are tiny and there is no matrix product.
//
// Early-z (dense_walk, ez_chunk > 0): after each chunk of ez_chunk tiles
// the block takes the largest hit t of its rays (a miss holds tmax) and
// stops the walk when the next tile's zmin (sublane 0, lane 10: the
// tile's first and z-smallest pair) exceeds it, the rule of
// binraster_dense.py:884-902. The prep's zmin is a conservative lower
// bound of any hit t on that tile, so the skipped tiles cannot change any
// ray's result: early-z on or off gives bit-identical output.
//
// Numerics, and the Moller-Trumbore test itself: screen_common.cuh.
// Results go out in ray slot order.

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
static_assert(kTileFloats == 4 * kBlock, "one float4 of a tile per thread");

// Moller-Trumbore of one ray against the 88 triangles of a tile in shared
// memory, folded into the running (t, id) minimum.
__device__ __forceinline__ void test_tile(const float* tile, const Ray& r,
                                          Hit& h) {
#pragma unroll 1
    for (int s = 0; s < kGpt; ++s) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
            mt_fold(tile + s * kLanes + g * kCpl, r, h);
        }
    }
}

__device__ __forceinline__ const float4* tile_src(const float* rows, int w) {
    return reinterpret_cast<const float4*>(
        rows + static_cast<size_t>(w) * kTileFloats) + threadIdx.x;
}

// The block's ray: slot b * rays_per_bin + i; the dirs are component-
// stacked (all x, then all y, then all z).
struct BinRays {
    Ray ray;
    Hit hit;
    bool active;
    size_t slot;
};

__device__ __forceinline__ BinRays bin_rays(const float* dirs,
                                            const float* scalars,
                                            int rays_per_bin) {
    BinRays br;
    const int i = blockIdx.y * kBlock + threadIdx.x;
    const size_t n_rays = static_cast<size_t>(gridDim.x) * rays_per_bin;
    br.active = i < rays_per_bin;
    br.slot = static_cast<size_t>(blockIdx.x) * rays_per_bin + i;
    br.ray = load_ray(dirs, scalars, br.active ? br.slot : 0, n_rays);
    br.hit = Hit{scalars[4], -1, 0.0f, 0.0f};
    return br;
}

__device__ __forceinline__ void store_hit(const BinRays& br, int* out_tri,
                                          float* out_t, float* out_u,
                                          float* out_v) {
    if (!br.active) return;
    out_tri[br.slot] = br.hit.id;
    out_t[br.slot] = br.hit.t;
    out_u[br.slot] = br.hit.u;
    out_v[br.slot] = br.hit.v;
}

// dense_walk: tiles [w0, w1) one at a time through shared memory, with
// early-z after every ez_chunk tiles when ez_chunk > 0.
__device__ void walk(const float* rows, int w0, int w1, int n_tiles,
                     int ez_chunk, float4* tile, float* red, BinRays& br) {
    const int chunk = ez_chunk > 0 ? ez_chunk : INT_MAX;
    for (int w = w0; w < w1;) {
        const int end = w1 - w > chunk ? w + chunk : w1;
        for (; w < end; ++w) {
            tile[threadIdx.x] = __ldg(tile_src(rows, min(w, n_tiles - 1)));
            __syncthreads();
            if (br.active) {
                test_tile(reinterpret_cast<const float*>(tile), br.ray,
                          br.hit);
            }
            __syncthreads();
        }
        if (ez_chunk > 0 && w < w1) {
            const float znext = __ldg(
                rows + static_cast<size_t>(min(w, n_tiles - 1)) * kTileFloats
                + 10);
            const float mt = block_max<kBlock>(
                br.active ? br.hit.t : -FLT_MAX, red);
            if (!(znext <= mt)) return;
        }
    }
}

__global__ void __launch_bounds__(kBlock) dense_walk_kernel(
    const float* __restrict__ rows, const int* __restrict__ row0,
    const int* __restrict__ row1, const int* __restrict__ g_r1,
    const float* __restrict__ dirs, const float* __restrict__ scalars,
    int rays_per_bin, int n_tiles, int ez_chunk, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    __shared__ float4 tile[kBlock];
    __shared__ float red[kBlock / 32];
    BinRays br = bin_rays(dirs, scalars, rays_per_bin);
    const int b = blockIdx.x;
    if (g_r1 != nullptr) {
        walk(rows, 0, g_r1[0], n_tiles, ez_chunk, tile, red, br);
    }
    walk(rows, row0[b], row1[b], n_tiles, ez_chunk, tile, red, br);
    store_hit(br, out_tri, out_t, out_u, out_v);
}

// cp.async: this thread's 16 bytes of tile w into `dst`, as one commit
// group.
__device__ __forceinline__ void fetch_async(float4* dst, const float* rows,
                                            int w) {
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + threadIdx.x));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(tile_src(rows, w)) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// dense_dma: tiles [w0, w1) through a two-slot ring. Every group started
// in a walk is waited for in the same walk (binraster_dense.py:1097-1114).
__device__ void walk_dma(const float* rows, int w0, int w1, int n_tiles,
                         float4 (*buf)[kBlock], BinRays& br) {
    const int trips = w1 - w0;
    if (trips > 0) fetch_async(buf[0], rows, min(w0, n_tiles - 1));
    for (int k = 0; k < trips; ++k) {
        const int slot = k & 1;
        if (k + 1 < trips) {
            // The other slot was last read in trip k-1, which ended with
            // __syncthreads: it is free to overwrite.
            fetch_async(buf[slot ^ 1], rows, min(w0 + k + 1, n_tiles - 1));
            wait_async<1>();   // all but the newest group: tile k is here
        } else {
            wait_async<0>();
        }
        __syncthreads();       // every thread's part of tile k is visible
        if (br.active) {
            test_tile(reinterpret_cast<const float*>(buf[slot]), br.ray,
                      br.hit);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kBlock) dense_dma_kernel(
    const float* __restrict__ rows, const int* __restrict__ row0,
    const int* __restrict__ row1, const int* __restrict__ g_r1,
    const float* __restrict__ dirs, const float* __restrict__ scalars,
    int rays_per_bin, int n_tiles, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    __shared__ float4 buf[2][kBlock];
    BinRays br = bin_rays(dirs, scalars, rays_per_bin);
    const int b = blockIdx.x;
    if (g_r1 != nullptr) walk_dma(rows, 0, g_r1[0], n_tiles, buf, br);
    walk_dma(rows, row0[b], row1[b], n_tiles, buf, br);
    store_hit(br, out_tri, out_t, out_u, out_v);
}

dim3 grid_of(int n_bins, int ray_rows) {
    const int rays_per_bin = ray_rows * kLanes;
    return dim3(n_bins, (rays_per_bin + kBlock - 1) / kBlock);
}

}  // namespace

// C entry points, bound with ctypes (ntrace_tpu_torch/kernels/build.py).
// Each launches on `stream` and returns cudaGetLastError() after the
// launch (0 = cudaSuccess). g_r1 may be null (no global tier). Neither
// synchronises nor allocates.
extern "C" int ntrace_dense_walk(const void* rows, const void* row0,
                                 const void* row1, const void* g_r1,
                                 const void* dirs, const void* scalars,
                                 int n_bins, int ray_rows, int n_tiles,
                                 int ez_chunk, void* out_tri, void* out_t,
                                 void* out_u, void* out_v, void* stream) {
    if (n_bins <= 0) return static_cast<int>(cudaSuccess);
    dense_walk_kernel<<<grid_of(n_bins, ray_rows), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(row0),
        static_cast<const int*>(row1), static_cast<const int*>(g_r1),
        static_cast<const float*>(dirs), static_cast<const float*>(scalars),
        ray_rows * kLanes, n_tiles, ez_chunk, static_cast<int*>(out_tri),
        static_cast<float*>(out_t), static_cast<float*>(out_u),
        static_cast<float*>(out_v));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ntrace_dense_dma(const void* rows, const void* row0,
                                const void* row1, const void* g_r1,
                                const void* dirs, const void* scalars,
                                int n_bins, int ray_rows, int n_tiles,
                                void* out_tri, void* out_t, void* out_u,
                                void* out_v, void* stream) {
    if (n_bins <= 0) return static_cast<int>(cudaSuccess);
    dense_dma_kernel<<<grid_of(n_bins, ray_rows), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(row0),
        static_cast<const int*>(row1), static_cast<const int*>(g_r1),
        static_cast<const float*>(dirs), static_cast<const float*>(scalars),
        ray_rows * kLanes, n_tiles, static_cast<int*>(out_tri),
        static_cast<float*>(out_t), static_cast<float*>(out_u),
        static_cast<float*>(out_v));
    return static_cast<int>(cudaGetLastError());
}
