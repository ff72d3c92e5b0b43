// The v1 screen-space primary engine's kernel: per 32 x 32 pixel bin,
// Moller-Trumbore of the bin's 1,024 rays against its z-sorted rows of 12
// triangles, reduced to the lexicographic (t, id) minimum, with early-z.
//
// Replaces: ntrace_tpu/trace/binraster.py:_make_kernel
// (trace_binraster_rows). It computes the same function as the Pallas
// kernel, not its schedule: there one program loops over the bins, a bin's
// rays being an (8, 128) tile, and each row's 12 triangles are broadcast
// against the tile. Here one block of 256 threads serves one bin, four
// rays a thread (rays i, i + 256, i + 512, i + 768: coalesced loads). The
// block stages `unroll` rows (or ez_chunk rows with early-z on; at most
// MAX_STAGE = 32) into shared memory, 16 bytes a thread, and every thread
// reads each triangle as a broadcast and tests it against its four rays.
//
// Walk per bin: the global rows [0, g_r1) (triangles that cover more bins
// than the prep's slots hold, z-ascending), then the bin's rows
// [row0[b], row1[b]). Row layout (trace/binraster.py:_pack_rows): slot j
// at lanes 10j..10j+9 as [v0.xyz e1.xyz e2.xyz tid], a negative tid inert;
// lane 120 the row's conservative zmin. Rows stay within the range: the
// Pallas kernel's stray rows past a range hold a neighbour bin's real
// triangles or padding, and testing them or not changes no closest hit.
//
// Early-z (ez_chunk > 0, binraster.py:571-595): after each chunk of
// ez_chunk rows the block takes the largest hit t of its 1,024 rays (a miss
// holds tmax) and stops the range when the next row's zmin exceeds it.
// Rows are z-ascending within a range and zmin bounds every hit t on the
// row from below (t >= z for unit directions, with the prep's margin), so
// a skipped row cannot change any ray's result: early-z on or off, and
// any `unroll`, give bit-identical output.
//
// What bounds it on an H100: the pair tests, about 51 float operations and
// one IEEE division per ray and triangle slot, on the FP32 pipes (there is
// no matrix product); a row is 512 bytes, read once per block from L2.
// The design keeps the four rays' hits in registers and reads each
// triangle once per thread from shared memory.
//
// Numerics and the Moller-Trumbore test: screen_common.cuh. The Pallas
// kernel folds a row's 12 candidates by a pairwise tree and then into the
// hit; folding them one by one gives the same (t, id) minimum, and equal
// (t, id) is the same triangle, hence the same u and v bits.

#include <cstdint>

#include <cuda_runtime.h>

#include "screen_common.cuh"

namespace {

using namespace ntrace_screen;

constexpr int kTpb = 12;                      // triangles per row
constexpr int kTriLanes = 10;
constexpr int kLanes = 128;
constexpr int kZLane = 120;
constexpr int kRaysPerBin = 1024;             // a 32 x 32 bin
constexpr int kBlock = 256;
constexpr int kRpt = kRaysPerBin / kBlock;    // rays per thread
constexpr int kMaxStage = 32;                 // binraster.py MAX_STAGE
constexpr int kRowF4 = kLanes / 4;            // float4 per row

struct BinRays {
    Ray ray[kRpt];
    Hit hit[kRpt];
};

// Rows [w0, w1) of `rows` through shared memory, `chunk` at a time, with
// early-z after every chunk when ez is set. Every thread of the block
// takes the same branches.
__device__ void walk(const float* __restrict__ rows, int w0, int w1,
                     int n_rows, int chunk, bool ez, float4* stage,
                     float* red, BinRays& br) {
    for (int r = w0; r < w1;) {
        const int cnt = min(chunk, w1 - r);
        for (int i = threadIdx.x; i < cnt * kRowF4; i += kBlock) {
            const int row = min(r + i / kRowF4, n_rows - 1);
            stage[i] = __ldg(reinterpret_cast<const float4*>(
                rows + static_cast<size_t>(row) * kLanes) + i % kRowF4);
        }
        __syncthreads();
        const float* s = reinterpret_cast<const float*>(stage);
        for (int q = 0; q < cnt; ++q) {
#pragma unroll 1
            for (int j = 0; j < kTpb; ++j) {
                const float* c = s + q * kLanes + j * kTriLanes;
#pragma unroll
                for (int k = 0; k < kRpt; ++k) {
                    mt_fold(c, br.ray[k], br.hit[k]);
                }
            }
        }
        __syncthreads();
        r += cnt;
        if (ez && r < w1) {
            const float znext = __ldg(
                rows + static_cast<size_t>(min(r, n_rows - 1)) * kLanes
                + kZLane);
            float m = br.hit[0].t;
#pragma unroll
            for (int k = 1; k < kRpt; ++k) m = fmaxf(m, br.hit[k].t);
            m = block_max<kBlock>(m, red);
            if (!(znext <= m)) return;
        }
    }
}

__global__ void __launch_bounds__(kBlock) binraster_rows_kernel(
    const float* __restrict__ rows, const int* __restrict__ row0,
    const int* __restrict__ row1, const int* __restrict__ g_r1,
    const float* __restrict__ dirs, const float* __restrict__ scalars,
    int n_rows, int chunk, int ez, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    __shared__ float4 stage[kMaxStage * kRowF4];
    __shared__ float red[kBlock / 32];
    const int b = blockIdx.x;
    const size_t n_rays = static_cast<size_t>(gridDim.x) * kRaysPerBin;
    const size_t base = static_cast<size_t>(b) * kRaysPerBin + threadIdx.x;
    BinRays br;
#pragma unroll
    for (int k = 0; k < kRpt; ++k) {
        br.ray[k] = load_ray(dirs, scalars, base + k * kBlock, n_rays);
        br.hit[k] = Hit{scalars[4], -1, 0.0f, 0.0f};
    }
    if (g_r1 != nullptr) {
        walk(rows, 0, g_r1[0], n_rows, chunk, ez != 0, stage, red, br);
    }
    walk(rows, row0[b], row1[b], n_rows, chunk, ez != 0, stage, red, br);
#pragma unroll
    for (int k = 0; k < kRpt; ++k) {
        const size_t slot = base + k * kBlock;
        out_tri[slot] = br.hit[k].id;
        out_t[slot] = br.hit[k].t;
        out_u[slot] = br.hit[k].u;
        out_v[slot] = br.hit[k].v;
    }
}

}  // namespace

// C entry point, bound with ctypes (ntrace_tpu_torch/kernels/build.py):
// launches on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess). g_r1 may be null (no global rows). unroll in
// [1, 32], ez_chunk in [0, 32] (the wrapper checks). It does not
// synchronise and allocates nothing.
extern "C" int ntrace_binraster_rows(const void* rows, const void* row0,
                                     const void* row1, const void* g_r1,
                                     const void* dirs, const void* scalars,
                                     int n_bins, int n_rows, int unroll,
                                     int ez_chunk, void* out_tri,
                                     void* out_t, void* out_u, void* out_v,
                                     void* stream) {
    if (n_bins <= 0) return static_cast<int>(cudaSuccess);
    if (unroll < 1 || unroll > kMaxStage || ez_chunk < 0
        || ez_chunk > kMaxStage) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int chunk = ez_chunk > 0 ? ez_chunk : unroll;
    binraster_rows_kernel<<<n_bins, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(row0),
        static_cast<const int*>(row1), static_cast<const int*>(g_r1),
        static_cast<const float*>(dirs), static_cast<const float*>(scalars),
        n_rows, chunk, ez_chunk > 0 ? 1 : 0, static_cast<int*>(out_tri),
        static_cast<float*>(out_t), static_cast<float*>(out_u),
        static_cast<float*>(out_v));
    return static_cast<int>(cudaGetLastError());
}
