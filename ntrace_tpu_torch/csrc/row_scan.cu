// Row-wise inclusive int32 cummax / cummin of a contiguous (R, n) array,
// forward or reverse: the LBVH builder's ANSV class scans.
//
// Replaces ntrace_tpu/ops/pscan.py:_make_kernel (row_scan_i32). That kernel
// walks each row in order over a sequential TPU grid of (8k, 8192) VMEM
// blocks and carries the running extremum in scratch. Blocks on Hopper run
// in no order, so the carry across tiles comes from a two-pass tile-
// aggregate scan instead:
//   1. row_tile_reduce: one block per (tile, row) writes the extremum of its
//      4,096-element tile to agg[row][tile];
//   2. row_tile_scan: one block per (tile, row) reduces agg over the
//      earlier tiles of its row (the carry), stages its tile in shared
//      memory with coalesced loads, scans 8 consecutive elements per
//      thread, then the thread totals by warp shuffles and the warp totals
//      through shared memory, and stores the tile back coalesced.
// A reverse scan is a forward scan over logical positions j, read from and
// written to column n - 1 - j. Out-of-range positions hold the identity
// (INT32_MIN for max, INT32_MAX for min). Max and min are exact and order-
// free, so the result is bit-identical to lax.cummax / cummin.
//
// Bound: bytes. The work is one compare per element; the least traffic is
// one read and one write of R*n*4 bytes. This design reads the input twice
// (pass 1 and pass 2), so it moves 1.5x the bound's bytes; a single-pass
// decoupled look-back scan is the later speed work.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // elements per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool kMax>
__device__ __forceinline__ int op(int a, int b) {
  return kMax ? max(a, b) : min(a, b);
}

template <bool kMax>
__device__ __forceinline__ int identity() {
  return kMax ? INT_MIN : INT_MAX;
}

// Column of logical position j: reverse scans run from the right.
__device__ __forceinline__ long long column(long long j, long long n,
                                            bool reverse) {
  return reverse ? n - 1 - j : j;
}

// Extremum of v over the block; every thread gets it. warp_buf has kWarps
// slots and is free again when this returns.
template <bool kMax>
__device__ int block_reduce(int v, int* warp_buf) {
  for (int o = 16; o > 0; o >>= 1)
    v = op<kMax>(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_buf[lane] : identity<kMax>();
    for (int o = 16; o > 0; o >>= 1)
      v = op<kMax>(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) warp_buf[0] = v;
  }
  __syncthreads();
  const int out = warp_buf[0];
  __syncthreads();
  return out;
}

template <bool kMax>
__global__ void __launch_bounds__(kThreads)
row_tile_reduce(const int* __restrict__ x, int* __restrict__ agg, int n,
                int ntiles, bool reverse) {
  __shared__ int warp_buf[kWarps];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int* xr = x + (long long)row * n;
  const long long j0 = (long long)tile * kTile;
  int v = identity<kMax>();
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const long long j = j0 + k;
    if (j < n) v = op<kMax>(v, xr[column(j, n, reverse)]);
  }
  v = block_reduce<kMax>(v, warp_buf);
  if (threadIdx.x == 0) agg[(long long)row * ntiles + tile] = v;
}

template <bool kMax>
__global__ void __launch_bounds__(kThreads)
row_tile_scan(const int* __restrict__ x, const int* __restrict__ agg,
              int* __restrict__ out, int n, int ntiles, bool reverse) {
  __shared__ int buf[kTile];
  __shared__ int warp_buf[kWarps];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int* xr = x + (long long)row * n;
  int* outr = out + (long long)row * n;
  const long long j0 = (long long)tile * kTile;

  // The carry: the extremum of every earlier tile of this row.
  int carry = identity<kMax>();
  const int* aggr = agg + (long long)row * ntiles;
  for (int k = threadIdx.x; k < tile; k += kThreads)
    carry = op<kMax>(carry, aggr[k]);
  carry = block_reduce<kMax>(carry, warp_buf);

  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const long long j = j0 + k;
    buf[k] = j < n ? xr[column(j, n, reverse)] : identity<kMax>();
  }
  __syncthreads();

  // Each thread scans its kItems consecutive positions.
  int* mine = buf + threadIdx.x * kItems;
  int acc = mine[0];
  for (int i = 1; i < kItems; ++i) {
    acc = op<kMax>(acc, mine[i]);
    mine[i] = acc;
  }
  // Inclusive scan of the thread totals within each warp ...
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = acc;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s = op<kMax>(s, y);
  }
  if (lane == 31) warp_buf[warp] = s;
  __syncthreads();
  // ... and of the warp totals, in warp 0.
  if (warp == 0) {
    int w = lane < kWarps ? warp_buf[lane] : identity<kMax>();
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = op<kMax>(w, y);
    }
    if (lane < kWarps) warp_buf[lane] = w;
  }
  __syncthreads();
  // Everything before this thread's first position: the carry, the
  // earlier warps and the earlier lanes of this warp.
  int before = carry;
  if (warp > 0) before = op<kMax>(before, warp_buf[warp - 1]);
  const int left = __shfl_up_sync(kFull, s, 1);
  if (lane > 0) before = op<kMax>(before, left);
  for (int i = 0; i < kItems; ++i) mine[i] = op<kMax>(before, mine[i]);
  __syncthreads();

  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const long long j = j0 + k;
    if (j < n) outr[column(j, n, reverse)] = buf[k];
  }
}

template <bool kMax>
cudaError_t launch(const int* x, int* out, int* agg, int rows, int n,
                   int ntiles, bool reverse, cudaStream_t stream) {
  const dim3 grid(ntiles, rows);
  row_tile_reduce<kMax><<<grid, kThreads, 0, stream>>>(x, agg, n, ntiles,
                                                       reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_tile_scan<kMax><<<grid, kThreads, 0, stream>>>(x, agg, out, n, ntiles,
                                                     reverse);
  return cudaGetLastError();
}

}  // namespace

// Elements per tile; the caller sizes agg as rows * ceil(n / tile).
extern "C" int ntrace_row_scan_tile() { return kTile; }

// out[r] = inclusive cummax (is_max) or cummin of x[r] along n, from the
// right when reverse. x, out: (rows, n) int32, contiguous; agg: scratch of
// agg_len >= rows * ceil(n / kTile) int32. Returns a cudaError_t.
extern "C" int ntrace_row_scan_i32(const int* x, int* out, int* agg,
                                   long long agg_len, int rows, int n,
                                   int is_max, int reverse,
                                   cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || rows > 65535) return cudaErrorInvalidValue;
  const int ntiles = (n + kTile - 1) / kTile;
  if (agg_len < (long long)rows * ntiles) return cudaErrorInvalidValue;
  const cudaError_t err =
      is_max ? launch<true>(x, out, agg, rows, n, ntiles, reverse != 0, stream)
             : launch<false>(x, out, agg, rows, n, ntiles, reverse != 0,
                             stream);
  return (int)err;
}
