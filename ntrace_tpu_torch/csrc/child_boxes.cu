// The LBVH's child boxes: for each compact node q, the box of the sorted
// triangle boxes over rows [a[q], i[q]) and over rows [i[q], b[q]).
//
// Replaces no TPU kernel. The reference builds a sparse range-min table over
// the sorted boxes with jnp ops (ntrace_tpu/bvh/lbvh.py, lbvh_device_fast's
// "child AABBs" and lbvh_device's range_bounds): ceil(log2 n) + 1 levels of
// (6, n) float32, about 1.6 GB at the hairball's 2.9M rows, for two reads a
// range. Its torch port rebuilt that table with eager cat / minimum / stack
// on every frame of the per-frame rebuild.
//
// Bound: bytes. The least traffic is the sorted boxes read once (24 B a
// row), the three range ends read (12 B a node) and the boxes written
// (48 B a node). The design keeps everything else in L2:
//   1. box_levels: one pass over the rows builds a min tree of fan-out 32.
//      A warp reduces 32 rows to a level-1 entry, the block's 32 warps
//      reduce their entries to a level-2 entry, and the last block to
//      finish each group of 32 (an atomic count a group) reduces the group
//      to the entry above, up to a level of at most 32 entries. At 2.9M
//      rows the levels hold 90,638 + 2,833 + 89 + 3 entries (3 MB).
//   2. box_query: one warp a node. A range [l, r) at level h reads its
//      partial groups at both ends (at most 31 entries each, one load a
//      lane) and goes up a level with the whole groups between them, until
//      the range fits inside at most two groups, or the top level. The
//      lanes keep running minima; one warp reduction a range.
// Keys: a float's bits u map to the int u ^ ((u >> 31) & 0x7fffffff),
// which orders every float but NaN as its value and puts -0.0 just below
// +0.0. A box is the min of the lo keys and the min of the complemented hi
// keys, so both are integer minima: exact and free of order, whatever the
// decomposition. Mixed zeros give -0.0 to lo and +0.0 to hi, as lax.min
// does on the reference's side. NaN boxes are not ordered as lax.min would.
// Nodes at or past *count are not computed and get zeros.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kFan = 32;         // entries a group holds, at every level
constexpr int kMaxLevels = 6;    // 32**5 rows > 2**24, the build's limit
constexpr int kBuildWarps = 32;  // a build block makes one level-2 entry
constexpr int kQueryWarps = 8;
constexpr int kEntry = 8;        // ints an entry: 6 keys and 2 of padding
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdentity = INT_MAX;

// Level h >= 1 has size[h] entries at tab + off[h] * kEntry; its group
// counters (h >= 3) start at cnt + cnt_off[h]. levels is 0 for n <= 32.
struct Levels {
  int levels;
  int size[kMaxLevels + 1];
  long long off[kMaxLevels + 1];
  long long cnt_off[kMaxLevels + 1];
};

__device__ __forceinline__ int key_of(float x) {
  const int u = __float_as_int(x);
  return u ^ ((u >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ void fold(int* acc, const int* k) {
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = min(acc[c], k[c]);
}

// Every lane gets the minimum over the warp.
__device__ __forceinline__ void warp_min(int* k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < 6; ++c)
      k[c] = min(k[c], __shfl_xor_sync(kFull, k[c], o));
}

__device__ __forceinline__ void row_keys(const float* __restrict__ slo,
                                         const float* __restrict__ shi,
                                         long long row, int* k) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    k[c] = key_of(slo[row * 3 + c]);
    k[3 + c] = ~key_of(shi[row * 3 + c]);
  }
}

__device__ __forceinline__ void store_entry(int* e, const int* k) {
  reinterpret_cast<int4*>(e)[0] = make_int4(k[0], k[1], k[2], k[3]);
  reinterpret_cast<int4*>(e)[1] = make_int4(k[4], k[5], kIdentity, kIdentity);
}

// An entry written by another block of this launch: read through L2.
__device__ __forceinline__ void load_entry_cg(const int* e, int* k) {
  const int4 p = __ldcg(reinterpret_cast<const int4*>(e));
  const int4 q = __ldcg(reinterpret_cast<const int4*>(e) + 1);
  k[0] = p.x; k[1] = p.y; k[2] = p.z; k[3] = p.w; k[4] = q.x; k[5] = q.y;
}

__device__ __forceinline__ void load_entry(const int* e, int* k) {
  const int4 p = __ldg(reinterpret_cast<const int4*>(e));
  const int4 q = __ldg(reinterpret_cast<const int4*>(e) + 1);
  k[0] = p.x; k[1] = p.y; k[2] = p.z; k[3] = p.w; k[4] = q.x; k[5] = q.y;
}

__global__ void __launch_bounds__(kBuildWarps * 32)
box_levels(const float* __restrict__ slo, const float* __restrict__ shi,
           int n, int* tab, int* cnt, Levels lv) {
  __shared__ int part[kBuildWarps][6];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e1 = blockIdx.x * kBuildWarps + warp;
  const long long row = (long long)e1 * kFan + lane;
  int k[6];
  if (row < n) {
    row_keys(slo, shi, row, k);
  } else {
#pragma unroll
    for (int c = 0; c < 6; ++c) k[c] = kIdentity;
  }
  warp_min(k);
  if (lane == 0) {
    if (e1 < lv.size[1]) store_entry(tab + (lv.off[1] + e1) * kEntry, k);
#pragma unroll
    for (int c = 0; c < 6; ++c) part[warp][c] = k[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) k[c] = part[lane][c];
    warp_min(k);
    if (lane == 0) store_entry(tab + (lv.off[2] + blockIdx.x) * kEntry, k);
  }
  // Up the levels: the last block of each group of 32 makes its entry.
  int e = blockIdx.x;
  for (int h = 3; h <= lv.levels; ++h) {
    const int g = e / kFan;
    const int members = min(kFan, lv.size[h - 1] - g * kFan);
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(cnt + lv.cnt_off[h] + g, 1) == members - 1;
    }
    __syncthreads();
    if (!last) return;
    if (warp == 0) {
      __threadfence();
      const int j = g * kFan + lane;
      if (j < lv.size[h - 1]) {
        load_entry_cg(tab + (lv.off[h - 1] + j) * kEntry, k);
      } else {
#pragma unroll
        for (int c = 0; c < 6; ++c) k[c] = kIdentity;
      }
      warp_min(k);
      if (lane == 0) store_entry(tab + (lv.off[h] + g) * kEntry, k);
    }
    e = g;
    __syncthreads();
  }
}

// acc over the entries [p, p + c) of level h, lane j taking entry p + j.
__device__ __forceinline__ void take(const float* __restrict__ slo,
                                     const float* __restrict__ shi,
                                     const int* __restrict__ tab,
                                     const Levels& lv, int h, int p, int c,
                                     int lane, int* acc) {
  if (lane >= c) return;
  int k[6];
  if (h == 0) {
    row_keys(slo, shi, (long long)p + lane, k);
  } else {
    load_entry(tab + (lv.off[h] + p + lane) * kEntry, k);
  }
  fold(acc, k);
}

// The keys of rows [l, r); every lane gets them.
__device__ void range_keys(const float* __restrict__ slo,
                           const float* __restrict__ shi,
                           const int* __restrict__ tab, const Levels& lv,
                           int l, int r, int lane, int* acc) {
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = kIdentity;
  for (int h = 0; l < r; ++h) {
    if (h == lv.levels) {             // the top: at most 32 entries
      take(slo, shi, tab, lv, h, l, r - l, lane, acc);
      break;
    }
    const int lu = (l + kFan - 1) / kFan, rd = r / kFan;
    if (lu >= rd) {                   // inside at most two groups
      take(slo, shi, tab, lv, h, l, min(r - l, kFan), lane, acc);
      take(slo, shi, tab, lv, h, l + kFan, r - l - kFan, lane, acc);
      break;
    }
    take(slo, shi, tab, lv, h, l, lu * kFan - l, lane, acc);
    take(slo, shi, tab, lv, h, rd * kFan, r - rd * kFan, lane, acc);
    l = lu;
    r = rd;
  }
  warp_min(acc);
}

// Lanes 0..5 of the warp write lo (keys 0..2) and hi (keys 3..5) to o.
__device__ __forceinline__ void write_box(const int* acc, int lane,
                                          float* o) {
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (lane == c) o[c] = c < 3 ? float_of(acc[c]) : float_of(~acc[c]);
}

__global__ void __launch_bounds__(kQueryWarps * 32)
box_query(const float* __restrict__ slo, const float* __restrict__ shi,
          const int* __restrict__ tab, Levels lv, const int* __restrict__ a,
          const int* __restrict__ i, const int* __restrict__ b,
          const int* __restrict__ count, float* __restrict__ out, int m) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kQueryWarps + (threadIdx.x >> 5);
  if (q >= m) return;
  float* o = out + (long long)q * 12;
  if (q >= *count) {
    if (lane < 12) o[lane] = 0.0f;
    return;
  }
  const int l = a[q], mid = i[q], r = b[q];
  int acc[6];
  range_keys(slo, shi, tab, lv, l, mid, lane, acc);
  write_box(acc, lane, o);
  range_keys(slo, shi, tab, lv, mid, r, lane, acc);
  write_box(acc, lane, o + 6);
}

// The level sizes and offsets for n rows; returns the scratch ints.
long long plan(int n, Levels* lv) {
  *lv = Levels{};
  lv->size[0] = n;
  if (n <= kFan) return 0;
  int h = 0;
  long long entries = 0, counters = 0;
  do {
    ++h;
    lv->size[h] = (lv->size[h - 1] + kFan - 1) / kFan;
    lv->off[h] = entries;
    entries += lv->size[h];
  } while (h < 2 || lv->size[h] > kFan);
  lv->levels = h;
  for (int g = 3; g <= h; ++g) {
    lv->cnt_off[g] = counters;
    counters += lv->size[g];
  }
  for (int g = 3; g <= h; ++g) lv->cnt_off[g] += entries * kEntry;
  return entries * kEntry + counters;
}

}  // namespace

// The int32 scratch the call needs for n sorted rows (under 5M for the
// 2**24 rows the build takes).
extern "C" int ntrace_child_boxes_scratch(int n) {
  Levels lv;
  return n > 0 ? (int)plan(n, &lv) : 0;
}

// out[q] = [lo, hi] of the sorted boxes over rows [a[q], i[q]), then over
// [i[q], b[q]): (m, 12) float32, NaN lanes for an empty range. slo, shi:
// (n, 3) float32, contiguous; a, i, b: (m,) int32 with
// 0 <= a <= i <= b <= n for q < *count; count: one
// int32 in device memory; scratch: scratch_len >= the size from
// ntrace_child_boxes_scratch(n) int32. Returns a cudaError_t.
extern "C" int ntrace_child_boxes(const float* slo, const float* shi,
                                  const int* a, const int* i, const int* b,
                                  const int* count, float* out, int* scratch,
                                  long long scratch_len, int n, int m,
                                  cudaStream_t stream) {
  if (n <= 0 || m < 0 || n >= (1 << 24)) return cudaErrorInvalidValue;
  Levels lv;
  const long long need = plan(n, &lv);
  if (scratch_len < need) return cudaErrorInvalidValue;
  if (lv.levels > 0) {
    if (lv.levels >= 3) {   // the group counters, after the entries
      cudaError_t err = cudaMemsetAsync(
          scratch + lv.cnt_off[3], 0, (need - lv.cnt_off[3]) * sizeof(int),
          stream);
      if (err != cudaSuccess) return err;
    }
    box_levels<<<lv.size[2], kBuildWarps * 32, 0, stream>>>(
        slo, shi, n, scratch, scratch, lv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (m > 0) {
    const int blocks = (m + kQueryWarps - 1) / kQueryWarps;
    box_query<<<blocks, kQueryWarps * 32, 0, stream>>>(
        slo, shi, scratch, lv, a, i, b, count, out, m);
    return (int)cudaGetLastError();
  }
  return cudaSuccess;
}
