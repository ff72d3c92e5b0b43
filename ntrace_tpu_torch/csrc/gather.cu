// Exact row gather from a table split into four int8 byte planes:
// out[q] = table[idx[q]] bit for bit, the table given as (Np, 4C) int8
// planes [b0 | b1 | b2 | b3] (little-endian bytes of each f32 word).
//
// Replaces ntrace_tpu/ops/gather.py:_gather_kernel (paged_gather_bytes).
// That kernel sorts the requests by 512-row page, places them in tiles of
// one page each and rebuilds each row on the MXU as an int8 one-hot matmul
// against the page's byte planes, then scatters the rows back to request
// order. The sort, the tiles and the matmul are the TPU's schedule: on
// Hopper a row gather is a plain load, so each thread here makes one
// output word from its four bytes, in request order.
//
// All work is in integers: NaN payloads, infinities, denormals and -0.0
// come through bit for bit. An index outside [0, Np) is clamped for the
// read, so the kernel reads no memory outside the table (the reference
// leaves that result unspecified).
//
// Bound: bytes. The indices are read once (4Q), each table row that they
// touch is read from HBM once (4C bytes a unique row, at most 4CQ: a row
// read again comes from L2) and each output row is written once (4CQ).
// Neighbouring threads take neighbouring words of a row, so each plane's
// C bytes of the row are read by neighbouring lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_bytes(const uint8_t* __restrict__ planes, const int* __restrict__ idx,
             uint32_t* __restrict__ out, long long words, int c,
             long long np) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += stride) {
    const long long q = w / c;
    const int j = (int)(w - q * c);
    long long r = idx[q];
    r = r < 0 ? 0 : (r >= np ? np - 1 : r);
    const uint8_t* row = planes + r * 4 * c + j;
    out[w] = (uint32_t)row[0] | ((uint32_t)row[c] << 8) |
             ((uint32_t)row[2 * c] << 16) | ((uint32_t)row[3 * c] << 24);
  }
}

}  // namespace

// out (q, c) 32-bit words = the rows idx (q,) int32 of planes (np, 4c)
// int8; all contiguous. Returns a cudaError_t.
extern "C" int ntrace_gather_bytes(const void* planes, const int* idx,
                                   void* out, long long q, int c,
                                   long long np, cudaStream_t stream) {
  if (q < 0 || c <= 0 || np <= 0) return cudaErrorInvalidValue;
  const long long words = q * c;
  if (words == 0) return cudaSuccess;
  long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride past this
  gather_bytes<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(planes), idx, static_cast<uint32_t*>(out),
      words, c, np);
  return (int)cudaGetLastError();
}
