// The AO or diffuse rays of a frame and their int32 sort key, in one launch.
//
// Replaces no TPU kernel. The reference draws these rays with jax.random
// and jnp ops that XLA fuses; the port ran the same arithmetic as about 240
// eager torch ops (threefry2x32 on int64 words, about 180 of them; the
// surface frame, cosine_hemisphere, repeat_interleave and the Morton key),
// about 7 ms of device time a 1024x768 frame at 4 samples on the H100,
// each op reading and writing tens of MB. Here each ray is computed once, in
// registers, and each output is written once.
//
// Thread j makes secondary ray j = i * S + s of primary ray i, so the
// writes are coalesced:
//   1. the surface frame of primary ray i (ray/raygen.py:surface_frame and
//      Renderer.gen_secondary): hit = tri >= 0, the hit point
//      orig + (hit ? t : 0) * dirn, the unit geometric normal gathered at
//      max(tri, 0), flipped against dirn;
//   2. the two uniforms of rng.uniform(key, (R, S, 2)) at the row-major
//      indices 2j and 2j + 1 (ray/rng.py): threefry2x32 of the counters
//      (idx >> 32, idx & 0xFFFFFFFF), bits1 ^ bits2, the top 23 bits as the
//      mantissa of a float in [1, 2), minus 1, at least 0;
//   3. cosine_hemisphere and _onb: (lx * b1 + ly * b2) + lz * n;
//   4. orig = hit point + n * eps, tmin = 0, tmax = hit ? length : 0;
//   5. the sort key (ray/raybatch.py:morton_sort_key, ops/morton.py): the
//      origin's 30-bit Morton code over the scene box, with the direction
//      octant in the low 3 bits (AO, origin-major) or the 6-bit direction
//      code above code >> 5 (diffuse, direction-major); 0x7FFFFFFF where
//      tmax <= tmin.
// Every step keeps the torch chain's op order. Built with --fmad=false and
// without fast math (IEEE division and sqrtf), so the random bits, origins,
// tmin, tmax and keys are bit-equal to the plain version
// (raygen.secondary_rays_ref); directions too wherever cosf and sinf give
// what torch's cos and sin give (they call the same CUDA functions on the
// card).
//
// Bound: bytes. Per primary ray 32 B read (origin, direction, tri, t),
// each distinct 12-byte normal row that the hits gather read once, per
// secondary ray 36 B written (origin, direction, tmin, tmax, key): at most
// 142 MB, 0.042 ms at 3.35 TB/s, for a 1024x768 frame at 4 samples of a
// scene of 300,000 triangles. About 300 integer and float operations a
// ray (two threefry2x32 of 20 rounds; cosf, sinf, four sqrtf), under
// 0.06 ms at the card's int32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kDeadKey = 0x7FFFFFFF;
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 * pi)

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Four rounds of threefry2x32 with the rotations r0..r3.
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// bits1 ^ bits2 of threefry2x32 of the counter (x0, x1) under the key
// (k0, k1): ray/rng.py:threefry2x32, five blocks of four rounds, a key
// injection after each.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// rng.random_bits32's word at the row-major index idx.
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            unsigned long long idx) {
  return threefry_bits(k0, k1, (uint32_t)(idx >> 32), (uint32_t)idx);
}

// rng.uniform's float of the word `bits`.
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f, 0.0f);
}

// ops/morton.py:expand_bits_3d in uint32 arithmetic.
__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// ops/morton.py:quantize_points of one coordinate, 10 bits.
__device__ __forceinline__ uint32_t quantize(float p, float lo, float hi) {
  const float ext = fmaxf(hi - lo, 1e-30f);
  const float t = fminf(fmaxf((p - lo) / ext, 0.0f), 1.0f);
  return (uint32_t)(int)(t * 1023.0f);
}

__global__ void __launch_bounds__(kThreads)
secondary_rays(const float* __restrict__ orig, const float* __restrict__ dirn,
               const int* __restrict__ tri, const float* __restrict__ thit,
               const float* __restrict__ gnorm,
               const float* __restrict__ scene_lo,
               const float* __restrict__ scene_hi, uint32_t k0, uint32_t k1,
               long long n, int samples, float length, float eps,
               int direction_major, float* __restrict__ o_out,
               float* __restrict__ d_out, float* __restrict__ tmin_out,
               float* __restrict__ tmax_out, int* __restrict__ key_out,
               uint32_t* __restrict__ bits_out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long i = j / samples;

  // 1. The surface frame of primary ray i.
  const int ti = tri[i];
  const bool hit = ti >= 0;
  const float dx = dirn[3 * i], dy = dirn[3 * i + 1], dz = dirn[3 * i + 2];
  const float th = hit ? thit[i] : 0.0f;
  const float px = orig[3 * i] + th * dx;
  const float py = orig[3 * i + 1] + th * dy;
  const float pz = orig[3 * i + 2] + th * dz;
  const long long g = hit ? ti : 0;
  float gx = __ldg(gnorm + 3 * g), gy = __ldg(gnorm + 3 * g + 1),
        gz = __ldg(gnorm + 3 * g + 2);
  const float den = sqrtf(gx * gx + gy * gy + gz * gz) + 1e-30f;
  gx = gx / den;
  gy = gy / den;
  gz = gz / den;
  const bool flip = gx * dx + gy * dy + gz * dz > 0.0f;
  const float nx = flip ? -gx : gx, ny = flip ? -gy : gy,
              nz = flip ? -gz : gz;

  // 2. The two uniforms of ray j.
  const unsigned long long idx = 2ull * (unsigned long long)j;
  const uint32_t w0 = bits_at(k0, k1, idx), w1 = bits_at(k0, k1, idx + 1);
  if (bits_out != nullptr) {
    bits_out[2 * j] = w0;
    bits_out[2 * j + 1] = w1;
  }
  const float u0 = uniform_of(w0);
  const float u1 = uniform_of(w1);

  // 3. cosine_hemisphere about n, with _onb's basis.
  const float r = sqrtf(u0);
  const float phi = kTwoPi * u1;
  const float lx = r * cosf(phi);
  const float ly = r * sinf(phi);
  const float lz = sqrtf(fmaxf(1.0f - u0, 0.0f));
  const float sign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + nz);
  const float b = nx * ny * a;
  const float b1x = 1.0f + sign * nx * nx * a, b1y = sign * b,
              b1z = -sign * nx;
  const float b2x = b, b2y = sign + ny * ny * a, b2z = -ny;
  const float wx = lx * b1x + ly * b2x + lz * nx;
  const float wy = lx * b1y + ly * b2y + lz * ny;
  const float wz = lx * b1z + ly * b2z + lz * nz;

  // 4. Origin, tmin and tmax.
  const float sx = px + nx * eps, sy = py + ny * eps, sz = pz + nz * eps;
  const float tmax = hit ? length : 0.0f;
  o_out[3 * j] = sx;
  o_out[3 * j + 1] = sy;
  o_out[3 * j + 2] = sz;
  d_out[3 * j] = wx;
  d_out[3 * j + 1] = wy;
  d_out[3 * j + 2] = wz;
  tmin_out[j] = 0.0f;
  tmax_out[j] = tmax;

  // 5. The sort key.
  const uint32_t qx = quantize(sx, __ldg(scene_lo), __ldg(scene_hi));
  const uint32_t qy = quantize(sy, __ldg(scene_lo + 1), __ldg(scene_hi + 1));
  const uint32_t qz = quantize(sz, __ldg(scene_lo + 2), __ldg(scene_hi + 2));
  const int oc = (int)((expand_bits(qx) << 2) | (expand_bits(qy) << 1) |
                       expand_bits(qz));
  int key;
  if (direction_major) {
    const float len = fmaxf(sqrtf(wx * wx + wy * wy + wz * wz), 1e-30f);
    const int cx = min(max((int)((wx / len + 1.0f) * 2.0f), 0), 3);
    const int cy = min(max((int)((wy / len + 1.0f) * 2.0f), 0), 3);
    const int cz = min(max((int)((wz / len + 1.0f) * 2.0f), 0), 3);
    int dir6 = 0;
#pragma unroll
    for (int bit = 0; bit < 2; ++bit)
      dir6 |= ((cx >> bit) & 1) << (3 * bit + 2) |
              ((cy >> bit) & 1) << (3 * bit + 1) | ((cz >> bit) & 1) << (3 * bit);
    key = (dir6 << 25) | (oc >> 5);
  } else {
    key = (oc & ~7) | ((wx < 0.0f) * 4 + (wy < 0.0f) * 2 + (wz < 0.0f));
  }
  key_out[j] = tmax <= 0.0f ? kDeadKey : key;
}

}  // namespace

// The rays * samples secondary rays of `rays` primary rays (orig, dirn
// (rays, 3) f32; tri (rays,) i32; t (rays,) f32) over the geometric normals
// gnorm (T, 3) f32 and the scene box lo, hi (3,) f32, under the threefry key
// words (k0, k1): o_out, d_out (rays * samples, 3) f32, tmin_out, tmax_out
// (rays * samples,) f32, key_out (rays * samples,) i32; all contiguous.
// direction_major != 0 gives the diffuse key, 0 the AO key. bits_out,
// where not null, receives each ray's two random words ((rays * samples, 2)
// uint32), for checks; the renderer passes null. Returns a cudaError_t.
extern "C" int ntrace_secondary_rays(
    const void* orig, const void* dirn, const void* tri, const void* t,
    const void* gnorm, const void* lo, const void* hi, uint32_t k0,
    uint32_t k1, long long rays, int samples, float length, float eps,
    int direction_major, void* o_out, void* d_out, void* tmin_out,
    void* tmax_out, void* key_out, void* bits_out, cudaStream_t stream) {
  if (rays < 0 || samples <= 0) return cudaErrorInvalidValue;
  const long long n = rays * samples;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  secondary_rays<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(orig), static_cast<const float*>(dirn),
      static_cast<const int*>(tri), static_cast<const float*>(t),
      static_cast<const float*>(gnorm), static_cast<const float*>(lo),
      static_cast<const float*>(hi), k0, k1, n, samples, length, eps,
      direction_major, static_cast<float*>(o_out), static_cast<float*>(d_out),
      static_cast<float*>(tmin_out), static_cast<float*>(tmax_out),
      static_cast<int*>(key_out), static_cast<uint32_t*>(bits_out));
  return (int)cudaGetLastError();
}
