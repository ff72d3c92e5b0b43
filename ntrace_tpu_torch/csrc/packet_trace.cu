// Closest-hit / any-hit BVH traversal over the lane-packed tables of
// ntrace_tpu/bvh/packed.py, one CUDA thread per ray.
//
// Replaces: ntrace_tpu/trace/packet_pallas.py:_make_kernel, the Pallas TPU
// packet kernel behind trace_packet. It computes the same function, not the
// same schedule. The TPU kernel walks one shared SMEM stack per tile of 1024+
// rays because a TPU has no per-lane gather; a GPU thread gathers freely, so
// here every ray runs its own Aila-Laine while-while loop:
//   inner loop: fetch a node record, slab-test both children against the
//               running hit distance, descend the nearer hit child and push
//               the farther one, pop on a miss; leave when the ray holds a
//               leaf reference (or is done);
//   leaf loop : Moller-Trumbore on every slot of every row the leaf spans,
//               then pop; leave when the ray pops an internal node.
// The stack is per thread: STACK_DEPTH (128) (ref, row count) entries in
// local memory, clamped on overflow exactly as packet_pallas.py:359-361
// clamps its shared stack, with MAX_STEPS as a backstop against malformed
// trees. Any-hit rays stop after the first leaf that accepts a hit.
//
// What bounds it on an H100: latency and divergence of the dependent
// node/row fetches. Each step's address comes from the previous step's
// record, and neighbouring rays of a warp part ways in the tree. The tables
// (17 MB for the conference scene) stay resident in the 50 MB L2, so the
// fetches are L2 hits, not HBM traffic. There is no matrix work and no
// fixed tile to stream, so wgmma and TMA have no place here. Persistent
// threads with dynamic ray fetch (kepler_dynamic_fetch) are the known next
// step; this first kernel is plain and exact.
//
// Numerics: the slab test follows packet_pallas.py:_slab_child (73-96) and
// the triangle test follows packet_pallas.py:186-201, op for op. Build with
// --fmad=false: contracting a*b - c*d into an FMA changes the bits. Never
// build with --use_fast_math (approximate 1/x, flush-to-zero). Float lanes
// that encode integers (child links, row counts, triangle ids) convert by
// truncation, as .astype(int32) does. Acceptance is
//   t < hit_t || (t == hit_t && id < hit_id)
// so the result (lowest id among the closest hits) does not depend on the
// order in which leaves are visited.
//
// Layout (bvh/packed.py:12-37): node i is the 16 floats at
//   nodes[(i / npr) * 128 + 16 * (i % npr)]
//   [c0 lo.x hi.x lo.y hi.y lo.z hi.z | c1 ... | enc0 enc1 cnt0 cnt1]
// enc < 0 is a leaf whose first triangle row is -enc - 1 and whose row
// count is cnt; triangle slot j of row r is the 10 floats at
//   tris[r * 128 + 10 * j] = [v0.xyz e1.xyz e2.xyz tri_id].

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStackDepth = 128;           // packet_pallas.py STACK_DEPTH
constexpr long long kMaxSteps = 4000000;   // packet_pallas.py MAX_STEPS
constexpr int kRowLanes = 128;
constexpr int kNodeLanes = 16;
constexpr int kTriLanes = 10;
constexpr int kDone = INT_MIN;             // no node left to visit
constexpr int kBlock = 128;

struct Ref {
    int ref;   // >= 0 internal node, < 0 leaf (-first_row - 1), kDone
    int cnt;   // leaf row count (meaningless for internal nodes)
};

// ops/aabb.py safe_inv_dir: 1 / (|d| > 2^-80 ? d : copysign(2^-80, d)).
__device__ __forceinline__ float safe_inv(float d) {
    const float ooeps = __int_as_float(47 << 23);   // 2^-80
    const float g = fabsf(d) > ooeps ? d : (d >= 0.0f ? ooeps : -ooeps);
    return 1.0f / g;
}

// packet_pallas.py:_slab_child. fminf/fmaxf drop NaN like jnp.fmin/fmax;
// entry is clamped to tmin, exit to the running hit distance.
__device__ __forceinline__ bool slab(const float* b, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float tmin, float tmax, float* begin) {
    const float tlo_x = (b[0] - ox) * ix;
    const float thi_x = (b[1] - ox) * ix;
    const float tlo_y = (b[2] - oy) * iy;
    const float thi_y = (b[3] - oy) * iy;
    const float tlo_z = (b[4] - oz) * iz;
    const float thi_z = (b[5] - oz) * iz;
    const float t0 = fmaxf(fmaxf(fminf(tlo_x, thi_x), fminf(tlo_y, thi_y)),
                           fmaxf(fminf(tlo_z, thi_z), tmin));
    const float t1 = fminf(fminf(fmaxf(tlo_x, thi_x), fmaxf(tlo_y, thi_y)),
                           fminf(fmaxf(tlo_z, thi_z), tmax));
    *begin = t0;
    return t0 <= t1;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) packet_trace_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;   // no padding rays: the ragged edge is masked

    const float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
    const float dx = dirn[3 * r], dy = dirn[3 * r + 1], dz = dirn[3 * r + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const float tn = tmin[r];
    float hit_t = tmax[r];
    int hit_id = -1;
    float hit_u = 0.0f, hit_v = 0.0f;

    Ref stack[kStackDepth];
    int sp = 0;
    // A dead ray (tmax <= tmin, or NaN) can accept no hit: skip the walk.
    int ref = hit_t > tn ? 0 : kDone;
    int cnt = 0;
    long long steps = 0;

    while (ref != kDone) {
        while (ref >= 0) {
            if (steps == kMaxSteps) { ref = kDone; break; }
            ++steps;
            const float4* rec4 = reinterpret_cast<const float4*>(
                nodes + static_cast<size_t>(ref / npr) * kRowLanes
                + kNodeLanes * (ref % npr));
            float rec[kNodeLanes];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 w = __ldg(rec4 + q);
                rec[4 * q] = w.x;
                rec[4 * q + 1] = w.y;
                rec[4 * q + 2] = w.z;
                rec[4 * q + 3] = w.w;
            }
            float b0, b1;
            const bool h0 = slab(rec, ox, oy, oz, ix, iy, iz, tn, hit_t, &b0);
            const bool h1 = slab(rec + 6, ox, oy, oz, ix, iy, iz, tn, hit_t,
                                 &b1);
            const Ref c0{static_cast<int>(rec[12]), static_cast<int>(rec[14])};
            const Ref c1{static_cast<int>(rec[13]), static_cast<int>(rec[15])};
            Ref next;
            if (h0 && h1) {
                // Near child first; a tie goes to child 0.
                const bool first0 = b0 <= b1;
                stack[min(sp, kStackDepth - 1)] = first0 ? c1 : c0;
                sp = min(sp + 1, kStackDepth);
                next = first0 ? c0 : c1;
            } else if (h0) {
                next = c0;
            } else if (h1) {
                next = c1;
            } else if (sp > 0) {
                next = stack[--sp];
            } else {
                next = Ref{kDone, 0};
            }
            ref = next.ref;
            cnt = next.cnt;
        }
        while (ref < 0 && ref != kDone) {
            if (steps == kMaxSteps) { ref = kDone; break; }
            ++steps;
            const int row0 = -ref - 1;
            for (int k = 0; k < cnt; ++k) {
                const float* row =
                    tris + static_cast<size_t>(row0 + k) * kRowLanes;
                for (int j = 0; j < tpr; ++j) {
                    const float* s = row + kTriLanes * j;
                    const float v0x = __ldg(s + 0), v0y = __ldg(s + 1),
                                v0z = __ldg(s + 2);
                    const float e1x = __ldg(s + 3), e1y = __ldg(s + 4),
                                e1z = __ldg(s + 5);
                    const float e2x = __ldg(s + 6), e2y = __ldg(s + 7),
                                e2z = __ldg(s + 8);
                    const int tid = static_cast<int>(__ldg(s + 9));
                    const float px = dy * e2z - dz * e2y;
                    const float py = dz * e2x - dx * e2z;
                    const float pz = dx * e2y - dy * e2x;
                    const float det = e1x * px + e1y * py + e1z * pz;
                    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
                    const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
                    const float u = (tvx * px + tvy * py + tvz * pz) * inv;
                    const float qx = tvy * e1z - tvz * e1y;
                    const float qy = tvz * e1x - tvx * e1z;
                    const float qz = tvx * e1y - tvy * e1x;
                    const float v = (dx * qx + dy * qy + dz * qz) * inv;
                    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
                    const bool valid = det != 0.0f && tid >= 0 && u >= 0.0f
                                       && v >= 0.0f && u + v <= 1.0f
                                       && t > tn;
                    if (valid && (t < hit_t || (t == hit_t && tid < hit_id))) {
                        hit_t = t;
                        hit_id = tid;
                        hit_u = u;
                        hit_v = v;
                    }
                }
            }
            if (kAnyHit && hit_id >= 0) { ref = kDone; break; }
            if (sp > 0) {
                const Ref next = stack[--sp];
                ref = next.ref;
                cnt = next.cnt;
            } else {
                ref = kDone;
            }
        }
    }
    // Miss convention of the reference: tri -1, t = tmax, u = v = 0.
    out_tri[r] = hit_id;
    out_t[r] = hit_t;
    out_u[r] = hit_u;
    out_v[r] = hit_v;
}

}  // namespace

// C entry point, bound with ctypes (ntrace_tpu_torch/kernels/build.py).
// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess). It does not synchronise and allocates nothing.
extern "C" int ntrace_packet_trace(const void* nodes, const void* tris,
                                   const void* orig, const void* dirn,
                                   const void* tmin, const void* tmax,
                                   int n_rays, int nodes_per_row,
                                   int tris_per_row, int any_hit,
                                   void* out_tri, void* out_t, void* out_u,
                                   void* out_v, void* stream) {
    if (n_rays <= 0) return static_cast<int>(cudaSuccess);
    const dim3 grid((n_rays + kBlock - 1) / kBlock);
    const dim3 block(kBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* n8 = static_cast<const float*>(nodes);
    const float* t12 = static_cast<const float*>(tris);
    const float* o = static_cast<const float*>(orig);
    const float* d = static_cast<const float*>(dirn);
    const float* tn = static_cast<const float*>(tmin);
    const float* tx = static_cast<const float*>(tmax);
    int* tri = static_cast<int*>(out_tri);
    float* t = static_cast<float*>(out_t);
    float* u = static_cast<float*>(out_u);
    float* v = static_cast<float*>(out_v);
    if (any_hit) {
        packet_trace_kernel<true><<<grid, block, 0, s>>>(
            n8, t12, o, d, tn, tx, n_rays, nodes_per_row, tris_per_row, tri,
            t, u, v);
    } else {
        packet_trace_kernel<false><<<grid, block, 0, s>>>(
            n8, t12, o, d, tn, tx, n_rays, nodes_per_row, tris_per_row, tri,
            t, u, v);
    }
    return static_cast<int>(cudaGetLastError());
}
