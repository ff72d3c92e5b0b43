// The node-batch and deferred-leaf packet traversals (packet_bfs.cu,
// packet_dleaf.cu, packet_bdl.cu): one kernel template, the node batch, the
// leaf runs, the run queues and the drains. The schedule, the stack bound
// and the queue bound are argued in ntrace_tpu_torch/trace/packet_batch.py,
// whose torch twin repeats this control flow step for step.
//
// A packet of `rows` warps (rows * 32 consecutive rays, a thread per ray)
// is one block. The reference's packet is rows x 128 TPU lanes that share
// one traversal through scalar SMEM state; here the shared state lives in
// shared memory and one thread writes it:
//   - the packet's direction sums: a __shfl_xor_sync butterfly per warp
//     (lane ^ 16, ^ 8, ^ 4, ^ 2, ^ 1), then the warps' sums one after
//     another, by every thread alike; their signs only order the walk;
//   - node step: threads 0 .. 16 * batch - 1 load the popped records into
//     shared memory; every live ray slab-tests both children of each
//     against its hit t as it stood at the start of the step (the stale t
//     of the reference); __reduce_or_sync gives each warp its wants mask,
//     two bits a node; thread 0 ORs the masks and routes the children
//     serially, in the reference's order: internal ones onto the stack,
//     leaf ones into the step's list of runs (row0, rows, the child bits
//     that select the run);
//   - bfs: every live ray tests every row of every run of the step;
//   - dleaf, bdl: lane 0 of each group's first warp owns the group's queue
//     (shared memory) and its active run (registers): it takes the runs
//     its group wants, in order, and in a drain hands one row to its group
//     through shared memory; a group with nothing queued sits the drain
//     out. `pending` is kept by every thread alike from what the owners
//     publish, so the drain loop's trip count is uniform;
//   - any hit: __syncthreads_and over "holds a hit or is dead" ends the
//     packet.
// Every loop whose trip count comes from shared state (the step loop, the
// drain loop, the run list) reads it after the same barrier in every
// thread, and every barrier is reached by every thread of the block, rays
// past the batch included (the reference's pad rays: orig 0, dirn 1,
// tmin 1, tmax 0, dead).
//
// What bounds it on an H100: the serial parts of a step (thread 0's
// routing of up to 16 children, the owners' queue work) and the barriers
// around them, four to six a step and two a drain, while the other
// threads wait; then the leaf tests of rays that share a packet but not a
// leaf (bfs). A packet reads each node record once for all its rays,
// where the per-ray kernels read it once a ray. Parallel routing and
// fewer barriers are later speed work; this first kernel is plain and
// exact.

#pragma once

#include "trace_common.cuh"

namespace ntrace {
namespace batch {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxRows = 32;          // warps per packet: 1,024 threads
constexpr int kQcap = 96;             // runs per queue (packet_dleaf.py)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(kFull, v, m);
    return v;
}

// The packet's shared state. The queues exist only for the queued
// schedules.
template <int kBatch, bool kQueued, int kStack>
struct Shared {
    int stack[kStack];
    float rec[kBatch][kNodeLanes];        // the popped node records
    unsigned mask[kMaxRows];              // wants by warp, 2 bits a node
    float dsum[kMaxRows][3];
    int sp;                               // the stack's depth
    int lqn;                              // runs of the step
    int lq_row0[2 * kBatch];
    int lq_n[2 * kBatch];
    unsigned lq_bits[2 * kBatch];         // child bits selecting the run
    int2 queue[kQueued ? kMaxRows : 1][kQueued ? kQcap : 1];
    int row[kQueued ? kMaxRows : 1];      // a drain's row by group, or -1
    int added[kQueued ? kMaxRows : 1];    // rows queued by group this step
};

// Appends a leaf run (row0, n rows, selected by child bits) to the step's
// list; a run of no rows tests nothing and is dropped.
template <class S>
__device__ __forceinline__ void add_run(S& sh, int& lqn, bool take,
                                        int row0, int n, unsigned bits) {
    if (take && n > 0) {
        sh.lq_row0[lqn] = row0;
        sh.lq_n[lqn] = n;
        sh.lq_bits[lqn] = bits;
        ++lqn;
    }
}

template <int kBatch, bool kQueued, int kStack, long long kMaxSteps,
          bool kAnyHit>
__global__ void __launch_bounds__(kMaxRows * kWarp) batch_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int rows, int qgroup, int drain_min,
    int merge_sibs, int* __restrict__ out_tri, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ Shared<kBatch, kQueued, kStack> sh;
    const int tid = threadIdx.x;
    const int warp = tid / kWarp;
    const int lane = tid % kWarp;
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + tid;
    const bool present = r < n_rays;

    Ray ray;
    float tx;
    if (present) {
        ray = load_ray(orig, dirn, tmin, static_cast<int>(r));
        tx = tmax[r];
    } else {   // the reference's pad ray (packet_bfs.py:316-321): dead
        ray = Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f,
                  safe_inv(1.0f), safe_inv(1.0f), safe_inv(1.0f), 1.0f};
        tx = 0.0f;
    }
    Hit hit{tx, -1, 0.0f, 0.0f};
    // A dead ray (tmax <= tmin, or NaN) wants no node and tests no row.
    const bool live = hit.t > ray.tn;

    const float sx = warp_sum(ray.dx);
    const float sy = warp_sum(ray.dy);
    const float sz = warp_sum(ray.dz);
    if (lane == 0) {
        sh.dsum[warp][0] = sx;
        sh.dsum[warp][1] = sy;
        sh.dsum[warp][2] = sz;
    }
    if (tid == 0) {
        sh.stack[0] = 0;   // the root
        sh.sp = 1;
    }
    const int group = warp / qgroup;
    const int groups = rows / qgroup;
    const bool owner = kQueued && lane == 0 && warp % qgroup == 0;
    int qn = 0, arow = 0, aleft = 0;   // the owner's queue depth, active run
    __syncthreads();
    float dx = sh.dsum[0][0], dy = sh.dsum[0][1], dz = sh.dsum[0][2];
    for (int w = 1; w < rows; ++w) {
        dx = dx + sh.dsum[w][0];
        dy = dy + sh.dsum[w][1];
        dz = dz + sh.dsum[w][2];
    }
    const int signs = (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0)
                      | (dz >= 0.0f ? 4 : 0);

    long long steps = 0;
    int pending = 0;
    for (;;) {
        const int sp = sh.sp;
        if (!((sp > 0 || pending > 0) && steps < kMaxSteps)) break;
        ++steps;
        // Pop up to kBatch nodes: the top of the stack is slot 0.
        const int nb = min(sp, kBatch);
        for (int t = tid; t < kBatch * kNodeLanes; t += blockDim.x) {
            const int j = t / kNodeLanes;
            float v = 0.0f;
            if (j < nb) {
                const int ref = sh.stack[sp - 1 - j];
                v = __ldg(nodes + static_cast<size_t>(ref / npr) * kRowLanes
                          + kNodeLanes * (ref % npr) + t % kNodeLanes);
            }
            sh.rec[j][t % kNodeLanes] = v;
        }
        __syncthreads();
        unsigned m = 0;
        if (live) {
            for (int j = 0; j < nb; ++j) {
                float b;
                if (slab(sh.rec[j], ray, hit.t, &b)) m |= 1u << (2 * j);
                if (slab(sh.rec[j] + 6, ray, hit.t, &b))
                    m |= 1u << (2 * j + 1);
            }
        }
        m = __reduce_or_sync(kFull, m);
        if (lane == 0) sh.mask[warp] = m;
        __syncthreads();
        if (tid == 0) {
            // Route in reverse pop order: slot 0 (the top) is pushed last
            // and pops first next step.
            unsigned any = 0;
            for (int w = 0; w < rows; ++w) any |= sh.mask[w];
            int spn = sp - nb, lqn = 0;
            for (int j = nb - 1; j >= 0; --j) {
                const float* rc = sh.rec[j];
                const int enc0 = static_cast<int>(rc[12]);
                const int enc1 = static_cast<int>(rc[13]);
                const int c0 = static_cast<int>(rc[14]);
                const int c1 = static_cast<int>(rc[15]);
                const unsigned s0 = 1u << (2 * j), s1 = 1u << (2 * j + 1);
                const bool b0 = (any & s0) != 0, b1 = (any & s1) != 0;
                const bool l0 = b0 && enc0 < 0, l1 = b1 && enc1 < 0;
                if (merge_sibs) {
                    const bool both = l0 && l1
                                      && (-enc1 - 1) == (-enc0 - 1) + c0;
                    add_run(sh, lqn, both, -enc0 - 1, c0 + c1, s0 | s1);
                    add_run(sh, lqn, l0 && !both, -enc0 - 1, c0, s0);
                    add_run(sh, lqn, l1 && !both, -enc1 - 1, c1, s1);
                } else {
                    add_run(sh, lqn, l0, -enc0 - 1, c0, s0);
                    add_run(sh, lqn, l1, -enc1 - 1, c1, s1);
                }
                const bool i0 = b0 && enc0 >= 0, i1 = b1 && enc1 >= 0;
                // Lane 14 of a node whose children are both internal is
                // the order code axis * 2 + (child 0 on the low side).
                bool first0 = true;
                if (enc0 >= 0 && enc1 >= 0) {
                    const int axis = min(max(c0 >> 1, 0), 2);
                    first0 = ((signs >> axis) & 1) == (c0 & 1);
                }
                const int near = first0 ? enc0 : enc1;
                const int far = first0 ? enc1 : enc0;
                if (first0 ? i1 : i0) sh.stack[spn++] = far;
                if (first0 ? i0 : i1) sh.stack[spn++] = near;
            }
            sh.sp = spn;
            sh.lqn = lqn;
        }
        __syncthreads();
        if constexpr (!kQueued) {
            if (live) {
                const int lqn = sh.lqn;
                for (int q = 0; q < lqn; ++q) {
                    const int row0 = sh.lq_row0[q], n = sh.lq_n[q];
                    for (int k = 0; k < n; ++k)
                        test_row(tris, row0 + k, tpr, ray, hit);
                }
            }
        } else {
            if (owner) {
                unsigned gm = 0;
                for (int w = group * qgroup; w < (group + 1) * qgroup; ++w)
                    gm |= sh.mask[w];
                int added = 0;
                const int lqn = sh.lqn;
                for (int q = 0; q < lqn; ++q) {
                    if (gm & sh.lq_bits[q]) {
                        sh.queue[group][qn++] =
                            make_int2(sh.lq_row0[q], sh.lq_n[q]);
                        added += sh.lq_n[q];
                    }
                }
                sh.added[group] = added;
            }
            __syncthreads();
            for (int g = 0; g < groups; ++g) pending += sh.added[g];
            const bool empty = sh.sp == 0;
            while (pending >= drain_min || (empty && pending > 0)) {
                if (owner) {
                    if (aleft == 0 && qn > 0) {
                        const int2 e = sh.queue[group][--qn];
                        arow = e.x;
                        aleft = e.y;
                    }
                    int sel = -1;
                    if (aleft > 0) {
                        sel = arow++;
                        --aleft;
                    }
                    sh.row[group] = sel;
                }
                __syncthreads();
                for (int g = 0; g < groups; ++g) pending -= sh.row[g] >= 0;
                const int row = sh.row[group];
                if (live && row >= 0) test_row(tris, row, tpr, ray, hit);
                __syncthreads();
            }
        }
        if (kAnyHit && __syncthreads_and(hit.id >= 0 || !live)) break;
    }
    if (present) store_hit(hit, static_cast<int>(r), out_tri, out_t, out_u,
                           out_v);
}

// Checks the knobs (rows in [1, 32], qgroup dividing rows, drain_min >= 1)
// and launches one block per packet on `stream`; returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for bad knobs. It does not synchronise and
// allocates nothing.
template <int kBatch, bool kQueued, int kStack, long long kMaxSteps>
int launch(const void* nodes, const void* tris, const void* orig,
           const void* dirn, const void* tmin, const void* tmax, int n_rays,
           int npr, int tpr, int any_hit, int rows, int qgroup,
           int drain_min, int merge_sibs, void* out_tri, void* out_t,
           void* out_u, void* out_v, void* stream) {
    if (rows < 1 || rows > kMaxRows || qgroup < 1 || rows % qgroup
        || drain_min < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rays <= 0) return static_cast<int>(cudaSuccess);
    const int threads = rows * kWarp;
    const dim3 grid(static_cast<unsigned>(
        (static_cast<long long>(n_rays) + threads - 1) / threads));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto go = [&](auto kernel) {
        kernel<<<grid, threads, 0, s>>>(
            static_cast<const float*>(nodes), static_cast<const float*>(tris),
            static_cast<const float*>(orig), static_cast<const float*>(dirn),
            static_cast<const float*>(tmin), static_cast<const float*>(tmax),
            n_rays, npr, tpr, rows, qgroup, drain_min, merge_sibs,
            static_cast<int*>(out_tri), static_cast<float*>(out_t),
            static_cast<float*>(out_u), static_cast<float*>(out_v));
    };
    if (any_hit) {
        go(batch_kernel<kBatch, kQueued, kStack, kMaxSteps, true>);
    } else {
        go(batch_kernel<kBatch, kQueued, kStack, kMaxSteps, false>);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace batch
}  // namespace ntrace
