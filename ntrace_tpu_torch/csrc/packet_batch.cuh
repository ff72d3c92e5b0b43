// The node-batch and deferred-leaf packet traversals (packet_bfs.cu,
// packet_dleaf.cu, packet_bdl.cu): one kernel template, the node batch, the
// leaf runs, the run queues and the drains. The schedule, the stack bound
// and the queue bound are argued in ntrace_tpu_torch/trace/packet_batch.py,
// whose torch twin repeats this control flow step for step.
//
// A packet of `rows` warps (rows * 32 consecutive rays, a thread per ray)
// is one block. The reference's packet is rows x 128 TPU lanes that share
// one traversal through scalar SMEM state; here the shared state lives in
// shared memory laid out at launch for the launch's warps, queues and
// stack depth (`carve`), and warp 0 writes it. A step has two block
// barriers:
//   - each warp holds its own copy of the popped records (up to `batch`
//     nodes, the top of the stack first), staged by cp.async during the
//     last step's leaf tests; every live ray slab-tests both children of
//     each against its hit t as it stood at the start of the step (the
//     stale t of the reference), and __reduce_or_sync gives the warp its
//     wants mask, two bits a node, which lane 0 publishes;
//   - barrier A; in any-hit mode it is __syncthreads_and over "holds a hit
//     or is dead", which ends the packet (the hits are those after the
//     last step's leaf tests, so it stops after the same leaf work as a
//     test at the end of that step);
//   - warp 0 routes the children in parallel: lane k owns child k of the
//     batch, and ballots with __popc prefix counts give each hit internal
//     child its stack slot and each hit leaf its run slot, in the
//     reference's serial order (reverse pop order: the top of the stack
//     is routed last; runs of a node in child order, two contiguous leaf
//     siblings as one run with merge_sibs; far internal child before
//     near, near by the pack-time order code in lane 14 against the signs
//     of the packet's direction sums). dleaf and bdl: lane g puts the runs
//     group g wants on the group's queue, in order, and the warp works
//     out the step's drain count D in closed form from the groups' rows
//     left R_g: the first i at which sum_g max(R_g - i, 0) falls below
//     drain_min, or below 1 once the stack is empty (the drain loop of the
//     reference run to its end); it publishes where each group's drains
//     start and how many rows, min(R_g, D), it tests, and keeps each
//     group's queue state after them in lane g;
//   - barrier B;
//   - each warp starts the copy of the next step's records, then tests its
//     rows with no block barrier: bfs, the rows of the step's runs that
//     its own wants mask selects (closest hits and any-hit tri >= 0 are
//     those of the whole-packet rule: the slab test is conservative at
//     the stale t, so each ray still tests the leaf whose box holds its
//     hit; which triangle an any-hit ray holds when the packet stops can
//     differ, since a spatial split references a triangle from several
//     leaves, each box clipped); dleaf and bdl, the first
//     min(R_g, D) rows of its group: the active run's, then the queue's
//     from the top. Rows stream through three buffers a warp by cp.async,
//     row i + 1 in flight while row i is tested (test_row_shared), and
//     one __syncwarp a row orders them.
// Every loop whose trip count comes from shared state (the step loop, the
// runs, the drain rows) reads it after barrier B in every thread; warp 0
// writes that state only between barriers A and B; and every barrier is
// reached by every thread of the block, rays past the batch included (the
// reference's pad rays: orig 0, dirn 1, tmin 1, tmax 0, dead).
//
// What bounds it on an H100: on incoherent rays, the leaf tests of rays
// that share a warp (bfs) or a group (dleaf, bdl) but not a leaf; on every
// batch, the chain of steps a packet walks, each one routing by warp 0
// between two barriers while the other warps wait. A packet reads each
// node record once a warp, where the per-ray kernels read it once a ray.

#pragma once

#include "trace_common.cuh"

namespace ntrace {
namespace batch {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxRows = 32;          // warps per packet: 1,024 threads
constexpr int kQcap = 96;             // runs per queue (packet_dleaf.py)
constexpr int kRowBufs = 3;           // a warp's staged rows: tested, in
                                      // flight, free
constexpr int kRowChunks = kRowLanes / 4;   // 16-byte chunks of a row
enum Scalar { kSp, kLqn, kPending, kScalars };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(kFull, v, m);
    return v;
}

// The packet's shared state, carved out of the block's dynamic shared
// memory (`carve`).
struct Shared {
    float4* rec;          // [rows][4 * batch] each warp's popped records
    float4* rowbuf;       // [rows][kRowBufs][kRowChunks] each warp's rows
    int2* queue;          // [groups][kQcap] runs (first row, rows); queued
    int* stack;           // [stack]
    unsigned* mask;       // [rows] wants by warp, 2 bits a node
    float* dsum;          // [rows][3]
    int* lq_row0;         // [2 * batch] the step's runs
    int* lq_n;
    unsigned* lq_bits;    // child bits selecting the run
    int* drain;           // [4][groups] where a group's drains start (active
                          // run's next row, rows left in it, queue depth)
                          // and the rows it tests; queued
    int* scal;            // [kScalars]
};

__host__ __device__ inline char* bump(char* base, size_t* off,
                                      size_t bytes) {
    char* p = base == nullptr ? nullptr : base + *off;
    *off += (bytes + 15) / 16 * 16;
    return p;
}

// Lays `sh` out from `base` for `rows` warps, `groups` queues and a stack
// of `stack` entries, each part 16-byte aligned (base == nullptr: sizes
// only). Returns the bytes it takes.
template <int kBatch, bool kQueued>
__host__ __device__ inline size_t carve(char* base, int rows, int groups,
                                        int stack, Shared* sh) {
    size_t off = 0;
    sh->rec = reinterpret_cast<float4*>(
        bump(base, &off, sizeof(float4) * rows * 4 * kBatch));
    sh->rowbuf = reinterpret_cast<float4*>(
        bump(base, &off, sizeof(float4) * rows * kRowBufs * kRowChunks));
    sh->queue = reinterpret_cast<int2*>(
        bump(base, &off, kQueued ? sizeof(int2) * groups * kQcap : 0));
    sh->stack = reinterpret_cast<int*>(bump(base, &off, sizeof(int) * stack));
    sh->mask = reinterpret_cast<unsigned*>(
        bump(base, &off, sizeof(unsigned) * rows));
    sh->dsum = reinterpret_cast<float*>(bump(base, &off,
                                             sizeof(float) * 3 * rows));
    sh->lq_row0 = reinterpret_cast<int*>(
        bump(base, &off, sizeof(int) * 2 * kBatch));
    sh->lq_n = reinterpret_cast<int*>(bump(base, &off,
                                           sizeof(int) * 2 * kBatch));
    sh->lq_bits = reinterpret_cast<unsigned*>(
        bump(base, &off, sizeof(unsigned) * 2 * kBatch));
    sh->drain = reinterpret_cast<int*>(
        bump(base, &off, kQueued ? sizeof(int) * 4 * groups : 0));
    sh->scal = reinterpret_cast<int*>(bump(base, &off,
                                           sizeof(int) * kScalars));
    return off;
}

// Starts the copy of the top min(sp, kBatch) records of the stack into the
// warp's `rec` (lane l: 16-byte chunk l % 4 of record l / 4); one commit
// group.
template <int kBatch>
__device__ __forceinline__ void fetch_records(float4* rec,
                                              const float* nodes, int npr,
                                              const int* stack, int sp,
                                              int lane) {
    if (lane < 4 * min(sp, kBatch)) {
        const int ref = stack[sp - 1 - (lane >> 2)];
        cp_async16(rec + lane, nodes + static_cast<size_t>(ref / npr)
                                   * kRowLanes + kNodeLanes * (ref % npr)
                                   + 4 * (lane & 3));
    }
    commit_async();
}

// bfs: the step's runs that the warp's wants mask selects, in order.
struct WantedRuns {
    const Shared& sh;
    unsigned wants;
    int lqn, q;
    __device__ __forceinline__ bool next(int2* run) {
        for (; q < lqn; ++q) {
            if (wants & sh.lq_bits[q]) {
                *run = make_int2(sh.lq_row0[q], sh.lq_n[q]);
                ++q;
                return true;
            }
        }
        return false;
    }
};

// dleaf, bdl: a group's drain rows: its active run, then its queue from
// the top.
struct DrainRuns {
    const int2* queue;
    int2 active;
    int qn;
    bool started;
    __device__ __forceinline__ bool next(int2* run) {
        if (!started) {
            started = true;
            *run = active;
            return true;
        }
        if (qn == 0) return false;
        *run = queue[--qn];
        return true;
    }
};

// Tests up to `limit` rows that `runs` hands out, run after run, against
// the lane's ray (a dead ray tests none), streamed through the warp's
// three row buffers `buf`: row i + 1 is in flight while row i is tested.
// The (t, id) fold makes the order free.
template <class Runs>
__device__ __forceinline__ void test_rows(Runs runs, int limit, float4* buf,
                                          const float* __restrict__ tris,
                                          int tpr, int chunks, int lane,
                                          bool live, const Ray& ray,
                                          Hit& hit) {
    int row = 0, left = 0;
    auto next = [&]() {
        if (limit == 0) return -1;
        while (left == 0) {
            int2 run;
            if (!runs.next(&run)) return -1;
            row = run.x;
            left = run.y;
        }
        --left;
        --limit;
        return row++;
    };
    int cur = next();
    if (cur < 0) return;
    fetch_row(buf, tris, cur, chunks, lane);
    for (int b = 0;;) {   // the buffer of the row tested now
        const int nxt = next();
        const int b1 = b == kRowBufs - 1 ? 0 : b + 1;
        if (nxt >= 0) {
            // Buffer b1 was last read two rows ago, before the last row's
            // __syncwarp.
            fetch_row(buf + b1 * kRowChunks, tris, nxt, chunks, lane);
            wait_async<1>();
        } else {
            wait_async<0>();
        }
        __syncwarp();   // every lane's chunks of this row landed
        if (live) {
            test_row_shared(reinterpret_cast<const float*>(
                                buf + b * kRowChunks),
                            tpr, ray, hit);
        }
        if (nxt < 0) break;
        b = b1;
    }
}

// Warp 0, between barriers A and B. Routes the popped batch of `sp`'s top
// (lane k: child k), publishes the new stack depth and the step's runs;
// dleaf and bdl: queues the runs by group (lane g: group g, whose queue
// depth, active run and rows left it keeps in qn, arow, aleft and left),
// works out the drain count and publishes where each group's drains
// start, the rows each tests and the rows still pending after them.
template <int kBatch, bool kQueued>
__device__ __forceinline__ void route(const Shared& sh, const float* rc,
                                      int lane, int sp, int rows,
                                      int groups, int qgroup, int drain_min,
                                      int merge_sibs, int signs, int& qn,
                                      int& arow, int& aleft, int& left) {
    const int nb = min(sp, kBatch);
    const unsigned any = __reduce_or_sync(kFull,
                                          lane < rows ? sh.mask[lane] : 0u);
    const int j = lane >> 1, c = lane & 1;
    bool run = false, push = false, is_near = false;
    int row0 = 0, n = 0, child = 0;
    unsigned bits = 0;
    if (lane < 2 * nb) {
        const float* r = rc + kNodeLanes * j;
        const int enc0 = static_cast<int>(r[12]);
        const int enc1 = static_cast<int>(r[13]);
        const int c0 = static_cast<int>(r[14]);
        const int c1 = static_cast<int>(r[15]);
        const unsigned s0 = 1u << (2 * j), s1 = 2u << (2 * j);
        const bool b0 = (any & s0) != 0, b1 = (any & s1) != 0;
        const bool l0 = b0 && enc0 < 0, l1 = b1 && enc1 < 0;
        const bool both = merge_sibs && l0 && l1
                          && (-enc1 - 1) == (-enc0 - 1) + c0;
        if (c == 0) {   // the merged run, or child 0's alone
            run = l0;
            row0 = -enc0 - 1;
            n = both ? c0 + c1 : c0;
            bits = both ? (s0 | s1) : s0;
        } else {
            run = l1 && !both;
            row0 = -enc1 - 1;
            n = c1;
            bits = s1;
        }
        run = run && n > 0;   // a run of no rows is dropped
        bool first0 = true;   // child 0 is the near one
        if (enc0 >= 0 && enc1 >= 0) {
            const int axis = min(max(c0 >> 1, 0), 2);
            first0 = ((signs >> axis) & 1) == (c0 & 1);
        }
        child = c ? enc1 : enc0;
        push = (c ? b1 : b0) && child >= 0;
        is_near = first0 == (c == 0);
    }
    const unsigned runs = __ballot_sync(kFull, run);
    const unsigned pushes = __ballot_sync(kFull, push);
    // Lanes 2j + 2 and up hold the slots routed before slot j.
    if (run) {
        const int q = __popc(runs >> (2 * j + 2))
                      + (c ? static_cast<int>((runs >> (lane - 1)) & 1u) : 0);
        sh.lq_row0[q] = row0;
        sh.lq_n[q] = n;
        sh.lq_bits[q] = bits;
    }
    if (push) {   // far first, then near
        const int q = __popc(pushes >> (2 * j + 2))
                      + (is_near ? static_cast<int>(
                                       (pushes >> (lane ^ 1)) & 1u) : 0);
        sh.stack[sp - nb + q] = child;
    }
    const int spn = sp - nb + __popc(pushes);
    const int lqn = __popc(runs);
    if (lane == 0) {
        sh.scal[kSp] = spn;
        sh.scal[kLqn] = lqn;
    }
    if constexpr (kQueued) {
        __syncwarp();   // the step's runs
        if (lane < groups) {
            unsigned gm = 0;
            for (int w = lane * qgroup; w < (lane + 1) * qgroup; ++w)
                gm |= sh.mask[w];
            int2* queue = sh.queue + lane * kQcap;
            for (int q = 0; q < lqn; ++q) {
                if (gm & sh.lq_bits[q]) {
                    queue[qn++] = make_int2(sh.lq_row0[q], sh.lq_n[q]);
                    left += sh.lq_n[q];
                }
            }
        }
        // The drain count: the least i with sum_g max(left_g - i, 0) <
        // thr. Each drain takes one row from every group with rows left,
        // and the sum is 0 once i reaches the largest left_g.
        const int thr = spn == 0 ? 1 : drain_min;
        int drains = 0;
        for (int p = __reduce_add_sync(kFull, left); p >= thr; ++drains)
            p -= __popc(__ballot_sync(kFull, left > drains));
        const int k = min(left, drains);
        if (lane < groups) {
            sh.drain[lane] = arow;
            sh.drain[groups + lane] = aleft;
            sh.drain[2 * groups + lane] = qn;
            sh.drain[3 * groups + lane] = k;
            // The group's state after its k rows: the last run touched is
            // the active run, the runs above it in the queue are gone.
            int rest = k, t = min(aleft, rest);
            arow += t;
            aleft -= t;
            rest -= t;
            while (rest > 0) {
                const int2 e = sh.queue[lane * kQcap + --qn];
                t = min(e.y, rest);
                arow = e.x + t;
                aleft = e.y - t;
                rest -= t;
            }
            left -= k;
        }
        const int pending = __reduce_add_sync(kFull, left);
        if (lane == 0) sh.scal[kPending] = pending;
    }
}

template <int kBatch, bool kQueued, long long kMaxSteps, bool kAnyHit>
__global__ void __launch_bounds__(kMaxRows * kWarp) batch_kernel(
    const float* __restrict__ nodes, const float* __restrict__ tris,
    const float* __restrict__ orig, const float* __restrict__ dirn,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    int n_rays, int npr, int tpr, int rows, int qgroup, int drain_min,
    int merge_sibs, int stack, int* __restrict__ out_tri,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
    extern __shared__ float4 smem[];
    const int groups = rows / qgroup;
    Shared sh;
    carve<kBatch, kQueued>(reinterpret_cast<char*>(smem), rows, groups,
                           stack, &sh);
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
        sh.dsum[3 * warp] = sx;
        sh.dsum[3 * warp + 1] = sy;
        sh.dsum[3 * warp + 2] = sz;
    }
    if (tid == 0) {
        sh.stack[0] = 0;   // the root
        sh.scal[kSp] = 1;
        sh.scal[kPending] = 0;
    }
    const int group = warp / qgroup;
    const int chunks = (kTriLanes * tpr + 3) / 4;
    float4* rec = sh.rec + warp * 4 * kBatch;
    float4* rowbuf = sh.rowbuf + warp * kRowBufs * kRowChunks;
    // Warp 0, lane g < groups: group g's queue depth, active run and rows
    // left.
    int qn = 0, arow = 0, aleft = 0, left = 0;
    __syncthreads();
    float dx = sh.dsum[0], dy = sh.dsum[1], dz = sh.dsum[2];
    for (int w = 1; w < rows; ++w) {
        dx = dx + sh.dsum[3 * w];
        dy = dy + sh.dsum[3 * w + 1];
        dz = dz + sh.dsum[3 * w + 2];
    }
    const int signs = (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0)
                      | (dz >= 0.0f ? 4 : 0);
    fetch_records<kBatch>(rec, nodes, npr, sh.stack, 1, lane);

    long long steps = 0;
    for (;;) {
        const int sp = sh.scal[kSp];
        if (!((sp > 0 || sh.scal[kPending] > 0) && steps < kMaxSteps)) break;
        ++steps;
        // Pop up to kBatch nodes: the top of the stack is slot 0.
        const int nb = min(sp, kBatch);
        wait_async<0>();
        __syncwarp();   // the warp's copy of the popped records landed
        const float* rc = reinterpret_cast<const float*>(rec);
        unsigned m = 0;
        if (live) {
            for (int j = 0; j < nb; ++j) {
                float b;
                if (slab(rc + kNodeLanes * j, ray, hit.t, &b))
                    m |= 1u << (2 * j);
                if (slab(rc + kNodeLanes * j + 6, ray, hit.t, &b))
                    m |= 1u << (2 * j + 1);
            }
        }
        const unsigned wants = __reduce_or_sync(kFull, m);
        if (lane == 0) sh.mask[warp] = wants;
        if constexpr (kAnyHit) {   // barrier A
            if (__syncthreads_and(hit.id >= 0 || !live)) break;
        } else {
            __syncthreads();
        }
        if (warp == 0) {
            route<kBatch, kQueued>(sh, rc, lane, sp, rows, groups, qgroup,
                                   drain_min, merge_sibs, signs, qn, arow,
                                   aleft, left);
        }
        __syncthreads();   // barrier B
        fetch_records<kBatch>(rec, nodes, npr, sh.stack, sh.scal[kSp], lane);
        if constexpr (!kQueued) {
            test_rows(WantedRuns{sh, wants, sh.scal[kLqn], 0}, INT_MAX,
                      rowbuf, tris, tpr, chunks, lane, live, ray, hit);
        } else {
            const int* d = sh.drain + group;
            test_rows(DrainRuns{sh.queue + group * kQcap,
                                make_int2(d[0], d[groups]), d[2 * groups],
                                false},
                      d[3 * groups], rowbuf, tris, tpr, chunks, lane, live,
                      ray, hit);
        }
    }
    wait_async<0>();   // nothing in flight past the packet
    if (present) store_hit(hit, static_cast<int>(r), out_tri, out_t, out_u,
                           out_v);
}

// The knobs a kernel takes: rows in [1, 32], qgroup dividing rows,
// drain_min >= 1, a stack of 1 to kStack entries.
inline bool knobs_ok(int rows, int qgroup, int drain_min, int stack,
                     int max_stack) {
    return rows >= 1 && rows <= kMaxRows && qgroup >= 1 && rows % qgroup == 0
           && drain_min >= 1 && stack >= 1 && stack <= max_stack;
}

// Dynamic shared memory of a launch.
template <int kBatch, bool kQueued>
size_t shared_bytes(int rows, int qgroup, int stack) {
    Shared none;
    return carve<kBatch, kQueued>(nullptr, rows, rows / qgroup, stack,
                                  &none);
}

// Checks the knobs and launches one block per packet on `stream`, with
// `stack` entries of stack (the wrapper's Schedule.stack_need); returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for bad knobs. It does not synchronise and
// allocates nothing.
template <int kBatch, bool kQueued, int kStack, long long kMaxSteps>
int launch(const void* nodes, const void* tris, const void* orig,
           const void* dirn, const void* tmin, const void* tmax, int n_rays,
           int npr, int tpr, int any_hit, int rows, int qgroup,
           int drain_min, int merge_sibs, int stack, void* out_tri,
           void* out_t, void* out_u, void* out_v, void* stream) {
    if (!knobs_ok(rows, qgroup, drain_min, stack, kStack))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rays <= 0) return static_cast<int>(cudaSuccess);
    const int threads = rows * kWarp;
    const dim3 grid(static_cast<unsigned>(
        (static_cast<long long>(n_rays) + threads - 1) / threads));
    const size_t smem = shared_bytes<kBatch, kQueued>(rows, qgroup, stack);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto go = [&](auto kernel) {
        // Past 48 KB a block's dynamic shared memory needs the opt-in.
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
        kernel<<<grid, threads, smem, s>>>(
            static_cast<const float*>(nodes), static_cast<const float*>(tris),
            static_cast<const float*>(orig), static_cast<const float*>(dirn),
            static_cast<const float*>(tmin), static_cast<const float*>(tmax),
            n_rays, npr, tpr, rows, qgroup, drain_min, merge_sibs, stack,
            static_cast<int*>(out_tri), static_cast<float*>(out_t),
            static_cast<float*>(out_u), static_cast<float*>(out_v));
    };
    if (any_hit) {
        go(batch_kernel<kBatch, kQueued, kMaxSteps, true>);
    } else {
        go(batch_kernel<kBatch, kQueued, kMaxSteps, false>);
    }
    return static_cast<int>(cudaGetLastError());
}

// What a launch with these knobs would run: out[0] registers a thread,
// out[1] shared memory a block (static and dynamic, bytes), out[2]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns a CUDA error code (0 = cudaSuccess).
template <int kBatch, bool kQueued, int kStack, long long kMaxSteps>
int occupancy(int any_hit, int rows, int qgroup, int stack, int* out) {
    if (!knobs_ok(rows, qgroup, 1, stack, kStack))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = shared_bytes<kBatch, kQueued>(rows, qgroup, stack);
    auto get = [&](auto kernel) {
        cudaFuncAttributes a{};
        cudaError_t e = cudaFuncGetAttributes(&a, kernel);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
        int blocks = 0;
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, kernel, rows * kWarp, smem);
        out[0] = a.numRegs;
        out[1] = static_cast<int>(a.sharedSizeBytes + smem);
        out[2] = blocks;
        return static_cast<int>(e);
    };
    return any_hit ? get(batch_kernel<kBatch, kQueued, kMaxSteps, true>)
                   : get(batch_kernel<kBatch, kQueued, kMaxSteps, false>);
}

}  // namespace batch
}  // namespace ntrace
