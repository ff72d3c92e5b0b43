"""Time the while-while kernels (packet_ww, packet_pipe) of this checkout
against other builds of their sources, on one card.

The builds: this checkout's `csrc/packet_ww.cu` and `csrc/packet_pipe.cu`
("change"); the same with a step of the redesign taken out again by text
patches (ABLATIONS, from chip_smoke.py: the node loop paused at 30 runs,
pipe's three records fetched before the slab tests, and every step out,
which is the parent's schedule that phases 9 and 11 count any-hit
triangles against); the same with a step that was tried and dropped put
in (TRIED: the two-run queue in registers, pipe's leaf loop prefetching
the next row into L1, pipe capped at 64 registers, and ww with persistent
warps that fetch 32-ray batches from a global counter); the change built
again, for the spread of identical builds; and, with --parent, the
sources of another checkout (`DIR` holds its `packet_ww.cu`,
`packet_pipe.cu` and `trace_common.cuh`). Each build is compiled with
kernels/build.py's flags, one nvcc a source, all at once.

The batches are the ones `chip_smoke.py` phases 9 and 11 time: conference
(297,024 triangles, binned SAH) primary 1024x768 and the shadow, AO and
diffuse passes of `render()` through the packet kernel, on the renderer's
tables. Every build's hits must equal the change's on every ray: closest
hits tri/t/u/v bit for bit, any hits tri >= 0; which triangle an any-hit
ray holds is logged where it differs (the visiting order changed), and
the parent's schedule rebuilt by patches must hold the parent's triangle
on every any-hit ray. Times are CUDA events, the builds in turns
(A B C ... C B A, `--rounds` times), `--calls` calls a turn, medians
over every turn. It logs each build's ptxas registers, stack frame and
spills, and writes everything to --out as JSON. Exits 1 if a build's hits
differ. Needs a CUDA device:

    python3 scripts/ww_ab.py --parent PARENT/ntrace_tpu_torch/csrc
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig,  # noqa: E402
                                   default_camera, get_scene)
from ntrace_tpu_torch.kernels import build as kbuild  # noqa: E402
from ntrace_tpu_torch.ray import raygen  # noqa: E402
from ntrace_tpu_torch.ray.pixeltable import pixel_table  # noqa: E402
from ntrace_tpu_torch.render.renderer import (Renderer,  # noqa: E402
                                              build_accel)
from ntrace_tpu_torch.trace.packet_pipe import trace_packet_pipe  # noqa: E402
from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww  # noqa: E402
from ntrace_tpu_torch.utils.timing import cuda_ms  # noqa: E402

KERNELS = {"packet_ww": trace_packet_ww, "packet_pipe": trace_packet_pipe}
BOTH = ("packet_ww.cu", "packet_pipe.cu")
ABLATIONS = {
    "no step 1 (pause at 30 runs)": {src: cs.PAUSE_AT_30 for src in BOTH},
    "no step 3 (pipe: three records)": {
        "packet_pipe.cu": cs.THREE_RECORDS},
    "every step out (the parent's schedule)": cs.PARENT_SCHEDULE,
}
# Step 4: ww's warps take 32-ray batches from a global counter, as many
# warps as stay resident (chip_smoke.py PERSISTENT_PATCH made packet_wide
# so); a warp traces its 32 consecutive rays, so every ray's visiting
# order, and so its result, is the one-thread-a-ray launch's.
PERSISTENT_WW = (
    ("template <bool kAnyHit>\n__global__ void __launch_bounds__(kBlock) "
     "packet_ww_kernel(",
     "__device__ int g_next_warp;\n\n"
     "template <bool kAnyHit>\n__global__ void __launch_bounds__(kBlock) "
     "packet_ww_kernel("),
    ("""    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;
    trace_ray<kAnyHit>(nodes, tris, orig, dirn, tmin, tmax, r, npr, tpr,
                       out_tri, out_t, out_u, out_v);
""", """    const int lane = threadIdx.x & 31;
    for (;;) {
        int w = 0;
        if (lane == 0) w = atomicAdd(&g_next_warp, 1);
        w = __shfl_sync(0xffffffffu, w, 0);
        if (w >= (n_rays + 31) / 32) break;
        const int r = w * 32 + lane;
        if (r < n_rays) {
            trace_ray<kAnyHit>(nodes, tris, orig, dirn, tmin, tmax, r, npr,
                               tpr, out_tri, out_t, out_u, out_v);
        }
    }
"""),
    ("NTRACE_TRAVERSAL_ENTRY(ntrace_packet_ww, packet_ww_kernel)\n",
     """extern "C" int ntrace_packet_ww(const void* nodes, const void* tris,
                                const void* orig, const void* dirn,
                                const void* tmin, const void* tmax,
                                int n_rays, int nodes_per_row,
                                int tris_per_row, int any_hit, void* out_tri,
                                void* out_t, void* out_u, void* out_v,
                                void* stream) {
    if (n_rays <= 0) return static_cast<int>(cudaSuccess);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto kernel) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      ntrace::kBlock, 0);
        const int blocks = (n_rays + ntrace::kBlock - 1) / ntrace::kBlock;
        const int grid = blocks < sms * per_sm ? blocks : sms * per_sm;
        void* next = nullptr;
        cudaGetSymbolAddress(&next, g_next_warp);
        cudaMemsetAsync(next, 0, sizeof(int), s);
        kernel<<<grid, ntrace::kBlock, 0, s>>>(
            static_cast<const float*>(nodes), static_cast<const float*>(tris),
            static_cast<const float*>(orig), static_cast<const float*>(dirn),
            static_cast<const float*>(tmin), static_cast<const float*>(tmax),
            n_rays, nodes_per_row, tris_per_row, static_cast<int*>(out_tri),
            static_cast<float*>(out_t), static_cast<float*>(out_u),
            static_cast<float*>(out_v));
    };
    if (any_hit) {
        launch(packet_ww_kernel<true>);
    } else {
        launch(packet_ww_kernel<false>);
    }
    return static_cast<int>(cudaGetLastError());
}
"""))
# Step 2, dropped: the two-run queue in two registers and a count, or in
# one 64-bit register (the top run in the low word), not a local array.
REG_QUEUE = """using namespace ntrace;

struct RegQueue {
    int n = 0;
    int top = 0, below = 0;
    __device__ __forceinline__ void push(int entry) {
        below = top;
        top = entry;
        ++n;
    }
    __device__ __forceinline__ int front() const { return top; }
    __device__ __forceinline__ void advance() {
        if (top & 31) {
            top += 31;
        } else {
            top = below;
            --n;
        }
    }
};

struct U64Queue {
    int n = 0;
    unsigned long long runs = 0;
    __device__ __forceinline__ void push(int entry) {
        runs = (runs << 32) | static_cast<unsigned>(entry);
        ++n;
    }
    __device__ __forceinline__ int front() const {
        return static_cast<int>(static_cast<unsigned>(runs));
    }
    __device__ __forceinline__ void advance() {
        if (runs & 31) {
            runs += 31;
        } else {
            runs >>= 32;
            --n;
        }
    }
};
"""


def queue_in(kind: str) -> tuple:
    return (("using namespace ntrace;\n", REG_QUEUE),
            ("    RunQueue<2> queue;\n", f"    {kind} queue;\n"))


TRIED = {
    "step 2 (queue in two registers)": {
        src: queue_in("RegQueue") for src in BOTH},
    "step 2 (queue in one 64-bit register)": {
        src: queue_in("U64Queue") for src in BOTH},
    "pipe with the row prefetch (tried)": {
        "packet_pipe.cu": cs.ROW_PREFETCH},
    "ww with persistent warps (step 4)": {"packet_ww.cu": PERSISTENT_WW},
    "pipe at 64 registers (tried)": {"packet_pipe.cu": ((
        "__launch_bounds__(kBlock) packet_pipe_kernel(",
        "__launch_bounds__(kBlock, 8) packet_pipe_kernel("),)},
    # The spread of identical builds in one call.
    "change, built again": {},
}
SCHEDULE = "every step out (the parent's schedule)"


def log(msg: str):
    print(msg, flush=True)


def batches(device):
    """Phase 9's conference batches and the renderer's packed tables."""
    t0 = time.perf_counter()
    scene = get_scene("conference", n_tris=cs.SCENE_TRIS)
    bc = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                     max_leaf_size=48)
    camera = default_camera("conference")
    r = Renderer(scene, bc, RenderConfig(width=cs.WIDTH, height=cs.HEIGHT),
                 flat=build_accel(scene, bc), device=device)
    order, _ = pixel_table(cs.WIDTH, cs.HEIGHT)
    prim = raygen.primary(raygen.camera_arrays(camera, cs.WIDTH, cs.HEIGHT,
                                               device),
                          cs.WIDTH, cs.HEIGHT, torch.from_numpy(order.copy()))
    out = {"primary": ((prim.orig, prim.dirn, prim.tmin, prim.tmax), False)}
    for mode in ("shadow", "ao", "diffuse"):
        _, _, passes = cs.render_recorded(r, mode, camera)
        out[mode] = passes[mode][:2]
    tb = r.tables
    log(f"[ab] conference {scene.num_tris} tris, tables tpr "
        f"{tb.tris_per_row} npr {tb.nodes_per_row}; "
        + ", ".join(f"{b} {v[0][0].shape[0]} rays" for b, v in out.items())
        + f"; set-up {time.perf_counter() - t0:.1f} s")
    return out, tb


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a csrc/ directory of the kernels to compare")
    ap.add_argument("--calls", type=int, default=10,
                    help="calls a turn")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of two turns a build (A B ... B A)")
    ap.add_argument("--out", type=Path,
                    default=Path("results/ww_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ww_ab: needs a CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"[ab] {torch.cuda.get_device_name(0)}; {smi}")
    work = kbuild.BUILD_DIR / "ww_ab"
    specs = {"change": (kbuild.CSRC_DIR, {})}
    specs.update({n: (kbuild.CSRC_DIR, p)
                  for n, p in {**ABLATIONS, **TRIED}.items()})
    if args.parent:
        specs = {"parent": (args.parent, {}), **specs}
    dirs = {n: cs.patched_sources(n, p, c, work)
            for n, (c, p) in specs.items()}
    libs, secs, logs = cs.build_while_while(dirs)
    log(f"[ab] built {len(libs)} builds x {len(cs.WW_SOURCES)} sources in "
        f"{secs:.1f} s: {', '.join(libs)}")
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "ptxas": {}, "ms": {}, "mismatches": {},
              "any_hit_tri_differs": {}}
    for name in libs:
        result["ptxas"][name] = cs.ww_ptxas(logs[name])
        log(f"[ab] {name} ptxas: {result['ptxas'][name]}")

    data, tables = batches(device)
    bad = 0
    for bname, (rays, any_hit) in data.items():
        R = rays[0].shape[0]
        for kind, wrapper in KERNELS.items():
            def runner(lib):
                def run():
                    with cs.kernel_library(lib):
                        return wrapper(tables, *rays, any_hit=any_hit)
                return run

            runs = {n: runner(lib) for n, lib in libs.items()}
            outs = {n: run() for n, run in runs.items()}
            want = outs["change"]
            for n, got in outs.items():
                if any_hit:
                    diff = int(((got[0] >= 0) != (want[0] >= 0)).sum())
                    other = int((got[0] != want[0]).sum())
                    if other:
                        result["any_hit_tri_differs"][
                            f"{bname} {kind} {n}"] = other
                        log(f"[ab] {bname} {kind} {n}: any-hit tri differs "
                            f"from the change's on {other} of {R} rays "
                            f"(tri >= 0 on {diff})")
                else:
                    diff = sum(int((a.view(torch.int32)
                                    != b.view(torch.int32)).sum())
                               for a, b in zip(got, want))
                if diff:
                    bad += 1
                    result["mismatches"][f"{bname} {kind} {n}"] = diff
                    log(f"[ab] MISMATCH {bname} {kind} {n}: {diff} values "
                        "differ from the change's")
            if "parent" in outs:
                other = int((outs["parent"][0] != outs[SCHEDULE][0]).sum())
                log(f"[ab] {bname} {kind}: the parent's schedule rebuilt by "
                    f"patches differs from the parent on {other} rays' tri")
                if other:
                    bad += 1
                    result["mismatches"][f"{bname} {kind} {SCHEDULE} vs "
                                         "parent"] = other
            del outs, want
            order = (list(runs) + list(runs)[::-1]) * args.rounds
            samples = {n: [] for n in runs}
            for n in order:
                samples[n] += cuda_ms(runs[n], warmup=1, iters=args.calls)
            line = []
            for n, t in samples.items():
                ms = statistics.median(t)
                result["ms"][f"{bname} {kind} {n}"] = {
                    "median": ms, "min": min(t), "max": max(t),
                    "calls": len(t)}
                line.append(f"{n} {ms:.4f} ({min(t):.4f}-{max(t):.4f})")
            log(f"[ab] {bname} ({R} rays, "
                f"{'any' if any_hit else 'closest'} hit) {kind}: "
                + "; ".join(line))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    log(f"[ab] wrote {args.out}; {bad} builds with hits unlike the "
        f"change's; on {smi}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
