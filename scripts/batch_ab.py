"""Time the node-batch kernels (packet_bfs, packet_dleaf, packet_bdl) of this
checkout against other builds of their template, on one card.

The builds: this checkout's `csrc/packet_batch.cuh` ("change"); the same
with one step of its design taken out again by a text patch (ABLATIONS:
shared memory sized for the worst launch, bfs warps testing every run of
the packet, rows tested from device memory, and all three at once, which
leaves the two-barrier step and the barrier-free drains); the same with
a step that was tried and dropped put back (TRIED); and, with
--parent, the template of another checkout (`DIR` holds its
`packet_batch.cuh`, `trace_common.cuh` and the three `.cu` files). Each
is built with kernels/build.py's flags, one nvcc a source, all at once.

The batches are the ones `chip_smoke.py` phase 13 times: conference
(297,024 triangles, binned SAH) primary 1024x768 and the shadow, AO and
diffuse passes of `render()` through the packet kernel, with the
renderer's tables and knobs for each engine. Every build's hits must
equal the change's on every ray: closest hits tri/t/u/v bit for bit,
any hits tri >= 0 (which triangle an any-hit ray holds is logged where it
differs: bfs's rule of which rows a warp tests changed). Times are
CUDA events, the builds in turns (A B C ... C B A), `--calls` calls a
turn, medians over both turns. It logs each build's registers, shared
memory a block and resident blocks an SM at the renderer's knobs
(cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor),
and writes everything to --out as JSON. Exits 1 if a build's hits
differ. Needs a CUDA device:

    python3 scripts/batch_ab.py --parent PARENT/ntrace_tpu_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig,  # noqa: E402
                                   default_camera, get_scene, pack_bvh)
from ntrace_tpu_torch.kernels import build as kbuild  # noqa: E402
from ntrace_tpu_torch.ray import raygen  # noqa: E402
from ntrace_tpu_torch.ray.pixeltable import pixel_table  # noqa: E402
from ntrace_tpu_torch.render.renderer import (ONE_NODE_A_ROW,  # noqa: E402
                                              Renderer, batch_knobs,
                                              build_accel, pick_layout)
from ntrace_tpu_torch.tables import tables_from_packed  # noqa: E402
from ntrace_tpu_torch.trace import packet_batch as pb  # noqa: E402
from ntrace_tpu_torch.trace.packet_common import hit_outputs  # noqa: E402
from ntrace_tpu_torch.utils.timing import cuda_ms  # noqa: E402

KINDS = {"packet_bfs": pb.BFS, "packet_dleaf": pb.DLEAF,
         "packet_bdl": pb.BDL}
SOURCES = ("packet_bfs.cu", "packet_dleaf.cu", "packet_bdl.cu")
# One step of the template taken out again: (old text, new text) pairs
# for csrc/packet_batch.cuh, each old text occurring once.
WORST_SHARED = (
    """    return carve<kBatch, kQueued>(nullptr, rows, rows / qgroup, stack,
                                  &none);""",
    """    return carve<kBatch, kQueued>(nullptr, rows, rows / qgroup, stack,
                                  &none)
           + sizeof(int) * ((kBatch == 1 ? 128 : 4096) - stack)
           + (kQueued ? sizeof(int2) * kQcap * (kMaxRows - rows / qgroup)
                      : 0);""")
EVERY_RUN = ("test_rows(WantedRuns{sh, wants, sh.scal[kLqn], 0}",
             "test_rows(WantedRuns{sh, ~0u, sh.scal[kLqn], 0}")
ROWS_FROM_DEVICE = (
    """    int cur = next();
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
""",
    """    for (int rw = next(); rw >= 0; rw = next())
        if (live) test_row(tris, rw, tpr, ray, hit);
""")
NO_ROW_BUFFERS = (
    "bump(base, &off, sizeof(float4) * rows * kRowBufs * kRowChunks)",
    "bump(base, &off, 0)")
ABLATIONS = {
    "no step 1 (worst-case shared memory)": (WORST_SHARED,),
    "no step 4 (bfs: every run)": (EVERY_RUN,),
    "no step 5 (rows from device memory)": (ROWS_FROM_DEVICE,
                                            NO_ROW_BUFFERS),
    "steps 2-3 only": (WORST_SHARED, EVERY_RUN, ROWS_FROM_DEVICE,
                       NO_ROW_BUFFERS),
}
# A step tried and dropped (no faster): dleaf and bdl put the first row of
# a group's next drains in flight at the end of its drains, when that row
# is the active run's next one (it is, unless the step drains nothing).
CARRIED_ROW = (
    ("""// The (t, id) fold makes the order free.
template <class Runs>
__device__ __forceinline__ void test_rows(Runs runs, int limit, float4* buf,
""",
     """// The (t, id) fold makes the order free. The call starts at buffer b,
// where `pre` is a row already in flight (-1: none). With kCarry (dleaf,
// bdl), when the limit ends the call inside a run, the run's next row, the
// group's first row of its next drains, is put in flight to the next
// buffer: `pre` and `b` then name it, and the call returns true.
template <bool kCarry, class Runs>
__device__ __forceinline__ bool test_rows(Runs runs, int limit, float4* buf,
                                          int& b, int& pre,
"""),
    ("""    int cur = next();
    if (cur < 0) return;
    fetch_row(buf, tris, cur, chunks, lane);
    for (int b = 0;;) {   // the buffer of the row tested now
""",
     """    int cur = next();
    if (cur < 0) return false;
    if (cur != pre) {
        if (pre >= 0) wait_async<0>();   // no two copies into one buffer
        fetch_row(buf + b * kRowChunks, tris, cur, chunks, lane);
    }
    for (;;) {   // b: the buffer of the row tested now
"""),
    ("""        if (nxt < 0) break;
        b = b1;
    }
}""",
     """        b = b1;
        if (nxt < 0) break;
    }
    pre = -1;
    if (kCarry && left > 0) {
        fetch_row(buf + b * kRowChunks, tris, row, chunks, lane);
        pre = row;
        return true;
    }
    return false;
}"""),
    ("""    fetch_records<kBatch>(rec, nodes, npr, sh.stack, 1, lane);
""",
     """    fetch_records<kBatch>(rec, nodes, npr, sh.stack, 1, lane);
    // The warp's next row buffer, the row in flight to it (-1: none), and
    // whether that copy is the warp's newest.
    int buf = 0, pre = -1;
    bool carried = false;
"""),
    ("""        wait_async<0>();
        __syncwarp();   // the warp's copy of the popped records landed""",
     """        if (carried) {   // the records are older than the carried row
            wait_async<1>();
        } else {
            wait_async<0>();
        }
        __syncwarp();   // the warp's copy of the popped records landed"""),
    ("""            test_rows(WantedRuns{sh, wants, sh.scal[kLqn], 0}, INT_MAX,
                      rowbuf, tris, tpr, chunks, lane, live, ray, hit);
        } else {
            const int* d = sh.drain + group;
            test_rows(DrainRuns{sh.queue + group * kQcap,
                                make_int2(d[0], d[groups]), d[2 * groups],
                                false},
                      d[3 * groups], rowbuf, tris, tpr, chunks, lane, live,
                      ray, hit);
        }""",
     """            test_rows<false>(WantedRuns{sh, wants, sh.scal[kLqn], 0},
                             INT_MAX, rowbuf, buf, pre, tris, tpr, chunks,
                             lane, live, ray, hit);
        } else {
            const int* d = sh.drain + group;
            const int k = d[3 * groups];
            if (k > 0) {
                carried = test_rows<true>(
                    DrainRuns{sh.queue + group * kQcap,
                              make_int2(d[0], d[groups]), d[2 * groups],
                              false},
                    k, rowbuf, buf, pre, tris, tpr, chunks, lane, live, ray,
                    hit);
            } else {
                carried = false;   // the records are the newest copy
            }
        }"""),
)
# Tried: warp 0 starts the records the next step most likely pops (the
# children of the popped nodes and the stack entries below them) towards
# L1 with prefetch.global.L1 while the warps slab-test, so the next step's
# cp.async finds them there.
PREFETCH_RECORDS = ((
    """        const float* rc = reinterpret_cast<const float*>(rec);
""",
    """        const float* rc = reinterpret_cast<const float*>(rec);
        if (warp == 0) {
            int ref = -1;
            if (lane < 2 * nb) {
                ref = static_cast<int>(
                    rc[kNodeLanes * (lane >> 1) + 12 + (lane & 1)]);
            } else if (lane >= 16 && lane - 16 < kBatch
                       && sp - nb - 1 - (lane - 16) >= 0) {
                ref = sh.stack[sp - nb - 1 - (lane - 16)];
            }
            if (ref >= 0) {
                asm volatile("prefetch.global.L1 [%0];" :: "l"(
                    nodes + static_cast<size_t>(ref / npr) * kRowLanes
                    + kNodeLanes * (ref % npr)));
            }
        }
"""),)
TRIED = {"with a carried row (dropped)": CARRIED_ROW,
         "with the next records prefetched to L1 (dropped)":
             PREFETCH_RECORDS}
# The parent template (before the two-barrier step) has no occupancy
# entry and no stack argument; this one is appended to each of its
# sources.
PARENT_OCCUPANCY = """
extern "C" int {name}_occupancy(int any_hit, int rows, int qgroup,
                                int stack, int* out) {{
    (void)qgroup;
    (void)stack;
    auto get = [&](auto kernel) {{
        cudaFuncAttributes a{{}};
        cudaError_t e = cudaFuncGetAttributes(&a, kernel);
        int blocks = 0;
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, kernel, rows * 32, 0);
        out[0] = a.numRegs;
        out[1] = static_cast<int>(a.sharedSizeBytes);
        out[2] = blocks;
        return static_cast<int>(e);
    }};
    return any_hit
        ? get(ntrace::batch::batch_kernel<{args}, true>)
        : get(ntrace::batch::batch_kernel<{args}, false>);
}}
"""
PARENT_ARGS = {"packet_bfs": "8, false, 4096, 1000000LL",
               "packet_dleaf": "1, true, 128, 4000000LL",
               "packet_bdl": "8, true, 4096, 1000000LL"}


def log(msg: str):
    print(msg, flush=True)


def variant_sources(name: str, csrc: Path, patches, parent: bool,
                    out: Path) -> Path:
    """Write a build's sources into out/<slug>/; returns that directory."""
    d = out / "".join(c if c.isalnum() else "_" for c in name)
    d.mkdir(parents=True, exist_ok=True)
    head = (csrc / "packet_batch.cuh").read_text()
    for old, new in patches:
        if head.count(old) != 1:
            raise AssertionError(f"{name}: patch text occurs "
                                 f"{head.count(old)} times, not once:\n{old}")
        head = head.replace(old, new)
    (d / "packet_batch.cuh").write_text(head)
    (d / "trace_common.cuh").write_text(
        (csrc / "trace_common.cuh").read_text())
    for src in SOURCES:
        text = (csrc / src).read_text()
        if parent:
            kind = src[:-3]
            text += PARENT_OCCUPANCY.format(name=f"ntrace_{kind}",
                                            args=PARENT_ARGS[kind])
        (d / src).write_text(text)
    return d


def build_all(dirs: dict[str, Path]) -> tuple[dict[str, Path], float, str]:
    """One nvcc a source of every build, all at once, then one link a
    build. Returns the libraries, the seconds and the compilers' logs."""
    t0 = time.perf_counter()
    jobs = [(name, d, d / f"{Path(src).stem}.o", d / src)
            for name, d in dirs.items() for src in SOURCES]
    done = kbuild._run_all([[kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-I",
                             str(d), "-c", "-o", str(o), str(s)]
                            for _, d, o, s in jobs])
    logs = "".join(out for _, out in done)
    if any(rc for rc, _ in done):
        raise RuntimeError(f"nvcc failed:\n{logs}")
    libs = {name: d / f"libbatch_{os.getpid()}.so"
            for name, d in dirs.items()}
    done = kbuild._run_all([[kbuild.nvcc(), *kbuild.ARCH, "-shared", "-o",
                             str(libs[name]),
                             *(str(d / f"{Path(s).stem}.o")
                               for s in SOURCES)]
                            for name, d in dirs.items()])
    if any(rc for rc, _ in done):
        raise RuntimeError("link failed:\n" + "".join(o for _, o in done))
    return libs, time.perf_counter() - t0, logs


def bind(path: Path, parent: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for kind in KINDS:
        entry = f"ntrace_{kind}"
        restype, argtypes = kbuild.SIGNATURES[entry]
        if parent:   # no stack argument
            argtypes = argtypes[:-6] + argtypes[-5:]
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = restype, argtypes
        occ = getattr(lib, entry + "_occupancy")
        occ.restype, occ.argtypes = kbuild.SIGNATURES[entry + "_occupancy"]
    return lib


def launcher(lib, parent: bool, kind: str, tables, rays, any_hit: bool,
             knobs: dict):
    """A call of `lib`'s entry point for `kind` on these rays; returns a
    function that launches it and returns the outputs."""
    sched = KINDS[kind]
    rows, qgroup, dmin = pb.knobs(sched, knobs["rows"],
                                  knobs.get("qgroup", 1),
                                  knobs.get("drain_min", 0))
    extra = {"packet_bfs": (rows,), "packet_dleaf": (rows, dmin),
             "packet_bdl": (rows, dmin, qgroup,
                            int(knobs.get("merge_sibs", False)))}[kind]
    if not parent:
        extra += (sched.stack_need(tables.max_depth),)
    fn = getattr(lib, f"ntrace_{kind}")
    orig, dirn, tmin, tmax = (a.contiguous() for a in rays)

    def run():
        outs = hit_outputs(orig)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(tables.nodes8.data_ptr(), tables.tris12.data_ptr(),
                orig.data_ptr(), dirn.data_ptr(), tmin.data_ptr(),
                tmax.data_ptr(), orig.shape[0], tables.nodes_per_row,
                tables.tris_per_row, int(any_hit), *extra,
                *(o.data_ptr() for o in outs), stream)
        if rc:
            raise RuntimeError(f"{kind} launch failed: CUDA error {rc}")
        return outs

    return run


def batches(device):
    """The conference batches of phase 13 and each engine's tables."""
    t0 = time.perf_counter()
    scene = get_scene("conference", n_tris=cs.SCENE_TRIS)
    bc = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                     max_leaf_size=48)
    flat = build_accel(scene, bc)
    camera = default_camera("conference")
    r = Renderer(scene, bc, RenderConfig(width=cs.WIDTH, height=cs.HEIGHT),
                 flat=flat, device=device)
    order, _ = pixel_table(cs.WIDTH, cs.HEIGHT)
    prim = raygen.primary(raygen.camera_arrays(camera, cs.WIDTH, cs.HEIGHT,
                                               device),
                          cs.WIDTH, cs.HEIGHT, torch.from_numpy(order.copy()))
    out = {"primary": ((prim.orig, prim.dirn, prim.tmin, prim.tmax), False)}
    for mode in ("shadow", "ao", "diffuse"):
        _, _, passes = cs.render_recorded(r, mode, camera)
        out[mode] = passes[mode][:2]
    _, _, tpr, npr = pick_layout(flat)
    tables = {}
    for kind in KINDS:
        n = 1 if kind in ONE_NODE_A_ROW else npr
        tables[kind] = tables_from_packed(
            pack_bvh(flat, scene.tri_verts(), tris_per_row=tpr,
                     nodes_per_row=n), device)
    log(f"[ab] conference {scene.num_tris} tris, tables tpr={tpr} npr "
        f"{npr} (bfs, bdl 1), depth {tables['packet_bfs'].max_depth}; "
        + ", ".join(f"{b} {v[0][0].shape[0]} rays" for b, v in out.items())
        + f"; set-up {time.perf_counter() - t0:.1f} s")
    return out, tables


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a csrc/ directory of the template to compare")
    ap.add_argument("--calls", type=int, default=10,
                    help="calls a turn (two turns a build)")
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/batch_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("batch_ab: needs a CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"[ab] {torch.cuda.get_device_name(0)}; {smi}")
    work = kbuild.BUILD_DIR / "batch_ab"
    specs = {"change": (kbuild.CSRC_DIR, (), False)}
    specs.update({n: (kbuild.CSRC_DIR, p, False)
                  for n, p in {**ABLATIONS, **TRIED}.items()})
    if args.parent:
        specs = {"parent": (args.parent, (), True), **specs}
    dirs = {n: variant_sources(n, c, p, par, work)
            for n, (c, p, par) in specs.items()}
    paths, secs, _ = build_all(dirs)
    libs = {n: bind(p, specs[n][2]) for n, p in paths.items()}
    log(f"[ab] built {len(libs)} builds x {len(SOURCES)} sources in "
        f"{secs:.1f} s: {', '.join(libs)}")

    data, tables = batches(device)
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "occupancy": {}, "ms": {}, "mismatches": {},
              "any_hit_tri_differs": {}}
    for kind, sched in KINDS.items():
        knobs = batch_knobs(kind, RenderConfig())
        depth = tables[kind].max_depth
        for name, lib in libs.items():
            for any_hit in (False, True):
                cout = (ctypes.c_int * 3)()
                rc = getattr(lib, f"ntrace_{kind}_occupancy")(
                    int(any_hit), knobs["rows"], knobs.get("qgroup", 1),
                    sched.stack_need(depth), cout)
                if rc:
                    raise RuntimeError(f"{name} {kind} occupancy: {rc}")
                regs, smem, blocks = cout
                result["occupancy"][f"{kind} {name} any_hit={any_hit}"] = (
                    regs, smem, blocks)
                log(f"[ab] {kind} {name} any_hit={int(any_hit)}: {regs} "
                    f"registers, {smem} B shared memory a block, {blocks} "
                    f"blocks an SM ({knobs['rows']} warps a block, stack "
                    f"{sched.stack_need(depth)})")
    bad = 0
    for bname, (rays, any_hit) in data.items():
        R = rays[0].shape[0]
        for kind in KINDS:
            knobs = batch_knobs(kind, RenderConfig())
            runs = {n: launcher(lib, specs[n][2], kind, tables[kind], rays,
                                any_hit, knobs)
                    for n, lib in libs.items()}
            want = runs["change"]()
            for n, run in runs.items():
                got = run()
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
            del want
            order = list(runs) + list(runs)[::-1]
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
