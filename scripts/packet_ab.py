"""Time the packet kernel (packet_trace) and packet_ifif of this checkout
against other builds of their sources, on one card.

The builds: this checkout's `csrc/packet_trace.cu` and `csrc/packet_ifif.cu`
("change"); the same with one step of the redesign taken out again by
text patches (ABLATIONS, from chip_smoke.py: the any-hit row stop, the
cull on pop, the vector slot loads, and every step out, which is the
parent's schedule that phases 9 and 10 count any-hit triangles against);
the same with a step that was tried put in (TRIED: both kernels held to
the parent's 48 registers by __launch_bounds__(kBlock, 10)); the change
built again, for the spread of identical builds; and, with --parent, the
sources of another checkout (`DIR` holds its `packet_trace.cu`,
`packet_ifif.cu` and `trace_common.cuh`). Each build is compiled with kernels/build.py's
flags, one nvcc a source, all at once.

The batches are the ones `chip_smoke.py` phase 9 times: conference
(297,024 triangles, binned SAH) primary 1024x768 and the shadow, AO and
diffuse passes of `render()` through the packet kernel, on the renderer's
tables; and, for the packet kernel, phase 10's hairball AO pass (BASELINE
config #4, 2,900,402 triangles, LBVH built on the card) and phase 15's
fairy diffuse and AO passes (BASELINE config #3, 169,808 triangles,
HLBVH). Every build's
hits must equal the change's on every ray: closest hits tri/t/u/v bit
for bit, any hits tri >= 0; which triangle an any-hit ray holds is logged
where it differs (the row stop changes it), and the parent's schedule
rebuilt by patches must hold the parent's triangle on every any-hit ray.
Times are CUDA events, the builds in turns (A B C ... C B A, `--rounds`
times), `--calls` calls a turn, medians over every turn. It logs each
build's ptxas registers, stack frame and spills, and writes everything to
--out as JSON. Exits 1 if a build's hits differ. Needs a CUDA device:

    python3 scripts/packet_ab.py --parent PARENT/ntrace_tpu_torch/csrc
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
from ntrace_tpu_torch.host import (RenderConfig, default_camera,  # noqa: E402
                                   get_scene)
from ntrace_tpu_torch.kernels import build as kbuild  # noqa: E402
from ntrace_tpu_torch.render.renderer import Renderer  # noqa: E402
from ntrace_tpu_torch.trace.packet import trace_packet  # noqa: E402
from ntrace_tpu_torch.trace.packet_ifif import (  # noqa: E402
    trace_packet_ifif)
from ntrace_tpu_torch.utils.timing import cuda_ms  # noqa: E402

import ww_ab  # noqa: E402

KERNELS = {"packet": trace_packet, "packet_ifif": trace_packet_ifif}
BOTH = cs.PACKET_SOURCES
ABLATIONS = {
    "no step 1 (any hit: whole leaves)": {
        src: cs.ROW_STOP_OUT for src in BOTH},
    "no step 2 (no cull on pop)": {src: cs.CULL_OUT for src in BOTH},
    "no step 4 (scalar slot loads)": {src: cs.VECTOR_OUT for src in BOTH},
    "every step out (the parent's schedule)": cs.PACKET_PARENT,
}
TRIED = {
    "48 registers (__launch_bounds__(kBlock, 10))": {
        "packet_trace.cu": ((
            "__launch_bounds__(kBlock) packet_trace_kernel(",
            "__launch_bounds__(kBlock, 10) packet_trace_kernel("),),
        "packet_ifif.cu": ((
            "__launch_bounds__(kBlock) packet_ifif_kernel(",
            "__launch_bounds__(kBlock, 10) packet_ifif_kernel("),)},
    # The spread of identical builds in one call.
    "change, built again": {},
}
SCHEDULE = "every step out (the parent's schedule)"


def log(msg: str):
    print(msg, flush=True)


def scene_batches(device):
    """The packet kernel's other batches: phase 10's hairball AO pass and
    phase 15's fairy diffuse and AO passes, each (name, rays, any_hit,
    tables)."""
    out = []
    for name, n_tris, cfg, modes in (
            ("hairball", cs.HAIRBALL_TRIS, cs.LBVH_CFG, ("ao",)),
            ("fairy", cs.FAIRY_TRIS, cs.HLBVH_CFG, ("diffuse", "ao"))):
        t0 = time.perf_counter()
        scene = get_scene(name, n_tris=n_tris)
        r = Renderer(scene, cfg, RenderConfig(
            width=cs.WIDTH, height=cs.HEIGHT, engine="auto"), device=device)
        tb = r.tables
        for mode in modes:
            _, _, passes = cs.render_recorded(r, mode,
                                              default_camera(name))
            out.append((f"{name} {mode}", *passes[mode][:2], tb))
        log(f"[ab] {name} {scene.num_tris} tris, tables tpr "
            f"{tb.tris_per_row} npr {tb.nodes_per_row}, max_leaf_rows "
            f"{tb.max_leaf_rows}; " + ", ".join(
                f"{b} {rays[0].shape[0]} rays" for b, rays, _, t in out
                if t is tb)
            + f"; set-up {time.perf_counter() - t0:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a csrc/ directory of the kernels to compare")
    ap.add_argument("--calls", type=int, default=10,
                    help="calls a turn")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of two turns a build (A B ... B A)")
    ap.add_argument("--conference-only", action="store_true",
                    help="leave out the hairball and fairy batches")
    ap.add_argument("--out", type=Path,
                    default=Path("results/packet_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("packet_ab: needs a CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"[ab] {torch.cuda.get_device_name(0)}; {smi}")
    work = kbuild.BUILD_DIR / "packet_ab"
    specs = {"change": (kbuild.CSRC_DIR, {})}
    specs.update({n: (kbuild.CSRC_DIR, p)
                  for n, p in {**ABLATIONS, **TRIED}.items()})
    if args.parent:
        specs = {"parent": (args.parent, {}), **specs}
    dirs = {n: cs.patched_sources(n, p, c, work, BOTH)
            for n, (c, p) in specs.items()}
    libs, secs, logs = cs.build_patched(dirs, BOTH, cs.PACKET_ENTRIES)
    log(f"[ab] built {len(libs)} builds x {len(BOTH)} sources in "
        f"{secs:.1f} s: {', '.join(libs)}")
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "ptxas": {}, "ms": {}, "mismatches": {},
              "any_hit_tri_differs": {}}
    for name in libs:
        result["ptxas"][name] = cs.ptxas_report(logs[name], cs.PACKET_KERNELS)
        log(f"[ab] {name} ptxas: {result['ptxas'][name]}")

    data, tables = ww_ab.batches(device)
    runs = [(b, kind, rays, any_hit, tables)
            for b, (rays, any_hit) in data.items() for kind in KERNELS]
    if not args.conference_only:
        runs += [(b, "packet", rays, any_hit, tb)
                 for b, rays, any_hit, tb in scene_batches(device)]
    bad = 0
    for bname, kind, rays, any_hit, tb in runs:
        R = rays[0].shape[0]
        wrapper = KERNELS[kind]

        def runner(lib):
            def run():
                with cs.kernel_library(lib):
                    return wrapper(tb, *rays, any_hit=any_hit)
            return run

        calls = {n: runner(lib) for n, lib in libs.items()}
        outs = {n: run() for n, run in calls.items()}
        want = outs["change"]
        for n, got in outs.items():
            if any_hit:
                diff = int(((got[0] >= 0) != (want[0] >= 0)).sum())
                other = int((got[0] != want[0]).sum())
                if other:
                    result["any_hit_tri_differs"][f"{bname} {kind} {n}"] = \
                        other
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
        order = (list(calls) + list(calls)[::-1]) * args.rounds
        samples = {n: [] for n in calls}
        for n in order:
            samples[n] += cuda_ms(calls[n], warmup=1, iters=args.calls)
        line = []
        for n, t in samples.items():
            ms = statistics.median(t)
            result["ms"][f"{bname} {kind} {n}"] = {
                "median": ms, "min": min(t), "max": max(t),
                "calls": len(t)}
            line.append(f"{n} {ms:.4f} ({min(t):.4f}-{max(t):.4f})")
        log(f"[ab] {bname} ({R} rays, {'any' if any_hit else 'closest'} "
            f"hit) {kind}: " + "; ".join(line))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    log(f"[ab] wrote {args.out}; {bad} builds with hits unlike the "
        f"change's; on {smi}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
