"""Prepared ray batches traced through the renderer's pass entries.

NTrace's benchmark mode: set-up makes, for each view of the walk, the
primary batch (one ray a pixel, Morton pixel order) and the workload's
secondary batches (AO: any hit, origin-major sort; diffuse: closest hit,
direction-major sort), with the benchmark's own copy of the generators
(lib/gen.py) from the primary hits the program traced. The window cycles
through the views in a closed loop and calls the pass entries as render()
does (lib/program.py:pass_entry). Workload keys: passes, views, walk_seed,
jitter, turn_deg, check_rays (sampled rays a batch for the check),
count_rays (the stride sample a batch for the roofline's work count).
Configuration key: trace_kernels (what the names of the traversal kernels
hold, for the roofline's device time).
"""

from __future__ import annotations

import sys
import traceback
from contextlib import nullcontext
from time import perf_counter

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.lib import cell as cellmod
from benchmark.lib import checks, count, gen, program, walk
from benchmark.lib.bound import bound_s
from benchmark.lib.prof import SPAN
from benchmark.lib.reference import Triangles, any_hits, closest_hits

ANY_HIT = {"primary": False, "ao": True, "diffuse": False}


def build(cell):
    """The scene and the renderer (its BVH built as configured)."""
    cell.scene = program.load_scene(cell.config)
    cell.mark("scene")
    cell.renderer = program.renderer(cell.config, cell.scene, "primary",
                                     cell.seed32, cell.device)
    cell.scale = gen.Scale.of(cell.scene.positions, cell.device)
    cell.gn = gen.geometric_normals(torch.as_tensor(
        cell.scene.tri_verts(), device=cell.device))
    cell.mark("bvh")


def traffic(cell):
    """The batches of every view, in the order the seed draws, and one
    warm-up call of each pass."""
    wl, rcfg = cell.workload, cell.config["render"]
    W, H = rcfg["width"], rcfg["height"]
    program.reseed(cell.renderer, cell.seed32)
    views = walk.views(cell.config["camera"], *cell.scale.box(), wl["views"],
                       wl["walk_seed"], wl["jitter"], wl["turn_deg"])
    order, _ = gen.pixel_table(W, H)
    pixels = torch.from_numpy(order).to(cell.device)
    cell.batches = []
    for i in walk.order(len(views), cell.rng(cellmod.ORDER)):
        v = views[i]
        cam = gen.camera_arrays(v["position"], v["forward"], v["up"],
                                v["fov_deg"], v["znear"], v["zfar"], W, H,
                                cell.device)
        prim = gen.primary(cam, W, H, pixels)
        tri, t, _, _ = program.pass_entry(cell.renderer, "primary", prim)()
        key = gen.prng_key((cell.seed32 + i) % 2 ** 31)
        for name in wl["passes"]:
            rays = prim
            if name != "primary":
                rays = gen.sort_rays(
                    gen.secondary(key, name, prim, tri, t, cell.gn,
                                  cell.scale, rcfg["samples"],
                                  rcfg["ao_radius"]),
                    cell.scale, direction_major=name != "ao")
            live = int((rays.tmax > rays.tmin).sum())
            cell.batches.append({
                "view": i, "pass": name, "rays": rays, "live": live,
                "call": program.pass_entry(cell.renderer, name, rays),
                "calls": 0, "out": None})
    cell.mark("traffic")
    for b in cell.batches:
        b["out"] = b["call"]()
    cell.mark("warmup")


def window(cell, seconds: float, traced: bool) -> dict:
    """Trace view after view until `seconds` have passed; the window closes
    once the last view's passes are synchronised."""
    per_view = {}
    for b in cell.batches:
        b["calls"], b["out"] = 0, None
        per_view.setdefault(b["view"], []).append(b)
    views = list(per_view.values())
    span = (lambda: record_function(SPAN)) if traced else nullcontext
    attempted = failed = live = 0
    error = None
    cell.sync()
    t0 = perf_counter()
    try:
        while True:
            for view in views:
                for b in view:
                    attempted += 1
                    with span():
                        b["out"] = b["call"]()
                    b["calls"] += 1
                    live += b["live"]
                if perf_counter() - t0 >= seconds:
                    break
            else:
                continue
            break
    except Exception:        # the program failed: the run is not correct
        failed += 1
        error = traceback.format_exc()
    cell.sync()
    return {"window_s": perf_counter() - t0, "attempted": attempted,
            "failed": failed, "error": error, "live_rays": live}


def readings(cell, win: dict, traced: bool) -> dict:
    """The window's numbers for the readers; traced, also the bound of
    every pass the window called, from lib/count.py's work on a stride
    sample of each batch, where the count reads the program's tables."""
    out = {"kind": "rays", "window_s": win["window_s"],
           "live_rays": win["live_rays"],
           "trace_kernels": cell.config["trace_kernels"]}
    if traced:
        tables = cell.renderer.tables
        try:
            count.check_layout(program.table_layout(tables), tables)
        except ValueError as e:      # the roofline goes silent, loudly
            print(f"trace_roofline: {e}", file=sys.stderr)
            return out
        total = 0.0
        for b in cell.batches:
            r = b["rays"]
            n = r.num_rays
            idx = torch.arange(0, n, max(n // cell.workload["count_rays"], 1),
                               device=cell.device)
            w = count.count_work(tables, r.orig[idx], r.dirn[idx],
                                 r.tmin[idx], r.tmax[idx], ANY_HIT[b["pass"]])
            b["bound_s"], b["bound_by"] = bound_s(n, w, tables.tris_per_row,
                                                  scale=n / idx.numel())
            total += b["bound_s"] * b["calls"]
        out["bound_s"] = total
    return out


def sample(cell) -> list:
    """For each batch the window traced, `check_rays` slots drawn from the
    seed: the rays and what the window's last call of its pass returned
    there (on the CPU)."""
    rng = cell.rng(cellmod.CHECK)
    out = []
    for b in cell.batches:
        r = b["rays"]
        n = min(cell.workload["check_rays"], r.num_rays)
        idx = torch.from_numpy(np.sort(rng.choice(r.num_rays, n,
                                                  replace=False)))
        if b["out"] is None:
            continue
        dev_idx = idx.to(cell.device)
        out.append({"pass": b["pass"],
                    "rays": [a[dev_idx].cpu() for a in (r.orig, r.dirn,
                                                        r.tmin, r.tmax)],
                    "hits": [a[dev_idx].cpu() for a in b["out"]]})
    return out


def release(cell):
    """Drop the program's state: the renderer and the batches."""
    cell.renderer = None
    cell.batches = None


def reference(cell, samples: list, dtype) -> list:
    """The reference's answers for the sampled rays, computed in `dtype`:
    (tri, t, u, v) for closest-hit passes, blocked for any-hit ones."""
    tris = Triangles(torch.as_tensor(cell.scene.tri_verts(),
                                     device=cell.device), dtype)
    out = []
    for s in samples:
        rays = [a.to(cell.device) for a in s["rays"]]
        if ANY_HIT[s["pass"]]:
            out.append(any_hits(tris, *rays).cpu())
        else:
            out.append(tuple(a.cpu() for a in closest_hits(tris, *rays)))
    return out


def numbers(samples: list, answers: list, hits_of=None) -> dict:
    """The check's numbers (lib/checks.py) of the run's hits (or of
    `hits_of`, one entry a sample) against `answers`."""
    closest, anyhit = [], []
    for k, (s, ref) in enumerate(zip(samples, answers)):
        hits = s["hits"] if hits_of is None else hits_of[k]
        if ANY_HIT[s["pass"]]:
            anyhit.append((hits[0], ref))
        else:
            closest.append((hits, ref))
    return checks.hit_numbers(closest, anyhit)


def control_hits(answers: list) -> list:
    """Reference answers in the form of a run's hits, to put the control
    in the program's place: a blocked any-hit ray reads as triangle 0."""
    return [list(a) if isinstance(a, tuple)
            else [torch.where(a, 0, -1).to(torch.int32)] for a in answers]
