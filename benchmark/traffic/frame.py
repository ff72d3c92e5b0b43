"""Whole frames: `Renderer.render(camera, mode)` in a closed loop.

Set-up builds the renderer (its BVH once, static), takes the walk's
cameras in the order the seed draws, and renders each once to warm up. The
window renders camera after camera, each frame timed by the host clock
from the call to its image on the host, and keeps each camera's last
image for the check. The reference re-derives sampled pixels of those
images from the scene alone: primary ray, closest hit, the mode's
secondary rays from the same random numbers (lib/gen.py), their hits, and
the shading. Workload keys: mode, cameras, walk_seed, jitter, turn_deg,
check_pixels (pixels a camera drawn from the seed for the check).
"""

from __future__ import annotations

import traceback
from contextlib import nullcontext
from time import perf_counter

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.lib import cell as cellmod
from benchmark.lib import checks, gen, program, walk
from benchmark.lib.prof import FRAME_SPAN
from benchmark.lib.reference import Triangles, any_hits, closest_hits


def build(cell):
    cell.scene = program.load_scene(cell.config)
    cell.mark("scene")
    cell.renderer = program.renderer(cell.config, cell.scene,
                                     cell.workload["mode"], cell.seed32,
                                     cell.device)
    cell.mark("bvh")


def traffic(cell):
    wl = cell.workload
    program.reseed(cell.renderer, cell.seed32)
    lo = cell.scene.positions.min(axis=0)
    hi = cell.scene.positions.max(axis=0)
    views = walk.views(cell.config["camera"], lo, hi, wl["cameras"],
                       wl["walk_seed"], wl["jitter"], wl["turn_deg"])
    cell.views = [views[i] for i in walk.order(len(views),
                                                cell.rng(cellmod.ORDER))]
    cell.cameras = [program.camera(v) for v in cell.views]
    cell.mark("traffic")
    for cam in cell.cameras:
        cell.renderer.render(cam, wl["mode"])
    cell.mark("warmup")


def window(cell, seconds: float, traced: bool) -> dict:
    mode = cell.workload["mode"]
    span = (lambda: record_function(FRAME_SPAN)) if traced else nullcontext
    frame_s, stats = [], []
    attempted = failed = 0
    error = None
    n = len(cell.cameras)
    cell.images = [None] * n
    cell.sync()
    t0 = perf_counter()
    try:
        while True:
            k = attempted % n
            attempted += 1
            f0 = perf_counter()
            with span():
                res = cell.renderer.render(cell.cameras[k], mode)
            f1 = perf_counter()
            frame_s.append(f1 - f0)
            stats.append(res.stats)
            cell.images[k] = res.image
            if f1 - t0 >= seconds:
                break
    except Exception:        # the program failed: the run is not correct
        failed += 1
        error = traceback.format_exc()
    return {"window_s": perf_counter() - t0, "attempted": attempted,
            "failed": failed, "error": error, "frame_s": frame_s,
            "stats": stats}


def readings(cell, win: dict, traced: bool) -> dict:
    return {"kind": "frame", "mode": cell.workload["mode"],
            "window_s": win["window_s"], "frame_s": win["frame_s"],
            "stats": win["stats"]}


def sample(cell) -> list:
    """For each camera the window rendered, `check_pixels` pixel ids drawn
    from the seed and the colours its last image in the window holds
    there."""
    rcfg = cell.config["render"]
    n_pix = rcfg["width"] * rcfg["height"]
    rng = cell.rng(cellmod.CHECK)
    out = []
    for view, img in zip(cell.views, cell.images):
        pix = np.sort(rng.choice(n_pix, min(cell.workload["check_pixels"],
                                            n_pix), replace=False))
        if img is None:
            continue
        out.append({"view": view, "pixels": pix,
                    "colours": img.reshape(-1, 3)[pix].copy()})
    return out


def release(cell):
    cell.renderer = None
    cell.images = None


def reference(cell, samples: list, dtype) -> list:
    """The reference's colours of the sampled pixels, its hit tests in
    `dtype`."""
    rcfg, mode = cell.config["render"], cell.workload["mode"]
    W, H, S = rcfg["width"], rcfg["height"], rcfg["samples"]
    dev = cell.device
    tv = torch.as_tensor(cell.scene.tri_verts(), device=dev)
    tris = Triangles(tv, dtype)
    gn = gen.geometric_normals(tv)
    scale = gen.Scale.of(cell.scene.positions, dev)
    _, slot_of = gen.pixel_table(W, H)
    key = gen.prng_key(cell.seed32)
    out = []
    for s in samples:
        v = s["view"]
        cam = gen.camera_arrays(v["position"], v["forward"], v["up"],
                                v["fov_deg"], v["znear"], v["zfar"], W, H,
                                dev)
        pix = torch.from_numpy(s["pixels"].astype(np.int32)).to(dev)
        prim = gen.primary(cam, W, H, pix)
        tri, t, _, _ = closest_hits(tris, prim.orig, prim.dirn, prim.tmin,
                                    prim.tmax)
        base = _normal_colour(gn, tri)
        slots = torch.from_numpy(slot_of[s["pixels"]].astype(np.int64)).to(
            dev)
        sec = gen.secondary(key, mode, prim, tri, t, gn, scale, S,
                            rcfg["ao_radius"], slots=slots)
        rays = (sec.orig, sec.dirn, sec.tmin, sec.tmax)
        if mode == "ao":
            vis = (~any_hits(tris, *rays)).to(torch.float32).reshape(
                -1, S).mean(dim=1)
            colour = base * vis[:, None]
        else:
            bounce = _normal_colour(gn, closest_hits(tris, *rays)[0])
            colour = base * 0.5 + bounce.reshape(-1, S, 3).mean(dim=1) * 0.5
        out.append(colour.cpu())
    return out


def _normal_colour(gn: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """|unit geometric normal| of each hit; black on a miss."""
    return torch.where(tri[:, None] >= 0, gen.unit_normal(gn, tri).abs(),
                       0.0)


def numbers(samples: list, answers: list, hits_of=None) -> dict:
    colours = ([s["colours"] for s in samples] if hits_of is None
               else hits_of)
    return checks.pixel_numbers(list(zip(colours, answers)))


def control_hits(answers: list) -> list:
    return answers
