"""Path-traced frames: `Renderer.render(camera, "path")` in a closed loop.

Set-up, traffic and readings are `frame.py`'s; set-up also refuses a
renderer whose `bounces` differs from the configuration's (lib/program.py
passes none, so the renderer's default serves), and, before it builds
anything, a program whose frames keep no last hits
(`RenderResult.bounce_tri`): the check needs them. The window is
frame.py's and keeps, besides each camera's last image, that frame's
primary hits and its paths' last hits (on the device; read after the
window).
The reference re-derives each sampled pixel's whole path from the scene
alone (lib/path.py: the primary hit, each bounce's normal, origin and
threefry-split cosine direction at the pixel's slot of the frame's batch,
each hit by lib/reference.py:closest_hits over every triangle, the
emission, throughput and sky sums). The check: frame.py's pixel numbers,
primary_tri_mismatch and bounce_tri_mismatch, the shares of the sampled
pixels whose primary triangle, and whose path's last triangle (the last
bounce's hit, -1 where the path ended before it), differ from the
reference's. Where every path ends on a surface that emits nothing, as in
a closed scene without lights, the image is black and the colours show
only hits turned into misses; the triangles show a wrong hit too, the last
one a wrong hit of any bounce (each bounce starts on the hit before it).
Workload keys: those of `frame.py` (mode "path").
"""

from __future__ import annotations

import dataclasses
import sys
import traceback
from contextlib import nullcontext
from time import perf_counter

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.lib import cell as cellmod
from benchmark.lib import checks, gen, path, program
from benchmark.lib.prof import FRAME_SPAN
from benchmark.lib.reference import Triangles, closest_hits
from benchmark.traffic import frame
# The kind's traffic, readings and release are frame.py's.
from benchmark.traffic.frame import readings, release, traffic  # noqa: F401


def keeps_last_hits() -> bool:
    """Whether the program's frames carry their paths' last hits."""
    result = sys.modules[program.Renderer.__module__].RenderResult
    return any(f.name == "bounce_tri" for f in dataclasses.fields(result))


def build(cell):
    if not keeps_last_hits():
        raise RuntimeError("the program's RenderResult has no bounce_tri: "
                           "the check cannot see the bounce hits")
    frame.build(cell)
    want = cell.config["render"]["bounces"]
    if cell.renderer.cfg.bounces != want:
        raise RuntimeError(f"the renderer traces {cell.renderer.cfg.bounces}"
                           f" bounces, the configuration {want}")


def window(cell, seconds: float, traced: bool) -> dict:
    mode = cell.workload["mode"]
    span = (lambda: record_function(FRAME_SPAN)) if traced else nullcontext
    frame_s, stats = [], []
    attempted = failed = 0
    error = None
    n = len(cell.cameras)
    cell.images = [None] * n
    cell.hits = [None] * n
    cell.last_hits = [None] * n
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
            cell.images[k], cell.hits[k] = res.image, res.hit_tri
            cell.last_hits[k] = res.bounce_tri
            if f1 - t0 >= seconds:
                break
    except Exception:        # the program failed: the run is not correct
        failed += 1
        error = traceback.format_exc()
    return {"window_s": perf_counter() - t0, "attempted": attempted,
            "failed": failed, "error": error, "frame_s": frame_s,
            "stats": stats}


def sample(cell) -> list:
    """frame.py's samples, each with the primary triangles and the paths'
    last triangles of its frame at the sampled pixels."""
    out = frame.sample(cell)
    rcfg = cell.config["render"]
    _, slot_of = gen.pixel_table(rcfg["width"], rcfg["height"])
    rendered = [(h, b) for h, b in zip(cell.hits, cell.last_hits)
                if h is not None]
    for s, (hits, last) in zip(out, rendered):
        s["tri"] = hits[s["pixels"]].copy()
        slots = torch.from_numpy(slot_of[s["pixels"]].astype(np.int64))
        s["bounce_tri"] = last[slots.to(last.device)].cpu().numpy()
    cell.last_hits = None
    return out


def reference(cell, samples: list, dtype) -> list:
    """(colours, primary triangles, the paths' last triangles) of the
    sampled pixels, the hit tests in `dtype`."""
    rcfg = cell.config["render"]
    W, H = rcfg["width"], rcfg["height"]
    dev = cell.device
    scene = cell.scene
    tv = torch.as_tensor(scene.tri_verts(), device=dev)
    tris = Triangles(tv, dtype)
    gn = gen.geometric_normals(tv)
    scale = gen.Scale.of(scene.positions, dev)
    mats = path.Materials(
        torch.as_tensor(np.asarray(scene.mat_ids, np.int64), device=dev),
        torch.tensor([m.diffuse for m in scene.materials],
                     dtype=torch.float32, device=dev),
        torch.tensor([m.emissive for m in scene.materials],
                     dtype=torch.float32, device=dev))
    _, slot_of = gen.pixel_table(W, H)
    key = gen.prng_key(cell.seed32)

    def trace(o, d, tn, tx):
        return closest_hits(tris, o, d, tn, tx)[:2]

    out = []
    for s in samples:
        v = s["view"]
        cam = gen.camera_arrays(v["position"], v["forward"], v["up"],
                                v["fov_deg"], v["znear"], v["zfar"], W, H,
                                dev)
        pix = torch.from_numpy(s["pixels"].astype(np.int32)).to(dev)
        slots = torch.from_numpy(slot_of[s["pixels"]].astype(np.int64)).to(
            dev)
        colour, tri, last = path.radiance(
            key, slots, gen.primary(cam, W, H, pix), trace, gn, mats, scale,
            rcfg["bounces"])
        out.append((colour.cpu(), tri.cpu(), last.cpu()))
    return out


TRI_NUMBERS = (("primary_tri_mismatch", 1), ("bounce_tri_mismatch", 2))


def numbers(samples: list, answers: list, hits_of=None) -> dict:
    run = (hits_of if hits_of is not None
           else [(s["colours"], s["tri"], s["bounce_tri"]) for s in samples])
    out = checks.pixel_numbers([(r[0], a[0]) for r, a in zip(run, answers)])
    if run:
        for name, k in TRI_NUMBERS:
            got = torch.cat([torch.as_tensor(r[k]).to(torch.int32)
                             for r in run])
            ref = torch.cat([a[k].to(torch.int32) for a in answers])
            out[name] = float((got != ref).float().mean())
    return out


def control_hits(answers: list) -> list:
    return answers
