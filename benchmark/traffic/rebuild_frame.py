"""Animated frames: the vertices move, the tree is rebuilt on the device,
then `Renderer.render(camera, mode)`, in a closed loop.

Set-up builds the renderer as `frame.py` does, makes the configuration's
poses on the host (lib/motion.py), uploads each once and allocates one
vertex buffer;
the walk's cameras come in the order the seed draws, camera slot k paired
with pose k. Frame i, k = i mod the slots, is timed by the host clock from
the copy to the image on the host: the pose copied into the vertex buffer
on the device (the animation writing it), `Renderer.update_positions(buf)`,
then `render(cameras[k], mode)`. Its stats are render()'s merged with
update_positions' (shared counters summed). Warm-up runs every slot once.
The reference is `frame.py`'s over the pose of each sampled slot: brute
force over that pose's triangles, its box and normals, nothing the program
made. Workload keys: those of `frame.py`.
"""

from __future__ import annotations

import os
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from time import perf_counter
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.lib import cell as cellmod
from benchmark.lib import program, walk
from benchmark.lib.motion import Wind
from benchmark.lib.prof import FRAME_SPAN
from benchmark.traffic import frame
# The kind's readings, numbers and control are frame.py's.
from benchmark.traffic.frame import (control_hits, numbers,  # noqa: F401
                                     readings)


def build(cell):
    if not hasattr(program.Renderer, "update_positions"):
        raise RuntimeError("the program's Renderer has no update_positions: "
                           "it cannot move the vertices of a frame")
    frame.build(cell)
    s = cell.scene
    cell.wind = Wind(cell.config["motion"], s.positions, s.indices,
                     s.mat_ids)
    # Each slot's pose on the host (the reference reads them), made on
    # the host's cores at once, and uploaded once.
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        cell.host_poses = list(pool.map(cell.wind.pose,
                                        range(cell.workload["cameras"])))
    cell.poses = [torch.from_numpy(p).to(cell.device)
                  for p in cell.host_poses]
    cell.buf = torch.empty_like(cell.poses[0])
    cell.mark("traffic")


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
    for k, cam in enumerate(cell.cameras):
        _frame(cell, k, cam)
    cell.mark("warmup")


def _frame(cell, k: int, cam):
    """Frame of slot k: (render()'s result, merged stats)."""
    cell.buf.copy_(cell.poses[k])
    st = cell.renderer.update_positions(cell.buf)
    res = cell.renderer.render(cam, cell.workload["mode"])
    stats = dict(res.stats)
    for key, v in st.items():
        stats[key] = stats.get(key, 0) + v
    return res, stats


def window(cell, seconds: float, traced: bool) -> dict:
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
                res, st = _frame(cell, k, cell.cameras[k])
            f1 = perf_counter()
            frame_s.append(f1 - f0)
            stats.append(st)
            cell.images[k] = res.image
            if f1 - t0 >= seconds:
                break
    except Exception:        # the program failed: the run is not correct
        failed += 1
        error = traceback.format_exc()
    return {"window_s": perf_counter() - t0, "attempted": attempted,
            "failed": failed, "error": error, "frame_s": frame_s,
            "stats": stats}


def sample(cell) -> list:
    """For each slot the window rendered, `check_pixels` pixel ids drawn
    from the seed, the colours its last image in the window holds there,
    and the slot's pose."""
    rcfg = cell.config["render"]
    n_pix = rcfg["width"] * rcfg["height"]
    rng = cell.rng(cellmod.CHECK)
    out = []
    for k, (view, img) in enumerate(zip(cell.views, cell.images)):
        pix = np.sort(rng.choice(n_pix, min(cell.workload["check_pixels"],
                                            n_pix), replace=False))
        if img is None:
            continue
        out.append({"view": view, "pixels": pix, "pose": k,
                    "colours": img.reshape(-1, 3)[pix].copy()})
    return out


def release(cell):
    frame.release(cell)
    cell.poses = cell.buf = None


class _Pose:
    """The scene at one pose, as frame.py's reference reads a scene."""

    def __init__(self, positions: np.ndarray, indices: np.ndarray):
        self.positions = positions
        self._indices = indices

    def tri_verts(self) -> np.ndarray:
        return self.positions[self._indices]


def reference(cell, samples: list, dtype) -> list:
    """frame.py's reference of each sample, over its pose's triangles."""
    out = []
    for s in samples:
        posed = SimpleNamespace(
            config=cell.config, workload=cell.workload, device=cell.device,
            seed32=cell.seed32,
            scene=_Pose(cell.host_poses[s["pose"]], cell.scene.indices))
        out += frame.reference(posed, [s], dtype)
    return out
