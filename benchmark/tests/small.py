"""Every cell at a size the CPU holds: a 5,000-triangle soup at 64 x 48,
two views or cameras, through the same harness as a chip run (the
program's CUDA kernels are replaced by their torch twins on the CPU)."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import spec  # noqa: E402
from ntrace_tpu_torch.host import get_scene  # noqa: E402

SOUP_CAMERA = {"position": [0.0, 0.0, 25.0], "forward": [0.0, 0.0, -1.0],
               "up": [0.0, 1.0, 0.0], "fov_deg": 60.0, "znear": 1e-3,
               "zfar": 1e8}


def cells() -> list[str]:
    return [w["name"] for w in spec.benchmark()["workloads"]]


def small(cell: str, room: bool = False) -> tuple[dict, dict]:
    """(config, workload) of `cell` cut to the rehearsal's size: the soup,
    or with `room` the conference stand-in at 5,000 triangles seen from
    its own camera (every pixel hits, a good share of AO rays is blocked),
    built and traced as the cell's configuration says."""
    wl = dict(spec.workload(cell))
    cfg = dict(spec.config(wl["config"]))
    if room:
        conf = spec.config("conference")
        tris = get_scene("conference", n_tris=5000,
                         seed=conf["scene_seed"]).num_tris
        cfg.update(scene="conference", n_tris=5000, tris=tris,
                   scene_seed=conf["scene_seed"], scene_sha256=None,
                   camera=conf["camera"])
    else:
        cfg.update(scene="soup", n_tris=5000, scene_seed=0, tris=5000,
                   scene_sha256=None, camera=SOUP_CAMERA)
    cfg["render"] = dict(cfg["render"], width=64, height=48)
    if wl["kind"] == "rays":
        wl.update(views=2, count_rays=256)
    else:
        wl.update(cameras=2)
    return cfg, wl
