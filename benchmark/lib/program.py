"""The system under test: the port's scene, renderer and pass entries.

This is the one module of the benchmark that imports the program
(`ntrace_tpu_torch`); the generators, the reference, the count and the
readers do not.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ntrace_tpu_torch.host import (NODE_LANES, TRI_LANES, BuildConfig, Camera,
                                   RenderConfig, get_scene)
from ntrace_tpu_torch.host.native.sbvh_lib import native_sbvh_available
from ntrace_tpu_torch.kernels import build as kernel_build
from ntrace_tpu_torch.ray.raybatch import RayBatch
from ntrace_tpu_torch.render.renderer import Renderer

BUILD_KEYS = ("builder", "max_leaf_size", "sah_tri_cost")
RENDER_KEYS = ("width", "height", "samples", "ao_radius", "sort_secondary",
               "compact_rays", "max_batch_rays")


def load_kernels(config: dict) -> float:
    """Load the kernel library, built first where the checkout has none,
    and the native host builder where the configuration builds on the
    host; nvcc's seconds, 0.0 where the library was already built."""
    seconds = kernel_build.build().seconds
    kernel_build.library()
    if config["builder"] != "lbvh":
        native_sbvh_available()
    return seconds


def table_layout(tables) -> dict:
    """The program's traversal tables as lib/count.py reads them: their
    class and fields, the lanes of a node record and of a triangle slot,
    the lanes and type of a row."""
    return {"class": type(tables).__name__,
            "fields": sorted(f.name for f in dataclasses.fields(tables)),
            "node_lanes": NODE_LANES, "tri_lanes": TRI_LANES,
            "row_lanes": [tables.nodes8.shape[1], tables.tris12.shape[1]],
            "dtypes": [str(t.dtype).removeprefix("torch.")
                       for t in (tables.nodes8, tables.tris12)]}


def scene_digest(scene) -> str:
    h = hashlib.sha256(np.ascontiguousarray(scene.positions).tobytes())
    h.update(np.ascontiguousarray(scene.indices).tobytes())
    return h.hexdigest()


def load_scene(config: dict):
    """The configuration's scene, refused when its triangle count or its
    digest differs from the file's (a changed generator is another
    workload)."""
    scene = get_scene(config["scene"], n_tris=config["n_tris"],
                      seed=config["scene_seed"])
    if scene.num_tris != config["tris"]:
        raise RuntimeError(f"scene {config['scene']}: {scene.num_tris} "
                           f"triangles, the configuration has "
                           f"{config['tris']}")
    want = config.get("scene_sha256")
    if want is not None and scene_digest(scene) != want:
        raise RuntimeError(f"scene {config['scene']}: its vertices differ "
                           "from the configuration's digest")
    return scene


def renderer(config: dict, scene, mode: str, seed32: int, device):
    """A Renderer built as the configuration states (the BVH in its
    constructor: the host build or the device LBVH)."""
    bc = BuildConfig(**{k: config[k] for k in BUILD_KEYS if k in config})
    rc = RenderConfig(mode=mode, engine=config["engine"], seed=seed32,
                      **{k: config["render"][k] for k in RENDER_KEYS
                         if k in config["render"]})
    return Renderer(scene, bc, rc, device=device)


def reseed(r, seed32: int):
    """The renderer's secondary rays drawn from another seed."""
    r.cfg = dataclasses.replace(r.cfg, seed=seed32)


def camera(view: dict) -> Camera:
    return Camera(position=view["position"], forward=view["forward"],
                  up=view["up"], fov_deg=view["fov_deg"],
                  znear=view["znear"], zfar=view["zfar"])


def pass_entry(r, name: str, rays):
    """A zero-argument call of the pass `name` on `rays` (lib/gen.Rays), as
    render() makes it: trace_primary for primary rays, _trace_secondary
    (the live-prefix compaction, then the engine) for AO (any hit) and
    diffuse (closest hit) rays. Returns (tri, t, u, v)."""
    if name == "primary":
        return lambda: r.trace_primary(rays.orig, rays.dirn, rays.tmin,
                                       rays.tmax, canonical=True)
    batch = RayBatch(rays.orig, rays.dirn, rays.tmin, rays.tmax,
                     rays.slot_to_id)
    any_hit = name == "ao"
    return lambda: r._trace_secondary(batch, any_hit)
